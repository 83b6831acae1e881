"""The port's counterparts of ``tests/test_util_queue_pool.py``'s 7 cases:
``util.Queue`` (an actor-backed FIFO), ``util.ActorPool`` and
``util.multiprocessing.Pool``, on one port runtime for the module (8 CPUs,
under a session root of its own), ending with the port's leak audit.

``util/queue.py`` and ``util/actor_pool.py`` are copies of the reference's
(hunk (a) alone), ``util/multiprocessing.py`` with hunk (b): the pool's
functions ship with the vendored cloudpickle
(``tests/test_torch_runtime_copy.py``).
"""

import os
import shutil

import pytest
from test_torch_runtime_parity import assert_port_left_nothing

import ray_tpu_torch
from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.queue import Empty, Full, Queue


@pytest.fixture(scope="module")
def ray():
    """One port runtime for the module, under a session root of its own."""
    from ray_tpu_torch.session_root import new_session_root

    config = ray_tpu_torch.config
    default, config.temp_dir = config.temp_dir, new_session_root()
    try:
        ray_tpu_torch.init(num_cpus=8)
        yield ray_tpu_torch
        ray_tpu_torch.shutdown()
        assert_port_left_nothing([os.getpid()])
    finally:
        shutil.rmtree(config.temp_dir, ignore_errors=True)
        config.temp_dir = default


def test_queue_fifo_cross_process(ray):
    q = Queue()
    try:
        q.put(1)
        q.put(2)

        @ray_tpu_torch.remote
        def producer(q):
            q.put(3)
            return True

        assert ray_tpu_torch.get(producer.remote(q), timeout=30)
        assert [q.get(timeout=10) for _ in range(3)] == [1, 2, 3]
        assert q.empty()
        with pytest.raises(Empty):
            q.get_nowait()
    finally:
        q.shutdown()


def test_queue_maxsize_and_batches(ray):
    q = Queue(maxsize=2)
    try:
        q.put(1)
        q.put(2)
        assert q.full()
        with pytest.raises(Full):
            q.put_nowait(3)
        with pytest.raises(Full):
            q.put(3, timeout=0.2)
        assert q.get_nowait_batch(2) == [1, 2]
        q.put_nowait_batch([4, 5])
        assert q.qsize() == 2
    finally:
        q.shutdown()


def test_actor_pool_ordered_and_unordered(ray):
    @ray_tpu_torch.remote
    class Doubler:
        def double(self, x):
            return 2 * x

    actors = [Doubler.remote() for _ in range(2)]
    pool = ActorPool(actors)
    assert list(pool.map(lambda a, v: a.double.remote(v), range(6))) == \
        [0, 2, 4, 6, 8, 10]
    got = sorted(pool.map_unordered(lambda a, v: a.double.remote(v),
                                    range(6)))
    assert got == [0, 2, 4, 6, 8, 10]
    for a in actors:
        ray_tpu_torch.kill(a)


def test_actor_pool_submit_get_next(ray):
    @ray_tpu_torch.remote
    class Id:
        def f(self, x):
            return x

    pool = ActorPool([Id.remote()])
    pool.submit(lambda a, v: a.f.remote(v), "a")
    assert not pool.has_free()
    assert pool.get_next(timeout=30) == "a"
    assert pool.has_free()


class TestMultiprocessingPool:
    """Drop-in multiprocessing.Pool over actors (reference:
    `python/ray/util/multiprocessing/pool.py`)."""

    def test_map_and_apply(self, ray):
        from ray_tpu_torch.util.multiprocessing import Pool

        with Pool(processes=2) as pool:
            assert pool.map(lambda x: x * x, range(8)) == \
                [0, 1, 4, 9, 16, 25, 36, 49]
            assert pool.apply(lambda a, b: a + b, (3, 4)) == 7
            assert pool.starmap(lambda a, b: a * b,
                                [(1, 2), (3, 4)]) == [2, 12]

    def test_async_and_imap(self, ray):
        from ray_tpu_torch.util.multiprocessing import Pool

        with Pool(processes=2) as pool:
            r = pool.apply_async(lambda x: x + 1, (41,))
            assert r.get(timeout=30) == 42
            assert r.successful()
            m = pool.map_async(lambda x: -x, range(4))
            assert m.get(timeout=30) == [0, -1, -2, -3]
            assert list(pool.imap(lambda x: x * 10, range(4),
                                  chunksize=2)) == [0, 10, 20, 30]
            assert sorted(pool.imap_unordered(
                lambda x: x * 10, range(4), chunksize=1)) == [0, 10, 20, 30]

    def test_closed_pool_rejects(self, ray):
        from ray_tpu_torch.util.multiprocessing import Pool

        pool = Pool(processes=1)
        pool.close()
        with pytest.raises(ValueError):
            pool.apply(lambda: 1)
        pool.join()
        pool.terminate()
