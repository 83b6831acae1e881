"""The port's counterparts of ``tests/test_core_basic.py``, in its order and
held to its assertions, on one port cluster for the module.

They include ``test_wait`` and ``test_parallelism``, which the JAX package's
direct-transport burst mode (``ray_tpu/core/direct.py:1150-1167``) can fail
depending on the tests that ran before them: once a lease channel turns
tasks over fast, every task of one shape is pipelined onto one leased
worker.  The port's copy gates that pipelining (hunk (i) of
``tests/test_torch_runtime_copy.py``; ``tests/test_torch_runtime_burst.py``).
Nothing here turns burst mode off.

The cluster runs under a session root of its own
(``ray_tpu_torch.session_root``), not the shared default.  The module ends
with the leak audit of the port (no ``ray_tpu_torch.core.*_main`` process
and no ``rtt_store_`` segment left) and a test that the JAX package's audit counts none of the port's processes
and segments while the cluster is up.
"""

import os
import shutil
import time

import numpy as np
import pytest
from test_torch_runtime_parity import assert_port_left_nothing


@pytest.fixture(scope="module")
def port_shared():
    """One port cluster for the module, under a session root of its own."""
    import ray_tpu_torch
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


def test_put_get(port_shared):
    ray = port_shared
    ref = ray.put({"a": 1, "b": [1, 2, 3]})
    assert ray.get(ref) == {"a": 1, "b": [1, 2, 3]}


def test_put_get_large_array(port_shared):
    ray = port_shared
    arr = np.random.rand(1 << 20).astype(np.float32)  # 4MB -> shm store
    ref = ray.put(arr)
    out = ray.get(ref)
    np.testing.assert_array_equal(out, arr)


def test_simple_task(port_shared):
    ray = port_shared

    @ray.remote
    def add(a, b):
        return a + b

    assert ray.get(add.remote(1, 2)) == 3


def test_task_with_ref_arg(port_shared):
    ray = port_shared

    @ray.remote
    def double(x):
        return 2 * x

    r1 = double.remote(10)
    r2 = double.remote(r1)
    assert ray.get(r2) == 40


def test_task_large_result(port_shared):
    ray = port_shared

    @ray.remote
    def big():
        return np.ones((1024, 1024), dtype=np.float32)

    out = ray.get(big.remote())
    assert out.shape == (1024, 1024)
    assert out.sum() == 1024 * 1024


def test_task_kwargs_and_closure(port_shared):
    ray = port_shared
    factor = 7

    @ray.remote
    def f(x, y=1):
        return factor * x + y

    assert ray.get(f.remote(2, y=3)) == 17


def test_num_returns(port_shared):
    ray = port_shared

    @ray.remote(num_returns=3)
    def three():
        return 1, 2, 3

    a, b, c = three.remote()
    assert ray.get([a, b, c]) == [1, 2, 3]


def test_task_error_propagates(port_shared):
    ray = port_shared

    @ray.remote
    def boom():
        raise ValueError("bad")

    with pytest.raises(ray.TaskError) as ei:
        ray.get(boom.remote())
    assert "bad" in str(ei.value)


def test_error_propagates_through_dependency(port_shared):
    ray = port_shared

    @ray.remote
    def boom():
        raise ValueError("root cause")

    @ray.remote
    def consume(x):
        return x

    with pytest.raises(ray.TaskError):
        ray.get(consume.remote(boom.remote()))


def test_wait(port_shared):
    ray = port_shared

    @ray.remote
    def sleepy(t):
        time.sleep(t)
        return t

    refs = [sleepy.remote(0.01), sleepy.remote(5.0)]
    ready, not_ready = ray.wait(refs, num_returns=1, timeout=3.0)
    assert len(ready) == 1 and len(not_ready) == 1
    assert ray.get(ready[0]) == 0.01


def test_parallelism(port_shared):
    ray = port_shared

    @ray.remote
    def sleep_pid():
        time.sleep(0.4)
        import os

        return os.getpid()

    start = time.monotonic()
    pids = ray.get([sleep_pid.remote() for _ in range(4)])
    elapsed = time.monotonic() - start
    assert len(set(pids)) >= 2, "tasks should run in separate processes"
    assert elapsed < 1.5, f"4x0.4s tasks should run in parallel, took {elapsed}"


def test_nested_tasks(port_shared):
    ray = port_shared

    @ray.remote
    def inner(x):
        return x * 10

    @ray.remote
    def outer(x):
        import ray_tpu_torch

        return ray_tpu_torch.get(inner.remote(x)) + 1

    assert ray.get(outer.remote(4)) == 41


def test_get_timeout(port_shared):
    ray = port_shared

    @ray.remote
    def forever():
        time.sleep(60)

    with pytest.raises(ray.GetTimeoutError):
        ray.get(forever.remote(), timeout=0.2)


def test_cluster_resources(port_shared):
    ray = port_shared
    assert ray.cluster_resources()["CPU"] == 8.0


def test_runtime_context(port_shared):
    """port_shared.get_runtime_context() inside tasks/actors (reference:
    `python/ray/runtime_context.py`)."""

    @port_shared.remote
    def whereami():
        ctx = port_shared.get_runtime_context()
        return {"task_id": ctx.get_task_id(),
                "node_id": ctx.get_node_id(),
                "worker_id": ctx.get_worker_id(),
                "actor_id": ctx.get_actor_id()}

    info = port_shared.get(whereami.remote(), timeout=30)
    assert info["task_id"] is not None and len(info["task_id"]) > 8
    assert info["node_id"] is not None
    assert info["worker_id"]
    assert info["actor_id"] is None  # plain task, no actor

    @port_shared.remote
    class Who:
        def me(self):
            ctx = port_shared.get_runtime_context()
            return ctx.get_actor_id(), ctx.get_task_id()

    a = Who.remote()
    actor_id, task_id = port_shared.get(a.me.remote(), timeout=30)
    assert actor_id is not None and task_id is not None
    # driver context: no task, but a node
    drv = port_shared.get_runtime_context()
    assert drv.get_task_id() is None
    assert drv.get_node_id() is not None


def test_batched_dispatch_preserves_fanout_parallelism(port_shared):
    """Dispatch batching must not serialize a small fan-out onto one
    worker while others sit idle (fair-share cap on the batch size)."""
    import time as _time

    @port_shared.remote
    def sleeper():
        import time

        time.sleep(0.8)
        return 1

    # warm the pool so all 4 workers exist
    port_shared.get([sleeper.remote() for _ in range(4)], timeout=30)
    t0 = _time.perf_counter()
    assert sum(port_shared.get([sleeper.remote() for _ in range(4)],
                              timeout=30)) == 4
    took = _time.perf_counter() - t0
    # parallel: ~0.8s (+overhead); serialized-on-one-worker would be 3.2s+
    # (threshold leaves headroom for contended-host scheduling noise)
    assert took < 2.4, f"fan-out took {took:.2f}s — batching serialized it?"


def test_blocked_batch_member_requeues_followers(port_shared):
    """A batched task that blocks in a nested get hands its unstarted
    followers back to the raylet so they complete while it waits."""
    import time as _time

    @port_shared.remote(max_concurrency=2)
    class Gate:
        def __init__(self):
            self.open = False

        def release(self):
            self.open = True

        def wait_open(self):
            import time

            while not self.open:
                time.sleep(0.02)
            return "opened"

    gate = Gate.remote()
    gate_ref = gate.wait_open.remote()

    @port_shared.remote
    def blocker(wrapped):
        # nested get on a ref smuggled inside a list (NOT a declared
        # dependency) — blocks mid-execution, after dispatch
        return port_shared.get(wrapped[0], timeout=60)

    @port_shared.remote
    def fast(i):
        return i

    b = blocker.remote([gate_ref])
    fasts = [fast.remote(i) for i in range(12)]
    # the fast tasks must all finish while the blocker still holds a
    # worker (requeue frees any batched behind it)
    assert port_shared.get(fasts, timeout=30) == list(range(12))
    port_shared.get(gate.release.remote(), timeout=30)
    assert port_shared.get(b, timeout=60) == "opened"


def test_audits_count_only_their_own(port_shared):
    """While the port's cluster is up, its workers and its store segment
    are in the port's audit and not in the JAX package's, and the two
    sweeps of dead stores match only their own prefix."""
    from ray_tpu.util import chaos as ref_chaos

    from ray_tpu_torch.core import worker as port_worker
    from ray_tpu_torch.util import chaos

    @port_shared.remote
    def pid():
        return os.getpid()

    pids = set(port_shared.get([pid.remote() for _ in range(4)]))
    mine = chaos._runtime_pids()
    assert pids <= set(mine)
    assert set(mine.values()) <= {"ray_tpu_torch.core.worker_main",
                                  "ray_tpu_torch.core.raylet_main",
                                  "ray_tpu_torch.core.gcs_main"}
    assert not set(ref_chaos._runtime_pids()) & set(mine)
    store = os.path.basename(port_shared.core.worker.global_worker()
                             .store_path)
    assert store.startswith("rtt_store_")
    assert store in chaos._shm_segments()
    assert store not in ref_chaos._shm_segments()
    assert all(s.startswith("rt_store") for s in ref_chaos._shm_segments())
    assert all(s.startswith("rtt_store") for s in chaos._shm_segments())
    assert port_worker is port_shared.core.worker
