"""The port's counterparts of ``tests/test_cluster.py``: multi-node
``ray_tpu_torch.cluster_utils`` — one GCS process and one raylet process
per node on this machine — in its order and with its assertions, and a
lineage-reconstruction case.

The module's shared cluster and each test that starts a cluster of its own
run under a session root of their own (``ray_tpu_torch.session_root``),
passed to the cluster's processes as ``RAY_TPU_TEMP_DIR``.  Each cluster
ends with the port's leak audit: no GCS, raylet or worker of that root and
no ``rtt_store_`` segment of it left after ``shutdown()``
(``assert_port_left_nothing``).  The reference's ``test_push_shuffle_
bigger_than_store`` is marked slow there; its counterpart runs here.  The
live-cluster chaos suites (``test_chaos``, ``test_gcs_ft``,
``test_failure_detection``) have no counterpart.
"""

import contextlib
import os
import time

import numpy as np
import pytest
from test_torch_runtime_parity import port_session_root

import ray_tpu_torch as rt
from ray_tpu_torch.cluster_utils import Cluster


@contextlib.contextmanager
def port_cluster(**kwargs):
    """A ``Cluster`` under a session root of its own, shut down and held to
    the leak audit on exit."""
    with port_session_root() as root:
        c = None
        try:
            c = Cluster(env={"RAY_TPU_TEMP_DIR": root}, **kwargs)
            yield c
        finally:
            if c is not None:
                c.shutdown()


@pytest.fixture(scope="module")
def cluster():
    """Head (1 CPU) + worker node (2 CPU, tagged resource 'special')."""
    with port_cluster(initialize_head=True,
                      head_resources={"num_cpus": 1}) as c:
        c.add_node(num_cpus=2, resources={"special": 1})
        c.wait_for_nodes(2)
        c.connect()
        yield c


@rt.remote
def _session_dir():
    import os

    return os.environ.get("RAY_TPU_SESSION_DIR")


def test_nodes_registered(cluster):
    nodes = rt.nodes()
    assert len([n for n in nodes if n["Alive"]]) == 2
    total = rt.cluster_resources()
    assert total["CPU"] == 3.0
    assert total["special"] == 1.0


def test_spillback_lands_on_other_node(cluster):
    """A task whose custom resource only exists on node B runs there even
    though it was submitted to the head raylet (reference: spillback in
    `cluster_task_manager.cc:418`)."""
    here = rt.get(_session_dir.remote(), timeout=30)
    there = rt.get(
        _session_dir.options(resources={"special": 1}).remote(), timeout=30)
    assert here != there


def test_spillback_on_cpu_pressure(cluster):
    """More parallel CPU-1 tasks than the head has cores: some must spill
    to the second node."""

    @rt.remote
    def where(i):
        import os
        import time as _t

        _t.sleep(0.4)
        return os.environ.get("RAY_TPU_SESSION_DIR")

    sessions = rt.get([where.remote(i) for i in range(3)], timeout=60)
    assert len(set(sessions)) == 2, sessions


def test_cross_node_object_transfer(cluster):
    """A large (multi-chunk) result produced on node B is pulled through
    the head raylet's store transparently on get()."""
    mb = 24

    @rt.remote(resources={"special": 0.1})
    def big():
        return np.ones((mb, 1 << 20), np.uint8)

    arr = rt.get(big.remote(), timeout=60)
    assert arr.shape == (mb, 1 << 20)
    assert int(arr[0].sum()) == 1 << 20


def test_cross_node_dependency(cluster):
    """Producer on node B, consumer pinned to head: the argument object
    crosses nodes through the dependency pull path."""

    @rt.remote(resources={"special": 0.1})
    def produce():
        return np.arange(500_000, dtype=np.int64)  # 4MB: store path

    @rt.remote
    def consume(x):
        return int(x.sum())

    assert rt.get(consume.remote(produce.remote()),
                       timeout=60) == 124999750000


def test_locality_aware_placement_moves_task_to_data(cluster):
    """A task whose (multi-MB) argument lives on node B runs ON node B even
    with no resource constraint — the scheduler moves the task to the data
    instead of pulling the data (reference: locality_aware leasing)."""

    @rt.remote(resources={"special": 0.1})
    def produce():
        return np.ones(4 << 20, np.uint8)  # 4MB store object on node B

    @rt.remote
    def consume(x):
        import os

        return int(x[0]), os.environ.get("RAY_TPU_SESSION_DIR")

    ref = produce.remote()
    producer_session = rt.get(
        _session_dir.options(resources={"special": 0.1}).remote(),
        timeout=30)
    val, consumer_session = rt.get(consume.remote(ref), timeout=60)
    assert val == 1
    assert consumer_session == producer_session


def test_named_actor_cross_node(cluster):
    @rt.remote(resources={"special": 0.2})
    class Holder:
        def __init__(self):
            self.items = []

        def add(self, x):
            self.items.append(x)
            return len(self.items)

        def node(self):
            import os

            return os.environ.get("RAY_TPU_SESSION_DIR")

    h = Holder.options(name="holder").remote()
    assert rt.get(h.add.remote(1), timeout=30) == 1
    # the actor landed on node B (resource constraint)
    head = rt.get(_session_dir.remote(), timeout=30)
    assert rt.get(h.node.remote(), timeout=30) != head
    # a fresh handle by name reaches the same instance
    h2 = rt.get_actor("holder")
    assert rt.get(h2.add.remote(2), timeout=30) == 2


def test_cross_node_put_and_get_from_task(cluster):
    """put() on the driver, consumed by a task on the other node."""
    data = np.full((2, 1 << 20), 7, np.uint8)  # 2MB
    ref = rt.put(data)

    @rt.remote(resources={"special": 0.1})
    def readback(x):
        return int(x[0, 0]), x.shape

    v, shape = rt.get(readback.remote(ref), timeout=60)
    assert v == 7 and tuple(shape) == (2, 1 << 20)


def test_cross_node_streaming(cluster):
    """A streaming generator task forwarded to another node relays its
    items back to the consumer-side raylet (xstream_item path)."""

    @rt.remote(resources={"special": 0.1})
    def gen(n):
        import numpy as np

        for i in range(n):
            yield i * 3
        yield np.full(300_000, 7, np.int64)  # store-path item relays too

    refs = list(gen.options(num_returns="streaming").remote(3))
    assert len(refs) == 4
    vals = [rt.get(r, timeout=60) for r in refs[:3]]
    assert vals == [0, 3, 6]
    assert int(rt.get(refs[3], timeout=60)[0]) == 7


def test_cluster_placement_group_spreads_bundles(cluster):
    """A PG too big for any single node spreads bundles across nodes
    (reference: GcsPlacementGroupScheduler bundle policies); tasks pinned
    to a bundle run on the node holding that bundle's fragment."""
    from ray_tpu_torch.util.scheduling_strategies import (
        PlacementGroupSchedulingStrategy,
    )

    # head has 1 CPU, worker node has 2: [1 CPU, 2 CPU] cannot STRICT_PACK
    pg = rt.placement_group([{"CPU": 1}, {"CPU": 2}],
                                 strategy="SPREAD")
    assert pg.wait(30), "cluster PG never became ready"

    @rt.remote(num_cpus=1)
    def where():
        import os

        return os.environ.get("RAY_TPU_SESSION_DIR")

    s0 = rt.get(where.options(
        scheduling_strategy=PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=0)).remote(),
        timeout=60)
    s1 = rt.get(where.options(
        scheduling_strategy=PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=1)).remote(),
        timeout=60)
    assert s0 != s1, "bundles must land on different nodes"
    rt.remove_placement_group(pg)


def test_cluster_pg_infeasible_rejected(cluster):
    with pytest.raises(ValueError):
        rt.placement_group([{"CPU": 64}], strategy="STRICT_PACK")


def test_cluster_pg_remove_fails_queued(cluster):
    from ray_tpu_torch.util.scheduling_strategies import (
        PlacementGroupSchedulingStrategy,
    )

    pg = rt.placement_group([{"CPU": 1}])
    assert pg.wait(30)
    rt.remove_placement_group(pg)

    @rt.remote(num_cpus=1)
    def f():
        return 1

    ref = f.options(
        scheduling_strategy=PlacementGroupSchedulingStrategy(
            placement_group=pg)).remote()
    with pytest.raises(Exception):
        rt.get(ref, timeout=20)



def test_worker_logs_forwarded_to_driver(cluster, capfd):
    """Worker prints in cluster mode are tailed from per-worker log files
    and pushed to the driver with a (pid, node) prefix (reference:
    `python/ray/_private/log_monitor.py:102`)."""

    @rt.remote
    def shout():
        print("LOG_CAPTURE_MARKER_77", flush=True)
        return 1

    assert rt.get(shout.remote(), timeout=30) == 1
    deadline = time.monotonic() + 10
    seen = ""
    while time.monotonic() < deadline:
        seen += capfd.readouterr().out
        if "LOG_CAPTURE_MARKER_77" in seen:
            break
        time.sleep(0.2)
    assert "LOG_CAPTURE_MARKER_77" in seen
    assert "node=" in seen


class TestNodeFailure:
    """Node death: detection, task retry, actor failover (fresh cluster per
    test — killing nodes poisons the shared fixture)."""

    def test_actor_failover_and_task_retry(self):
        # Detach from the module-scoped cluster's driver (this test owns its
        # whole cluster; runs last in the file).
        if rt.is_initialized():
            rt.shutdown()
        with port_cluster(initialize_head=True,
                          head_resources={"num_cpus": 1}) as c:
            doomed = c.add_node(num_cpus=2, resources={"tag": 1})
            c.wait_for_nodes(2)
            c.connect()
            @rt.remote(max_restarts=1, resources={"tag": 0.1})
            class Ctr:
                def __init__(self):
                    self.v = 0

                def inc(self):
                    self.v += 1
                    return self.v

            h = Ctr.options(name="ctr").remote()
            assert rt.get(h.inc.remote(), timeout=30) == 1

            # capacity for the failover BEFORE the kill
            c.add_node(num_cpus=2, resources={"tag": 1})
            c.wait_for_nodes(3)
            c.remove_node(doomed)  # SIGKILL — heartbeat timeout kicks in

            deadline = time.time() + 30
            value = None
            while time.time() < deadline:
                try:
                    value = rt.get(h.inc.remote(), timeout=10)
                    break
                except rt.ActorDiedError:
                    time.sleep(0.5)  # restarting window
            # fresh instance => counter restarted from 0
            assert value == 1
            # dead node disappears from membership
            alive = [n for n in rt.nodes() if n["Alive"]]
            assert len(alive) == 2


def test_push_shuffle_bigger_than_store():
    """Distributed scatter/merge shuffle of a dataset LARGER than the
    object store: blocks spill to disk and the shuffle still completes
    with every row intact (reference: `_internal/push_based_shuffle.py`
    under memory pressure) — run on a fake 2-node cluster."""
    import numpy as np

    from ray_tpu_torch import data as rd

    if rt.is_initialized():
        rt.shutdown()
    with port_cluster(initialize_head=True,
                      head_resources={"num_cpus": 2,
                                      "object_store_mb": 32}) as c:
        c.add_node(num_cpus=2, object_store_mb=32)
        c.wait_for_nodes(2)
        c.connect()
        n = 4 << 20  # 8 blocks x (2 cols x 8B x 512Ki rows) = 64MB >> 32MB
        ds = rd.range(n, parallelism=8).map_batches(
            lambda b: {"id": b["id"], "pad": b["id"].astype(np.int64)})
        out = ds.random_shuffle(seed=3)
        assert out.count() == n
        assert out.sum("id") == n * (n - 1) // 2


def test_lineage_reconstruction_after_node_death(tmp_path):
    """The sole holder of a task's 2 MB result is SIGKILLed; once the GCS
    has marked its node dead, ``get`` re-runs the creating task on a
    replacement node (lineage reconstruction) and returns the value.  Each
    run of the task appends its node id to a file: two runs, the first on
    the killed node."""
    if rt.is_initialized():
        rt.shutdown()
    runs = tmp_path / "runs"
    with port_cluster(initialize_head=True,
                      head_resources={"num_cpus": 1}) as c:
        victim = c.add_node(num_cpus=2, resources={"data": 1})
        c.wait_for_nodes(2)
        c.connect()

        @rt.remote(resources={"data": 0.1})
        def make(path):
            import os

            with open(path, "a") as f:
                f.write(os.environ["RAY_TPU_NODE_ID"] + "\n")
            return np.arange(1 << 19, dtype=np.int32)

        @rt.remote(resources={"data": 0.1})
        def probe(x):
            return int(x[123])

        ref = make.remote(str(runs))
        # the object sealed on the data node, not pulled to the head
        assert rt.get(probe.remote(ref), timeout=60) == 123
        c.remove_node(victim)  # SIGKILL the only holder
        deadline = time.monotonic() + 30
        while any(n["NodeID"] == victim.node_id and n["Alive"]
                  for n in rt.nodes()):
            assert time.monotonic() < deadline, "node never marked dead"
            time.sleep(0.1)
        c.add_node(num_cpus=2, resources={"data": 1})  # replacement
        c.wait_for_nodes(2)

        val = rt.get(ref, timeout=120)  # reconstructed, not lost
        assert val.dtype == np.int32
        np.testing.assert_array_equal(val, np.arange(1 << 19,
                                                     dtype=np.int32))
        ran_on = runs.read_text().split()
        assert len(ran_on) == 2, ran_on
        assert ran_on[0] == victim.node_id and ran_on[1] != victim.node_id
