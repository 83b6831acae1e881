"""The port's counterparts of ``tests/test_autoscaler.py``'s 9 cases (the
demand scheduler, scale-up and idle scale-down on a local provider, the
``up``/``down`` CLI, the GCE provider against a fake cloud API with no
network, and STRICT_PACK on a slice); the reference's two slow marks are
kept.

``ray_tpu_torch/autoscaler/`` is a copy of the reference's (hunk (a)
alone).  Node types keep the reference's ``"TPU"`` count: a node type with
cards is ``{"CPU": n, "TPU": k}``, one card a unit, as the port's runtime
counts its chip resource (f).  ``gce.py`` still creates Cloud TPU VMs
(``kind: tpu``) and plain instances; a GPU instance would be ``kind: gce``
with an accelerator, which the port does not add.  Every cluster runs
under a session root of its own and is held to the port's leak audit;
``up`` keeps its records under ``<temp dir>/ray_tpu_torch/clusters``,
here a temp dir of the case's own (``TMPDIR``).
"""

import os
import time

import pytest
from test_autoscaler import FakeGceApi
from test_torch_runtime_parity import port_session_root

from ray_tpu_torch.autoscaler import AutoscalingCluster, ResourceDemandScheduler


# ---------------------------------------------------------------- unit level


def test_demand_scheduler_bin_packing():
    sched = ResourceDemandScheduler(
        {"cpu4": {"resources": {"CPU": 4.0}},
         "tpu_host": {"resources": {"CPU": 8.0, "TPU": 8.0}}},
        max_workers=10)
    # 6 one-CPU tasks, 1 free CPU on existing nodes -> 5 unfulfilled -> need
    # two cpu4 nodes (4 + 1), not a TPU host.
    out = sched.get_nodes_to_launch(
        [{"CPU": 1.0}] * 6, [{"CPU": 1.0}], {"cpu4": 1})
    assert out == {"cpu4": 2}


def test_demand_scheduler_picks_fitting_type_and_caps():
    sched = ResourceDemandScheduler(
        {"cpu4": {"resources": {"CPU": 4.0}, "max_workers": 1},
         "tpu_host": {"resources": {"CPU": 8.0, "TPU": 8.0}}},
        max_workers=10)
    # TPU demand must land on the TPU template even though cpu4 is smaller.
    out = sched.get_nodes_to_launch([{"TPU": 4.0}], [], {})
    assert out == {"tpu_host": 1}
    # Per-type max_workers is respected.
    out = sched.get_nodes_to_launch([{"CPU": 4.0}] * 3, [], {})
    assert out.get("cpu4", 0) <= 1


def test_demand_scheduler_infeasible_shape_ignored():
    sched = ResourceDemandScheduler(
        {"cpu4": {"resources": {"CPU": 4.0}}}, max_workers=10)
    assert sched.get_nodes_to_launch([{"GPU": 1.0}], [], {}) == {}


# ------------------------------------------------------------ cluster level


@pytest.mark.slow
def test_autoscaling_cluster_up_and_down():
    import ray_tpu_torch

    with port_session_root() as root:
        cluster = AutoscalingCluster(
            head_resources={"CPU": 1.0},
            worker_node_types={
                "cpu2": {"resources": {"CPU": 2.0}, "min_workers": 0,
                         "max_workers": 3, "object_store_mb": 32},
            },
            max_workers=3,
            idle_timeout_s=1.5,
            update_interval_s=0.2,
            env={"RAY_TPU_TEMP_DIR": root},
        )
        try:
            cluster.connect()

            @ray_tpu_torch.remote(num_cpus=1)
            def hold(i):
                time.sleep(2.0)
                return i

            # 5 one-CPU tasks against a 1-CPU head: the queue shape forces
            # scale-up; all tasks must complete on the grown cluster.
            refs = [hold.remote(i) for i in range(5)]
            out = ray_tpu_torch.get(refs, timeout=60)
            assert sorted(out) == [0, 1, 2, 3, 4]
            assert cluster.autoscaler.num_launches >= 1

            # After the burst the workers go idle and get reaped.
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                if not cluster.worker_node_ids():
                    break
                time.sleep(0.25)
            assert cluster.worker_node_ids() == []
            assert cluster.autoscaler.num_terminations >= 1
        finally:
            cluster.shutdown()


def test_autoscaler_min_workers_floor():
    with port_session_root() as root:
        cluster = AutoscalingCluster(
            head_resources={"CPU": 1.0},
            worker_node_types={
                "cpu1": {"resources": {"CPU": 1.0}, "min_workers": 2,
                         "max_workers": 2, "object_store_mb": 32},
            },
            max_workers=4,
            idle_timeout_s=0.5,
            update_interval_s=0.2,
            env={"RAY_TPU_TEMP_DIR": root},
        )
        try:
            # min_workers nodes come up with no demand at all, and idle
            # termination never dips below the floor.
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                if len(cluster.worker_node_ids()) >= 2:
                    break
                time.sleep(0.25)
            assert len(cluster.worker_node_ids()) == 2
            time.sleep(2.0)  # well past idle_timeout
            assert len(cluster.worker_node_ids()) == 2
        finally:
            cluster.shutdown()


@pytest.mark.slow
def test_up_down_cli(tmp_path):
    """`ray_tpu_torch up cluster.yaml` / `down` (reference: `ray up/down`,
    `scripts.py:1238,1314`): head + autoscaler come up from YAML,
    min_workers materialize, tasks run, teardown reaps everything."""
    import subprocess
    import sys

    import ray_tpu_torch

    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    cfg = tmp_path / "cluster.yaml"
    cfg.write_text(
        "cluster_name: testup\n"
        "max_workers: 3\n"
        "idle_timeout_s: 60\n"
        "head_node:\n"
        "  resources: {CPU: 1}\n"
        "worker_node_types:\n"
        "  cpu2:\n"
        "    resources: {CPU: 2}\n"
        "    min_workers: 1\n"
        "    max_workers: 2\n"
        "    object_store_mb: 32\n")
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    with port_session_root() as root:
        env = dict(os.environ, RAY_TPU_TEMP_DIR=root, TMPDIR=str(tmp))
        out = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.scripts", "up", str(cfg)],
            capture_output=True, text=True, timeout=120, env=env)
        assert out.returncode == 0, out.stderr[-500:]
        address = [ln for ln in out.stdout.splitlines()
                   if "up at" in ln][0].split()[-1]
        assert (tmp / "ray_tpu_torch" / "clusters" / "testup.json").exists()
        try:
            ray_tpu_torch.init(address=address)
            # min_workers worker joins -> 3 CPUs total eventually
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                if ray_tpu_torch.cluster_resources().get("CPU", 0) >= 3:
                    break
                time.sleep(0.5)
            assert ray_tpu_torch.cluster_resources()["CPU"] >= 3

            @ray_tpu_torch.remote(num_cpus=2)
            def on_worker():
                return "hi"

            assert ray_tpu_torch.get(on_worker.remote(), timeout=60) == "hi"
            ray_tpu_torch.shutdown()
        finally:
            down = subprocess.run(
                [sys.executable, "-m", "ray_tpu_torch.scripts", "down",
                 "--name", "testup"],
                capture_output=True, text=True, timeout=60, env=env)
            assert down.returncode == 0, down.stderr[-300:]


# ---------------------------------------------------------------------------
# GCE / TPU-VM provider (reference: _private/gcp/node_provider.py), against
# the reference's FakeGceApi (no network)


def test_gce_provider_launches_and_terminates_tpu_nodes():
    from ray_tpu_torch.autoscaler.gce import GceNodeProvider

    api = FakeGceApi()
    provider = GceNodeProvider(
        "10.0.0.1:6379",
        {"worker_tpu": {"kind": "tpu", "accelerator_type": "v5litepod-8",
                        "topology": "2x4",
                        "resources": {"CPU": 8.0, "TPU": 8.0}},
         "worker_cpu": {"kind": "compute", "machine_type": "n2-standard-8",
                        "resources": {"CPU": 8.0}}},
        api, cluster_name="t1")

    provider.create_node("worker_tpu", 2)
    provider.create_node("worker_cpu", 1)
    live = provider.non_terminated_nodes()
    assert sorted(live.values()) == ["worker_cpu", "worker_tpu",
                                    "worker_tpu"]
    # TPU instances get slice-identity env in their startup script so the
    # raylet registers with topology labels
    tpu_names = [n for n, t in live.items() if t == "worker_tpu"]
    for name in tpu_names:
        script = api.instances[name]["metadata"]["startup_script"]
        assert f"RAY_TPU_SLICE_ID={name}" in script
        assert "RAY_TPU_ACCELERATOR_TYPE=v5litepod-8" in script
        assert "RAY_TPU_GCS_ADDRESS=10.0.0.1:6379" in script
        assert "ray_tpu_torch.core.raylet_main" in script
        assert api.instances[name]["kind"] == "tpu"
        assert api.instances[name]["labels"]["ray-tpu-cluster"] == "t1"

    provider.terminate_node(tpu_names[0])
    assert ("delete", tpu_names[0], "tpu") in api.calls
    assert len(provider.non_terminated_nodes()) == 2
    provider.shutdown()
    assert provider.non_terminated_nodes() == {}


def test_autoscaler_scales_through_gce_provider():
    """StandardAutoscaler drives the GCE provider: min_workers launches
    fake cloud instances; removing the floor terminates them (instances
    never register raylets here, so idle-scale-down is out of scope)."""
    from ray_tpu_torch import cluster_utils
    from ray_tpu_torch.autoscaler import StandardAutoscaler
    from ray_tpu_torch.autoscaler.gce import GceNodeProvider

    with port_session_root() as root:
        env = cluster_utils.make_cluster_env({"RAY_TPU_TEMP_DIR": root})
        gcs_proc, address = cluster_utils.spawn_gcs(env)
        try:
            api = FakeGceApi()
            types = {"worker_tpu": {"kind": "tpu",
                                    "accelerator_type": "v5litepod-8",
                                    "resources": {"CPU": 8.0, "TPU": 8.0},
                                    "min_workers": 2}}
            provider = GceNodeProvider(address, types, api,
                                       cluster_name="t2")
            autoscaler = StandardAutoscaler(
                address, provider, types, max_workers=4, idle_timeout_s=1.0)
            autoscaler.update()
            assert autoscaler.num_launches == 2
            assert len([c for c in api.calls if c[0] == "create"]) == 2
            # steady state: floor satisfied, nothing new launches
            autoscaler.update()
            assert autoscaler.num_launches == 2
            autoscaler.close()
            provider.shutdown()
            assert api.instances == {}
        finally:
            gcs_proc.terminate()
            gcs_proc.wait(timeout=10)


def test_strict_pack_prefers_same_slice():
    """Bundles too big for one host pack onto ONE ICI slice (nodes sharing
    a tpu_slice label) instead of failing or spreading (SURVEY §7 items
    3-4)."""
    from ray_tpu_torch.core.gcs import GcsCore

    g = GcsCore()
    # two 2-CPU hosts of slice A, two 2-CPU hosts on other/no slices
    g.register_node("a0", ("h", 1), {"CPU": 2.0},
                    labels={"tpu_slice": "sliceA", "tpu_worker_id": "0"})
    g.register_node("a1", ("h", 2), {"CPU": 2.0},
                    labels={"tpu_slice": "sliceA", "tpu_worker_id": "1"})
    g.register_node("b0", ("h", 3), {"CPU": 2.0},
                    labels={"tpu_slice": "sliceB"})
    g.register_node("c0", ("h", 4), {"CPU": 2.0})
    placed = g._place_bundles([{"CPU": 2.0}, {"CPU": 2.0}], "STRICT_PACK")
    assert placed is not None
    assert set(placed.values()) == {"a0", "a1"}, placed
    # still prefers a SINGLE node when one fits everything
    g.register_node("big", ("h", 5), {"CPU": 8.0})
    placed = g._place_bundles([{"CPU": 2.0}, {"CPU": 2.0}], "STRICT_PACK")
    assert set(placed.values()) == {"big"}
    # infeasible even within a slice -> STRICT_PACK still refuses
    placed = g._place_bundles([{"CPU": 8.0}, {"CPU": 8.0}], "STRICT_PACK")
    assert placed is None


def test_card_node_type_scales_for_a_chip_task():
    """The port's own: a node type with one card, ``{"CPU": 1, "TPU": 1}``,
    is what a task asking for ``num_tpus=1`` brings up, and a CPU type is
    not."""
    sched = ResourceDemandScheduler(
        {"cpu2": {"resources": {"CPU": 2.0}},
         "gpu1": {"resources": {"CPU": 1.0, "TPU": 1.0}, "max_workers": 1}},
        max_workers=4)
    assert sched.get_nodes_to_launch(
        [{"CPU": 1.0, "TPU": 1.0}], [{"CPU": 1.0}], {}) == {"gpu1": 1}
    # one card a unit: two one-card tasks want two such nodes, capped at 1
    assert sched.get_nodes_to_launch(
        [{"CPU": 1.0, "TPU": 1.0}] * 2, [], {}) == {"gpu1": 1}
