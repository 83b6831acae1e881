"""The port's counterparts of ``tests/test_chaos_schedule.py``'s 18 cases:
seeded fault schedules, the invariant bank and compound-fault soaks
(``ray_tpu_torch.util.chaos_schedule``, a copy of the reference's with hunk
(a) alone); the reference's slow mark is kept.

Three layers, as in the reference:

* pure: schedule determinism (byte-identical JSONL per seed), replay
  round-trips, each invariant checker's failure mode on synthetic
  violations (a checker that can't fail proves nothing);
* host hygiene: dead-pid shm sweep, kill-path segment reaping, on the
  port's ``rtt_store_`` segments (hunk (g) of ``core/object_store.py``);
* live: fixed-seed compound scenarios (kill during GCS mass-reconnect,
  partition spanning a GCS restart, partition during drain, cancel
  during reconstruction) and a fixed-seed smoke soak over all six fault
  kinds on port clusters, each ending with ZERO invariant violations.

Every cluster runs under a session root of its own and is held to the
port's leak audit (``assert_port_left_nothing``) in place of the
reference's host-wide ``clean_host``, which would count the port clusters
of other test workers.
"""

import json
import os
import subprocess
import sys
import time

import pytest
from test_torch_runtime_parity import port_session_root

from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core.config import config
from ray_tpu_torch.util import chaos_schedule as cs


# ---------------------------------------------------------------- pure

def test_schedule_is_deterministic_and_byte_identical():
    a = cs.build_schedule(42, 60.0, n_slots=3)
    b = cs.build_schedule(42, 60.0, n_slots=3)
    assert cs.timeline_to_jsonl(a) == cs.timeline_to_jsonl(b)
    assert a == b
    # different seed, different timeline
    c = cs.build_schedule(43, 60.0, n_slots=3)
    assert cs.timeline_to_jsonl(a) != cs.timeline_to_jsonl(c)
    # sorted by time, contiguous idx, slots in range
    assert [e["idx"] for e in a] == list(range(len(a)))
    assert all(a[i]["t_s"] <= a[i + 1]["t_s"] for i in range(len(a) - 1))
    assert all(0 <= e["slot"] < 3 for e in a)


def test_schedule_pairs_heals_with_duration_faults():
    events = cs.build_schedule(7, 120.0, n_slots=2)
    heals = {"partition": "heal_partition", "slow_exec": "heal_slow_exec",
             "oom": "heal_oom"}
    for i, ev in enumerate(events):
        heal = heals.get(ev["kind"])
        if not heal:
            continue
        want_t = round(ev["t_s"] + ev["params"]["duration_s"], 3)
        match = [e for e in events
                 if e["kind"] == heal and e["slot"] == ev["slot"]
                 and abs(e["t_s"] - want_t) < 1e-9]
        assert match, f"no {heal} for event {ev}"


def test_timeline_replay_roundtrip(tmp_path):
    events = cs.build_schedule(5, 40.0, n_slots=2)
    plan = tmp_path / "plan.jsonl"
    cs.write_timeline(events, str(plan))
    assert cs.load_timeline(str(plan)) == [
        {k: e[k] for k in ("idx", "t_s", "kind", "slot", "params")}
        for e in events]
    # an EXECUTED log — outcome fields, interleaved MTTR records, a
    # trailing summary — replays the identical plan
    log = tmp_path / "events.jsonl"
    with open(log, "w") as f:
        for ev in events:
            rec = dict(ev, t_wall=ev["t_s"] + 0.7, ok=True, detail="x")
            f.write(json.dumps(rec) + "\n")
            f.write(json.dumps({"idx": ev["idx"], "kind": ev["kind"],
                                "mttr_s": 1.5}) + "\n")
        f.write(json.dumps({"report": {"ok": True}}) + "\n")
    assert cs.load_timeline(str(log)) == cs.load_timeline(str(plan))


def test_build_schedule_rejects_bad_inputs():
    with pytest.raises(ValueError):
        cs.build_schedule(1, 30.0, faults=("node_kill", "meteor"))
    with pytest.raises(ValueError):
        cs.build_schedule(1, 30.0, n_slots=0)


def test_backoff_stagger_spreads_full_span():
    from ray_tpu_torch.util.retry import BackoffPolicy

    a = BackoffPolicy(seed=9)
    b = BackoffPolicy(seed=9)
    draws = [a.stagger(2.0) for _ in range(50)]
    assert draws == [b.stagger(2.0) for _ in range(50)]
    assert all(0.0 <= d <= 2.0 for d in draws)
    # full-span: draws actually cover the window, not a narrow band
    assert max(draws) - min(draws) > 1.0
    assert a.stagger(0.0) == 0.0


# ------------------------------------- invariant checkers must FAIL too

class _FakeWorkload(cs.Workload):
    name = "fake"

    def __init__(self):
        super().__init__()

    def _step(self, seq):  # pragma: no cover - never started
        raise AssertionError


def test_exactly_once_checker_flags_double_markers(tmp_path):
    wl = cs.ActorMarkerWorkload(str(tmp_path))
    wl.acked_tags.append("marker-000001")
    (tmp_path / "marker-000000").write_text("xx")   # double execution
    (tmp_path / "marker-000001").write_text("x")    # acked, clean
    (tmp_path / "marker-000002").write_text("x")    # unacked, clean
    out = cs.check_exactly_once([wl])
    assert not out["ok"]
    assert "marker-000000" in out["detail"]
    # clean ledger passes
    (tmp_path / "marker-000000").write_text("x")
    assert cs.check_exactly_once([wl])["ok"]
    # an acked tag with NO marker is a lost side effect
    wl.acked_tags.append("marker-000009")
    assert not cs.check_exactly_once([wl])["ok"]


def test_accounting_checker_flags_unclassified_submissions():
    wl = _FakeWorkload()
    wl.counts.update(submitted=10, succeeded=5, failed=2, cancelled=2)
    out = cs.check_accounting([wl])
    assert not out["ok"] and "1 unclassified" in out["detail"]
    wl.counts["succeeded"] = 6
    assert cs.check_accounting([wl])["ok"]
    # a workload that never submitted proves nothing
    idle = _FakeWorkload()
    assert not cs.check_accounting([idle])["ok"]


def test_metrics_checker_demands_destructive_fault(monkeypatch):
    from ray_tpu_torch.util import state

    monkeypatch.setattr(
        state, "query_metrics",
        lambda *a, **k: {"points": [{"value": 3.0}]})
    benign = [{"kind": "slow_exec", "ok": True}]
    out = cs.check_metrics_consistent(benign)
    assert not out["ok"] and "no destructive fault" in out["detail"]
    # reconstruction is explainable once a kill is in the log
    killed = benign + [{"kind": "node_kill", "ok": True}]
    assert cs.check_metrics_consistent(killed)["ok"]
    # local mode (no table) is vacuously fine
    monkeypatch.setattr(state, "query_metrics", lambda *a, **k: None)
    assert cs.check_metrics_consistent(benign)["ok"]


def test_alerts_checker_allowlists_by_fault_kind(monkeypatch):
    from ray_tpu_torch.util import state

    firing = {"firing": [{"rule": "replication_repair_pressure"}],
              "log": []}
    monkeypatch.setattr(state, "list_alerts", lambda *a, **k: firing)
    out = cs.check_alerts_quiet([])
    assert not out["ok"] and "replication_repair_pressure" in out["detail"]
    assert cs.check_alerts_quiet([{"kind": "node_kill", "ok": True}])["ok"]
    # info-severity export-overflow alerts are always excused
    firing["firing"].append({"rule": "task_event_drops"})
    assert cs.check_alerts_quiet(
        [{"kind": "node_kill", "ok": True}])["ok"]


def test_converged_checker_fails_on_unreachable_gcs():
    class Dead:
        address = "127.0.0.1:1"
        nodes = []

    out = cs.check_converged(Dead(), timeout_s=1.0)
    assert not out["ok"]


# ------------------------------------------------------- host hygiene

def test_sweep_dead_store_files(tmp_path):
    from ray_tpu_torch.core.object_store import sweep_dead_store_files

    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    dead = tmp_path / f"rtt_store_{proc.pid}_abc123"
    dead.write_bytes(b"\0" * 64)
    spill = tmp_path / f"rtt_store_{proc.pid}_abc123.spill"
    spill.mkdir()
    (spill / "obj").write_bytes(b"x")
    live = tmp_path / f"rtt_store_{os.getpid()}_def456"
    live.write_bytes(b"\0" * 64)
    junk = tmp_path / "rtt_store_notapid"
    junk.write_bytes(b"\0")
    removed = sweep_dead_store_files(str(tmp_path))
    assert removed == [str(dead)]
    assert not dead.exists() and not spill.exists()
    assert live.exists() and junk.exists()


def test_node_kill_reaps_shm_segment():
    if not os.path.isdir("/dev/shm"):
        pytest.skip("no /dev/shm")
    with port_session_root() as root, \
            Cluster(env={"RAY_TPU_TEMP_DIR": root}) as cluster:
        node = cluster.add_node(num_cpus=1)
        pid = node.proc.pid
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if any(n.startswith(f"rtt_store_{pid}_")
                   for n in os.listdir("/dev/shm")):
                break
            time.sleep(0.1)
        else:
            pytest.fail(f"raylet {pid} never created a store segment")
        cluster.remove_node(node)  # SIGKILL — raylet can't unlink
        assert not any(n.startswith(f"rtt_store_{pid}_")
                       for n in os.listdir("/dev/shm"))


# --------------------------------------------- live compound scenarios

# Workloads and the MTTR probe carry this resource so the scheduler
# MUST place them on the killable worker slots, never the quiet head.
_PIN = {"chaos": 0.01}


def _soak_cluster(tmp_path, root, n_workers=2, persist=True):
    ctrl = str(tmp_path / "chaos_ctrl.json")
    mem = str(tmp_path / "mem_usage")
    cluster = Cluster(
        gcs_persist_path=str(tmp_path / "gcs") if persist else None,
        chaos_control_file=ctrl, memory_usage_file=mem,
        env={"RAY_TPU_GCS_RECONNECT_TIMEOUT_S": "30",
             "RAY_TPU_TEMP_DIR": root})
    for _ in range(n_workers):
        cluster.add_node(num_cpus=2, resources={"chaos": 4})
    cluster.connect()
    cluster.wait_for_nodes()
    return cluster, ctrl, mem


def _run_scenario(tmp_path, events, n_workers=2, persist=True,
                  workload_kinds=("fanout", "marker")):
    with port_session_root() as root:
        return _run_scenario_under(tmp_path, root, events, n_workers,
                                   persist, workload_kinds)


def _run_scenario_under(tmp_path, root, events, n_workers, persist,
                        workload_kinds):
    cluster, ctrl, mem = _soak_cluster(tmp_path, root, n_workers, persist)
    try:
        wls = []
        if "fanout" in workload_kinds:
            wls.append(cs.TaskFanoutWorkload(placement_resources=_PIN))
        if "marker" in workload_kinds:
            wls.append(cs.ActorMarkerWorkload(str(tmp_path / "markers"),
                                              placement_resources=_PIN))
        if "putget" in workload_kinds:
            wls.append(cs.PutGetWorkload(placement_resources=_PIN))
        runner = cs.ChaosRunner(
            cluster, events, wls, control_file=ctrl, memory_file=mem,
            log_path=str(tmp_path / "events.jsonl"), mttr_timeout_s=60.0,
            probe_resources=_PIN)
        report = runner.run(quiesce_timeout_s=60.0)
        if not report["ok"]:  # full context on the one failure that counts
            print(cs.render_report(report))
        return report, runner
    finally:
        cluster.shutdown()


def _ev(idx, t_s, kind, slot=0, **params):
    return {"idx": idx, "t_s": t_s, "kind": kind, "slot": slot,
            "params": params}


def test_compound_kill_during_gcs_mass_reconnect(tmp_path):
    # restart_gcs blocks until the service is back, so the kill lands in
    # the raylets' reconnect/re-registration window — node death and
    # mass re-registration race on the fresh GCS.
    events = [_ev(0, 1.0, "gcs_restart"),
              _ev(1, 1.1, "node_kill", slot=0),
              _ev(2, 3.0, "node_kill", slot=1)]
    report, runner = _run_scenario(tmp_path, events)
    assert report["ok"], report["violations"]
    assert all(rec["ok"] for rec in runner.executed), runner.executed


def test_compound_partition_spanning_gcs_restart(tmp_path):
    # the paused raylet misses the GCS restart entirely; on heal it must
    # reconnect, learn it was fenced, and re-register exactly once
    events = [_ev(0, 0.5, "partition", slot=0, duration_s=5.0),
              _ev(1, 1.0, "gcs_restart"),
              _ev(2, 5.5, "heal_partition", slot=0)]
    report, _ = _run_scenario(tmp_path, events)
    assert report["ok"], report["violations"]


def test_compound_partition_during_drain(tmp_path):
    # drain the node, then partition it mid-migration: the drain must
    # either finish after heal or fail cleanly — never wedge the
    # cluster or lose acked objects
    events = [_ev(0, 0.5, "drain", slot=0, timeout_s=6.0),
              _ev(1, 1.0, "partition", slot=0, duration_s=2.5),
              _ev(2, 3.5, "heal_partition", slot=0)]
    report, _ = _run_scenario(tmp_path, events,
                              workload_kinds=("fanout", "putget"))
    assert report["ok"], report["violations"]


def test_compound_cancel_during_reconstruction(tmp_path):
    # the fanout workload cancels every 13th task; back-to-back kills
    # force lineage reconstruction underneath those cancellations
    events = [_ev(0, 1.5, "node_kill", slot=0),
              _ev(1, 3.0, "node_kill", slot=1),
              _ev(2, 4.5, "node_kill", slot=0)]
    report, _ = _run_scenario(tmp_path, events, persist=False,
                              workload_kinds=("fanout",))
    assert report["ok"], report["violations"]


def test_smoke_soak_fixed_seed(tmp_path):
    # Seed 12 draws all six fault kinds in 25s (verified property of the
    # deterministic schedule — it can never silently change).
    events = cs.build_schedule(12, 25.0, n_slots=2,
                               min_gap_s=2.0, max_gap_s=4.0)
    kinds = {e["kind"] for e in events}
    assert {"node_kill", "partition", "gcs_restart", "drain",
            "slow_exec", "oom"} <= kinds
    report, runner = _run_scenario(
        tmp_path, events, workload_kinds=("fanout", "marker", "putget"))
    assert report["ok"], report["violations"]
    assert report["events_executed"] == len(events)
    # MTTR watchers produced real (non-zero) recovery readings
    mttr = report["mttr_s"]
    assert mttr, "no MTTR samples recorded"
    assert all(s["timeouts"] == 0 for s in mttr.values()), mttr
    # the executed log replays the identical plan
    assert cs.load_timeline(str(tmp_path / "events.jsonl")) == [
        {k: e[k] for k in ("idx", "t_s", "kind", "slot", "params")}
        for e in events]


@pytest.mark.slow
def test_soak_randomized_long(tmp_path):
    """Tier-2 soak: RAY_TPU_CHAOS_SOAK_SEED varies per CI run; a failing
    seed replays locally via the logged timeline."""
    seed = config.chaos_soak_seed
    duration = config.chaos_soak_duration_s
    events = cs.build_schedule(seed, duration, n_slots=3)
    report, _ = _run_scenario(
        tmp_path, events, n_workers=3,
        workload_kinds=("fanout", "marker", "putget"))
    assert report["ok"], (
        f"seed {seed} violated {report['violations']} — replay with "
        f"ray_tpu_torch chaos --replay {tmp_path / 'events.jsonl'}")
