"""Chaos / fault-injection helpers for tests.

Reference analogue: `python/ray/_private/test_utils.py:1400`
(NodeKillerActor / ResourceKillerActor, ``kill_raylet :1741``) and
`python/ray/tests/test_chaos.py`.  Two tools:

  * ``NodeKiller`` — periodically SIGKILLs a random worker NODE of the
    fake in-machine cluster (never the head), optionally respawning a
    replacement, so retries, actor failover, and lineage reconstruction
    are exercised under real process death.

  * ``NetworkChaos`` — deterministic, seedable network-fault injection on
    the runtime's own sockets: frame drop / delay / blackhole on raylet
    PEER connections and on the zero-copy DATA channels.  Env-gated via
    ``RAY_TPU_CHAOS_*`` so spawned raylet processes pick it up, or
    configured programmatically with :func:`configure_net` for the
    in-process raylet.  The send/serve hot paths call :func:`net_fault`,
    which is a no-op attribute check when chaos is disabled.

    Env knobs (all probabilities in [0,1]):
      RAY_TPU_CHAOS_NET_SEED         deterministic RNG seed (default 0)
      RAY_TPU_CHAOS_NET_DROP_P       drop a frame/response entirely
      RAY_TPU_CHAOS_NET_DELAY_P      delay a frame before sending
      RAY_TPU_CHAOS_NET_DELAY_MS     the injected delay, milliseconds
      RAY_TPU_CHAOS_NET_BLACKHOLE_P  partition the connection: every
                                     later frame on it vanishes silently
      RAY_TPU_CHAOS_NET_CHANNELS     csv of channels to afflict
                                     ("peer", "data"; default "data" —
                                     peer control frames have no
                                     per-frame retry, so dropping them
                                     is an explicit opt-in)

    A fault decision sequence is fully determined by (seed, sequence of
    ``net_fault`` calls), so a single-threaded workload replays exactly;
    multi-threaded callers still get a reproducible fault MIX.

    * **Partitions** — deterministic blackholing between THIS process and
      a named peer (or every peer, ``"*"``), in one or both directions:
      ``net().partition(peer, direction="both"|"out"|"in")`` then
      ``net().heal(peer)`` restores the link.  ``direction`` is relative
      to this process: ``out`` swallows frames it sends toward the peer,
      ``in`` swallows frames arriving from it (the data server drops the
      peer's requests).  Unlike the probabilistic ``blackhole`` fault —
      which latches the connection dead at the call site — partition
      drops are decided per frame, so ``heal()`` genuinely restores
      traffic on the same sockets (partition → resurrect scenarios).
      Partitions apply to every channel unless ``channels=`` narrows
      them.  Spawned processes are steered through a control FILE
      (``RAY_TPU_CHAOS_NET_PARTITION_FILE``): JSON
      ``{"partitions": {"<peer-or-*>": "<direction>"}}``, re-read at
      most every 50 ms, so a test driver can partition and heal a live
      raylet process by rewriting the file.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, List, Optional

from ray_tpu_torch.core.config import config
from ray_tpu_torch.util.locks import make_lock

config.define("chaos_net_seed", int, 0,
              "Network-chaos deterministic RNG seed.", live=True)
config.define("chaos_net_drop_p", float, 0.0,
              "Network chaos: probability a frame/response is dropped "
              "entirely.", live=True)
config.define("chaos_net_delay_p", float, 0.0,
              "Network chaos: probability a frame is delayed before "
              "sending.", live=True)
config.define("chaos_net_delay_ms", float, 0.0,
              "Network chaos: injected delay, milliseconds.", live=True)
config.define("chaos_net_blackhole_p", float, 0.0,
              "Network chaos: probability a connection is partitioned — "
              "every later frame on it vanishes silently.", live=True)
config.define("chaos_net_channels", str, "data",
              "Network chaos: csv of channels to afflict ('peer', "
              "'data').  Defaults to data only — peer control frames "
              "have no per-frame retry, so dropping them is an explicit "
              "opt-in.", live=True)
config.define("chaos_exec_delay_ms", float, 0.0,
              "Execution chaos: inject this delay (milliseconds) before a "
              "matching task executes on a worker — makes an executor "
              "pathologically slow without sleeps in user code "
              "(deadline/shedding tests).  0 disables.", live=True)
config.define("chaos_exec_delay_names", str, "",
              "Execution chaos: csv of substrings matched against task "
              "names (e.g. 'Replica.handle_request'); empty = every "
              "task.", live=True)
config.define("chaos_exec_delay_p", float, 1.0,
              "Execution chaos: probability a matching call is delayed, "
              "drawn from a deterministic RNG seeded by "
              "RAY_TPU_CHAOS_NET_SEED (replayable delay sequences).",
              live=True)
config.define("chaos_net_partition_file", str, "",
              "Network chaos: path of a JSON control file "
              "({'partitions': {'<peer-node-id-or-*>': "
              "'both'|'out'|'in'}}) steering deterministic per-peer "
              "partitions in THIS process.  Re-read at most every 50 ms, "
              "so a test driver partitions and heals a spawned raylet by "
              "rewriting the file.  Empty disables.", live=True)

__all__ = ["NodeKiller", "NetworkChaos", "net_fault", "configure_net",
           "net", "exec_delay", "snapshot_host", "assert_clean_host",
           "HostLeakError"]


class NodeKiller:
    """Background thread killing random worker nodes of a Cluster at an
    interval; optionally respawns a replacement so capacity survives."""

    def __init__(self, cluster, kill_interval_s: float = 1.0,
                 respawn: bool = True, seed: Optional[int] = None,
                 max_kills: int = 1_000_000):
        self.cluster = cluster
        self.kill_interval_s = kill_interval_s
        self.respawn = respawn
        self.max_kills = max_kills
        self.killed: List[str] = []
        self._rng = random.Random(seed)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="node-killer",
                                        daemon=True)

    def start(self) -> "NodeKiller":
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.kill_interval_s):
            if len(self.killed) >= self.max_kills:
                return
            head = getattr(self.cluster, "head_node", None)
            victims = [n for n in self.cluster.nodes
                       if n is not head and n.alive()]
            if not victims:
                continue
            node = self._rng.choice(victims)
            resources = dict(node.resources)
            store_mb = 64
            self.cluster.remove_node(node)  # SIGKILL
            self.killed.append(node.node_id)
            if self.respawn:
                cpus = resources.pop("CPU", 1)
                tpus = resources.pop("TPU", 0)
                try:
                    self.cluster.add_node(
                        num_cpus=cpus, num_tpus=tpus,
                        resources=resources or None,
                        object_store_mb=store_mb)
                except Exception:  # noqa: BLE001 — cluster shutting down
                    return

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)


# ---------------------------------------------------------------------------
# Network fault injection


class NetworkChaos:
    """Seedable fault decisions for the runtime's sockets.  One instance
    per process; decisions are drawn from a private ``random.Random`` so a
    fixed seed gives a reproducible fault sequence."""

    __slots__ = ("enabled", "seed", "drop_p", "delay_p", "delay_s",
                 "blackhole_p", "channels", "_rng", "_lock", "faults",
                 "partitions", "partition_file", "_pfile_at",
                 "exec_override")

    def __init__(self, drop_p: float = 0.0, delay_p: float = 0.0,
                 delay_ms: float = 0.0, blackhole_p: float = 0.0,
                 seed: int = 0, channels: Optional[List[str]] = None,
                 partition_file: Optional[str] = None):
        self.drop_p = max(0.0, drop_p)
        self.delay_p = max(0.0, delay_p)
        self.delay_s = max(0.0, delay_ms) / 1e3
        self.blackhole_p = max(0.0, blackhole_p)
        # Default to the DATA channel only: the pull manager's watchdogs
        # retry/rotate lost data frames, but peer control frames (xtask,
        # xdone, pull) are fire-and-forget over TCP — the runtime has no
        # per-frame ack, so dropping them simulates a failure mode the
        # real transport cannot produce and recovery is not defined for.
        # Afflicting "peer" is an explicit opt-in (delay is safe there;
        # drop/blackhole model a partition the control plane does not
        # currently heal).
        self.channels = frozenset(channels or ("data",))
        self.seed = seed
        self.enabled = (self.drop_p > 0 or self.delay_p > 0
                        or self.blackhole_p > 0)
        self._rng = random.Random(seed)  # guard: _lock
        self._lock = make_lock("chaos.net")
        # injected-fault counts by kind, for test assertions
        self.faults = {"drop": 0, "delay": 0, "blackhole": 0,
                       "partition": 0}
        # peer node_id (or "*") -> {"direction", "channels"} — see
        # partition()/heal().  Partition drops are deterministic (no RNG
        # draw) so heal() restores traffic exactly.
        self.partitions: dict = {}  # guard: _lock
        self.partition_file = partition_file or None
        self._pfile_at = 0.0  # last control-file refresh  # guard: _lock
        # control-file slow-exec steering: {"ms", "p", "names"} or None.
        # Lets a test driver toggle RAY_TPU_CHAOS_EXEC_DELAY_* semantics in
        # SPAWNED processes (their env is frozen at spawn) by rewriting
        # the control file — exec_delay() consults this before config.
        self.exec_override: Optional[dict] = None  # guard: _lock

    @classmethod
    def from_env(cls) -> "NetworkChaos":
        channels = [c.strip()
                    for c in config.chaos_net_channels.split(",")
                    if c.strip()]
        return cls(drop_p=config.chaos_net_drop_p,
                   delay_p=config.chaos_net_delay_p,
                   delay_ms=config.chaos_net_delay_ms,
                   blackhole_p=config.chaos_net_blackhole_p,
                   seed=config.chaos_net_seed, channels=channels,
                   partition_file=config.chaos_net_partition_file or None)

    # ---- deterministic per-peer partitions -------------------------------

    def partition(self, peer: str = "*", direction: str = "both",
                  channels: Optional[List[str]] = None):
        """Blackhole traffic between this process and ``peer`` (a node id,
        or ``"*"`` for every peer).  ``direction`` is relative to THIS
        process: ``out`` (frames we send toward the peer), ``in`` (frames
        arriving from it), or ``both``.  Applies to every chaos-hooked
        channel unless ``channels`` narrows it."""
        if direction not in ("both", "out", "in"):
            raise ValueError(f"direction {direction!r} not in both/out/in")
        with self._lock:
            self.partitions[peer] = {
                "direction": direction,
                "channels": frozenset(channels) if channels else None,
            }

    def heal(self, peer: Optional[str] = None):
        """Restore the link to ``peer`` (or every partitioned peer)."""
        with self._lock:
            if peer is None:
                self.partitions.clear()
            else:
                self.partitions.pop(peer, None)

    def _refresh_partitions_locked(self):  # requires: _lock
        """Re-read the control file (test driver -> spawned process
        steering), at most every 50 ms."""
        now = time.monotonic()
        if now - self._pfile_at < 0.05:
            return
        self._pfile_at = now
        import json
        try:
            with open(self.partition_file) as f:
                spec = json.load(f)
        except (OSError, ValueError):
            return  # missing/garbled file: keep the last applied state
        entries = spec.get("partitions") or {}
        self.partitions = {
            peer: {"direction": direction
                   if direction in ("both", "out", "in") else "both",
                   "channels": None}
            for peer, direction in entries.items()
        }
        ov = spec.get("exec_delay")
        if isinstance(ov, dict) and float(ov.get("ms", 0) or 0) > 0:
            self.exec_override = {
                "ms": float(ov["ms"]),
                "p": float(ov.get("p", 1.0)),
                "names": str(ov.get("names", "")),
            }
        else:
            self.exec_override = None

    def exec_override_state(self) -> Optional[dict]:
        """Current control-file slow-exec override ({'ms','p','names'}) or
        None.  Refreshes the control file on the same 50 ms cadence as the
        partition state."""
        if not self.partition_file:
            return None
        with self._lock:
            self._refresh_partitions_locked()
            return self.exec_override

    def _partitioned_locked(self, channel: str, peer: Optional[str],  # requires: _lock
                            direction: str) -> bool:
        for key in (peer, "*"):
            if key is None:
                continue
            ent = self.partitions.get(key)
            if ent is None:
                continue
            if ent["channels"] is not None and channel not in ent["channels"]:
                continue
            if ent["direction"] in ("both", direction):
                return True
        return False

    def decide(self, channel: str, peer: Optional[str] = None,
               direction: str = "out") -> Optional[str]:
        """Draw a fault for one frame on ``channel``:
        None | "drop" | "delay" | "blackhole".  Partition drops are
        checked first and are deterministic (no RNG draw — replay
        sequences are unchanged by partition windows)."""
        if self.partition_file \
                or self.partitions:  # unguarded-ok: empty-check fast path; re-checked under _lock below
            with self._lock:
                if self.partition_file:
                    self._refresh_partitions_locked()
                if self._partitioned_locked(channel, peer, direction):
                    self.faults["partition"] += 1
                    return "drop"
        if not self.enabled or channel not in self.channels:
            return None
        with self._lock:
            r = self._rng.random()
            if r < self.blackhole_p:
                self.faults["blackhole"] += 1
                return "blackhole"
            r -= self.blackhole_p
            if r < self.drop_p:
                self.faults["drop"] += 1
                return "drop"
            r -= self.drop_p
            if r < self.delay_p:
                self.faults["delay"] += 1
                return "delay"
        return None


_net: Optional[NetworkChaos] = None


def net() -> NetworkChaos:
    """The process's NetworkChaos instance (env-configured on first use)."""
    global _net
    if _net is None:
        _net = NetworkChaos.from_env()
    return _net


def configure_net(**kwargs) -> NetworkChaos:
    """Programmatic (re)configuration — for the in-process raylet in
    tests.  Pass the NetworkChaos constructor kwargs; omit all to reset
    from the environment."""
    global _net
    _net = NetworkChaos(**kwargs) if kwargs else NetworkChaos.from_env()
    return _net


_exec_rng: Optional[random.Random] = None
_exec_rng_lock = make_lock("chaos.exec_delay")


def exec_delay(task_name: str) -> float:
    """Seeded slow-executor injection, called by the worker between
    arg-pull and exec: sleep ``RAY_TPU_CHAOS_EXEC_DELAY_MS`` when the task
    name matches ``RAY_TPU_CHAOS_EXEC_DELAY_NAMES`` (csv substrings; empty
    matches all) with probability ``RAY_TPU_CHAOS_EXEC_DELAY_P`` (drawn
    from an RNG seeded by ``RAY_TPU_CHAOS_NET_SEED``, so delay sequences
    replay).  Returns the injected delay in seconds (0 = none).  Live
    flags: the check costs two env reads per execution when disabled.

    When a chaos control file is configured
    (``RAY_TPU_CHAOS_NET_PARTITION_FILE``), an ``exec_delay`` entry in it
    overrides the env knobs — the file is re-read live, so a schedule
    driver can open and close slow-executor windows in already-spawned
    workers (their env is frozen at spawn)."""
    global _exec_rng
    ms = config.chaos_exec_delay_ms
    names_csv = config.chaos_exec_delay_names
    p = config.chaos_exec_delay_p
    ov = None
    n = _net
    if n is not None and n.partition_file:
        ov = n.exec_override_state()
    elif n is None and config.chaos_net_partition_file:
        ov = net().exec_override_state()
    if ov is not None:
        ms, p, names_csv = ov["ms"], ov["p"], ov["names"]
    if ms <= 0:
        return 0.0
    names = [nm.strip() for nm in names_csv.split(",") if nm.strip()]
    if names and not any(nm in task_name for nm in names):
        return 0.0
    if p < 1.0:
        with _exec_rng_lock:
            if _exec_rng is None:
                _exec_rng = random.Random(config.chaos_net_seed)
            if _exec_rng.random() >= p:
                return 0.0
    delay = ms / 1e3
    time.sleep(delay)
    return delay


def net_fault(channel: str, peer: Optional[str] = None,
              direction: str = "out") -> Optional[str]:
    """Hot-path hook: a fault decision for one frame, or None.  Costs a
    few attribute checks when chaos is disabled.  ``peer``/``direction``
    feed the deterministic partition check (see NetworkChaos.partition);
    probabilistic faults ignore them."""
    n = _net
    if n is None:
        n = net()
    if not n.enabled and not n.partition_file \
            and not n.partitions:  # unguarded-ok: empty-check fast path; decide() re-checks under _lock
        return None
    fault = n.decide(channel, peer=peer, direction=direction)
    if fault == "delay":
        time.sleep(n.delay_s)
        return None  # the frame still goes out, late
    return fault


# ---------------------------------------------------------------------------
# Clean-host audit: no orphan runtime processes / shm segments / socket fds
# after a cluster is torn down.  Factored out of the manual verify recipe so
# cluster-spinning tests fail loudly on leaks instead of leaving them for a
# human `pgrep` at review time.

# argv module names of every spawnable runtime process.  Matched as EXACT
# argv elements (``/proc/<pid>/cmdline`` is NUL-separated), never as
# substrings — test harnesses and editors routinely hold these strings
# inside one long quoted argument and must not count as runtime orphans.
_RUNTIME_MODULES = frozenset((
    "ray_tpu_torch.core.worker_main",
    "ray_tpu_torch.core.raylet_main",
    "ray_tpu_torch.core.gcs_main",
))


class HostLeakError(AssertionError):
    """A runtime process, shm segment, or socket fd outlived its cluster."""


def _runtime_pids() -> Dict[int, str]:
    """pid -> module name for every live runtime process on this host."""
    out: Dict[int, str] = {}
    me = os.getpid()
    try:
        pids = [int(d) for d in os.listdir("/proc") if d.isdigit()]
    except OSError:  # pragma: no cover — non-Linux
        return out
    for pid in pids:
        if pid == me:
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\x00")
        except OSError:
            continue  # raced an exit
        for arg in argv:
            name = arg.decode("utf-8", "replace")
            if name in _RUNTIME_MODULES:
                out[pid] = name
                break
    return out


def _shm_segments() -> List[str]:
    """Live ray_tpu_torch object-store segments under /dev/shm."""
    try:
        return sorted(n for n in os.listdir("/dev/shm")
                      if n.startswith("rtt_store"))
    except OSError:  # pragma: no cover — no /dev/shm
        return []


def _socket_fd_count() -> int:
    """Open socket fds of THIS process (driver-side leak detector)."""
    try:
        fds = os.listdir("/proc/self/fd")
    except OSError:  # pragma: no cover — non-Linux
        return 0
    n = 0
    for fd in fds:
        try:
            if os.readlink(f"/proc/self/fd/{fd}").startswith("socket:"):
                n += 1
        except OSError:
            continue
    return n


def snapshot_host() -> dict:
    """Baseline for :func:`assert_clean_host`: take it BEFORE starting a
    cluster so pre-existing processes/segments (other sessions, the test
    harness itself) are excluded from the leak check."""
    return {"pids": _runtime_pids(), "shm": set(_shm_segments()),
            "socket_fds": _socket_fd_count()}


def assert_clean_host(baseline: Optional[dict] = None,
                      grace_s: float = 15.0,
                      check_sockets: bool = False):
    """Assert no runtime process, object-store shm segment, or (opt-in)
    driver socket fd outlived the cluster(s) torn down since ``baseline``.

    Teardown is asynchronous (workers die on socket EOF, raylets reap on
    SIGTERM), so the check POLLS up to ``grace_s`` before declaring a
    leak.  Raises :class:`HostLeakError` listing the survivors.

    ``check_sockets`` compares this process's open socket-fd count to the
    baseline — off by default because long-lived test fixtures (shared
    runtimes, metric pollers) legitimately hold sockets across calls.
    """
    base_pids = set((baseline or {}).get("pids", {}))
    base_shm = set((baseline or {}).get("shm", ()))
    deadline = time.monotonic() + grace_s
    while True:
        pids = {p: m for p, m in _runtime_pids().items()
                if p not in base_pids}
        shm = [s for s in _shm_segments() if s not in base_shm]
        leaks = []
        if pids:
            leaks.append("orphan processes: " + ", ".join(
                f"pid {p} ({m})" for p, m in sorted(pids.items())))
        if shm:
            leaks.append("leaked shm segments: " + ", ".join(shm))
        if check_sockets and baseline is not None:
            extra = _socket_fd_count() - baseline.get("socket_fds", 0)
            if extra > 0:
                leaks.append(f"{extra} leaked socket fd(s) in this process")
        if not leaks:
            return
        if time.monotonic() >= deadline:
            raise HostLeakError(
                "host not clean after cluster teardown — " +
                "; ".join(leaks))
        time.sleep(0.25)
