"""Fake multi-node cluster for tests — the ``ray.cluster_utils.Cluster``
analogue (`python/ray/cluster_utils.py:99`, ``add_node`` `:165`).

Spawns a real GCS server process and one raylet PROCESS per simulated node
on this machine, each with its own shm object store, worker pool, and TCP
listener — so scheduling spillback, cross-node object transfer, and node
failure (``remove_node`` kills the raylet with SIGKILL) exercise the same
code paths a physical cluster would.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional


class NodeHandle:
    def __init__(self, proc: subprocess.Popen, node_id: str, port: int,
                 resources: Dict[str, float], object_store_mb: int = 128):
        self.proc = proc
        self.node_id = node_id
        self.port = port
        self.resources = resources
        self.object_store_mb = object_store_mb

    def alive(self) -> bool:
        return self.proc.poll() is None


def _read_tagged_line(proc: subprocess.Popen, tag: str, timeout: float = 30.0):
    """Read stdout lines until one starts with ``tag`` (startup banner)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"process exited with {proc.returncode} before printing "
                    f"{tag!r}: {proc.stderr.read() if proc.stderr else ''}")
            time.sleep(0.01)
            continue
        line = line.strip()
        if line.startswith(tag):
            return line
    raise TimeoutError(f"timed out waiting for {tag!r} banner")


def make_cluster_env(extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Environment for spawned GCS/raylet processes: driver import path,
    fast failure detection for tests, the card hidden unless asked for."""
    env = dict(os.environ)
    # Subprocesses must resolve ray_tpu_torch (and the user's modules) no
    # matter their cwd — propagate the driver's import path, the same
    # way the raylet ships it to workers.
    path_entries = [p for p in sys.path if p] + [
        p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p
    ]
    seen: set = set()
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in path_entries if not (p in seen or seen.add(p)))
    # Fast failure detection for tests (prod tunes these up).
    env.setdefault("RAY_TPU_GCS_HEARTBEAT_INTERVAL_S", "0.1")
    env.setdefault("RAY_TPU_GCS_NODE_TIMEOUT_S", "1.5")
    # Cluster processes stay off the card unless the caller's environment
    # or ``Cluster(env=...)`` names it: a node given ``num_tpus`` reaches
    # the card only then, and a GPU task on a node that hides it fails.
    env.setdefault("CUDA_VISIBLE_DEVICES", "")
    env.update(extra or {})
    return env


def spawn_gcs(env: Dict[str, str], port: int = 0,
              persist: Optional[str] = None):
    """Start a GCS server process; returns ``(proc, address)``."""
    cmd = [sys.executable, "-m", "ray_tpu_torch.core.gcs_main", "--port",
           str(port)]
    if persist:
        cmd += ["--persist", persist]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True, env=env)
    banner = _read_tagged_line(proc, "GCS_ADDRESS")
    return proc, banner.split()[1]


def spawn_raylet(gcs_address: str, resources: Dict[str, float],
                 object_store_mb: int, env: Dict[str, str]) -> NodeHandle:
    """Start one raylet process against ``gcs_address`` and wait for its
    startup banner."""
    import json

    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.core.raylet_main",
         "--gcs", gcs_address,
         "--resources", json.dumps(resources),
         "--store-mb", str(object_store_mb)],
        stdout=subprocess.PIPE, stderr=None,
        text=True, env=env)
    banner = _read_tagged_line(proc, "RAYLET")
    fields = dict(kv.split("=") for kv in banner.split()[1:])
    return NodeHandle(proc, fields["node_id"], int(fields["port"]),
                      dict(resources), object_store_mb=object_store_mb)


class Cluster:
    """Start with a head node, then ``add_node`` more; ``connect`` attaches
    the current process as a driver (``ray_tpu_torch.init(address=...)``)."""

    def __init__(self, initialize_head: bool = True,
                 head_resources: Optional[Dict[str, float]] = None,
                 env: Optional[Dict[str, str]] = None,
                 gcs_persist_path: Optional[str] = None,
                 chaos_control_file: Optional[str] = None,
                 memory_usage_file: Optional[str] = None):
        """``gcs_persist_path``: enable GCS fault tolerance — durable
        tables snapshot there and ``restart_gcs()`` brings the control
        plane back on the SAME port (raylets need
        RAY_TPU_GCS_RECONNECT_TIMEOUT_S > 0 to ride through).

        ``chaos_control_file``: export this path as the chaos control file
        (``RAY_TPU_CHAOS_NET_PARTITION_FILE``) into every spawned
        GCS/raylet/worker, so a chaos driver steers partitions and
        slow-exec windows in live processes by rewriting one JSON file.

        ``memory_usage_file``: export as ``RAY_TPU_MEMORY_USAGE_FILE`` and
        enable the raylet memory monitor — the driver injects OOM
        pressure by writing a usage fraction into the file."""
        self._env = make_cluster_env(env)
        if chaos_control_file:
            self._env["RAY_TPU_CHAOS_NET_PARTITION_FILE"] = \
                chaos_control_file
        if memory_usage_file:
            self._env["RAY_TPU_MEMORY_USAGE_FILE"] = memory_usage_file
            self._env.setdefault("RAY_TPU_MEMORY_MONITOR_INTERVAL_S",
                                 "0.25")
        self._gcs_persist = gcs_persist_path
        self.nodes: List[NodeHandle] = []
        self._gcs_proc, self.address = spawn_gcs(
            self._env, persist=gcs_persist_path)
        self._connected = False
        if initialize_head:
            self.head_node = self.add_node(
                **(head_resources or {"num_cpus": 2}))

    def add_node(self, num_cpus: float = 2, num_tpus: float = 0,
                 resources: Optional[Dict[str, float]] = None,
                 object_store_mb: int = 128) -> NodeHandle:
        res = {"CPU": float(num_cpus)}
        if num_tpus:
            res["TPU"] = float(num_tpus)
        res.update(resources or {})
        handle = spawn_raylet(self.address, res, object_store_mb, self._env)
        self.nodes.append(handle)
        return handle

    def kill_gcs(self):
        """SIGKILL the GCS process (chaos; reference:
        `test_gcs_fault_tolerance.py`)."""
        if self._gcs_proc.poll() is None:
            self._gcs_proc.send_signal(signal.SIGKILL)
            self._gcs_proc.wait(timeout=10)

    def restart_gcs(self):
        """Restart the GCS on the SAME address from its persisted
        snapshot.  Requires gcs_persist_path."""
        assert self._gcs_persist, "Cluster(gcs_persist_path=...) required"
        self.kill_gcs()
        port = int(self.address.rsplit(":", 1)[1])
        deadline = time.monotonic() + 15
        last_err = None
        while time.monotonic() < deadline:
            try:
                self._gcs_proc, addr = spawn_gcs(
                    self._env, port=port, persist=self._gcs_persist)
                assert addr == self.address
                return
            except RuntimeError as e:  # port still in TIME_WAIT
                last_err = e
                time.sleep(0.3)
        raise RuntimeError(f"could not restart GCS: {last_err}")

    def replace_node(self, node: NodeHandle) -> NodeHandle:
        """SIGKILL ``node`` and respawn a replacement with the same
        resources and store size IN ITS SLOT (same index in ``nodes``), so
        chaos schedules addressing nodes by slot keep a stable mapping
        across kills.  Returns the replacement handle."""
        try:
            idx = self.nodes.index(node)
        except ValueError:
            idx = None
        self.remove_node(node)
        handle = spawn_raylet(self.address, dict(node.resources),
                              node.object_store_mb, self._env)
        if idx is None or idx >= len(self.nodes):
            self.nodes.append(handle)
        else:
            self.nodes.insert(idx, handle)
        if getattr(self, "head_node", None) is node:
            self.head_node = handle
        return handle

    def pause_node(self, node: NodeHandle):
        """SIGSTOP the raylet process — simulates a network partition /
        long stall: the node stops heartbeating and answering liveness
        probes while its sockets stay open, so the GCS suspicion machine
        declares it dead; ``resume_node`` then 'heals the partition' and
        the resurrected raylet learns it was fenced."""
        if node.alive():
            node.proc.send_signal(signal.SIGSTOP)

    def resume_node(self, node: NodeHandle):
        """SIGCONT a paused raylet (heal the simulated partition)."""
        if node.alive():
            node.proc.send_signal(signal.SIGCONT)

    def remove_node(self, node: NodeHandle, allow_graceful: bool = False):
        """SIGKILL by default — simulates node failure (reference:
        ``Cluster.remove_node`` / NodeKillerActor chaos tooling)."""
        if node.alive():
            node.proc.send_signal(
                signal.SIGTERM if allow_graceful else signal.SIGKILL)
            node.proc.wait(timeout=10)
        if node in self.nodes:
            self.nodes.remove(node)
        # A SIGKILLed raylet never unlinks its shm store segment; reap it
        # here so chaos runs don't bleed host memory (the runtime also
        # sweeps dead-pid segments on the next raylet start).
        import glob
        import shutil

        for path in glob.glob(f"/dev/shm/rtt_store_{node.proc.pid}_*"):
            if path.endswith(".spill"):
                shutil.rmtree(path, ignore_errors=True)
            else:
                try:
                    os.unlink(path)
                except OSError:
                    pass

    def connect(self):
        import ray_tpu_torch

        ray_tpu_torch.init(address=self.address)
        self._connected = True
        return self

    def wait_for_nodes(self, count: Optional[int] = None, timeout: float = 10):
        """Block until GCS sees ``count`` (default: all started) alive nodes."""
        from ray_tpu_torch.core.gcs import GcsClient

        want = count if count is not None else len(self.nodes)
        cli = GcsClient(self.address)
        try:
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                alive = [n for n in cli.nodes() if n["alive"]]
                if len(alive) >= want:
                    return True
                time.sleep(0.05)
            raise TimeoutError(
                f"only {len(alive)} of {want} nodes registered")
        finally:
            cli.close()

    def shutdown(self):
        import ray_tpu_torch

        if self._connected:
            try:
                ray_tpu_torch.shutdown()
            except Exception:  # noqa: BLE001
                pass
            self._connected = False
        for node in list(self.nodes):
            try:
                self.remove_node(node, allow_graceful=True)
            except Exception:  # noqa: BLE001
                try:
                    node.proc.kill()
                except OSError:
                    pass
        if self._gcs_proc.poll() is None:
            self._gcs_proc.terminate()
            try:
                self._gcs_proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._gcs_proc.kill()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
