"""ClientWorker — a driver connected to a cluster over TCP.

Reference analogue: a driver's ``CoreWorker`` connecting to its local raylet
(`python/ray/_private/worker.py:2020` → `ConnectToRaylet`,
`src/ray/core_worker/core_worker.h:313`) — here the driver speaks the same
framed request protocol the workers use, to the raylet's TCP listener, and
holds a ``GcsClient`` for cluster-level queries.  When the raylet is on the
same host the driver attaches its shm store for zero-copy gets; otherwise
large objects would need a socket fetch (not yet wired — same-host only).
"""

from __future__ import annotations

import socket
import sys
import threading
import time
from typing import Dict, Optional

from ray_tpu_torch.core import protocol
from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.gcs import GcsClient
from ray_tpu_torch.core.object_store import ShmObjectStore
from ray_tpu_torch.core.worker import Worker
from ray_tpu_torch.util.locks import make_lock
from ray_tpu_torch.util.retry import BackoffPolicy

config.define("gcs_client_reconnect_attempts", int, 4,
              "Driver-side GCS reconnect: how many re-dial attempts a "
              "GCS op gets after its connection drops (a GCS restart "
              "leaves the old socket dead while the service comes back), "
              "spaced by the jittered RAY_TPU_RETRY_BACKOFF_* policy so "
              "many drivers don't re-dial a restarting GCS in lockstep.")


class ClientWorker(Worker):
    """Driver-side connection to a raylet over TCP ("client" mode)."""

    def __init__(self, gcs_address: str, node_id: Optional[str] = None,
                 log_to_driver: bool = True):
        super().__init__("client")
        self.log_to_driver = log_to_driver
        self._gcs_address = gcs_address
        self.gcs = GcsClient(gcs_address)
        nodes = [n for n in self.gcs.nodes() if n["alive"] and n["address"]]
        if not nodes:
            raise ConnectionError(f"no alive nodes registered at {gcs_address}")
        if node_id is not None:
            nodes = [n for n in nodes if n["node_id"] == node_id]
            if not nodes:
                raise ValueError(f"node {node_id} not found/alive")
        # prefer a raylet on this host (store attach works there)
        hostname = socket.gethostname()
        nodes.sort(key=lambda n: (n.get("hostname") != hostname,))
        info = nodes[0]
        host, port = info["address"]
        self.sock = socket.create_connection((host, port), timeout=10)
        self.sock.settimeout(None)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.send_lock = make_lock("client.send")
        self._rid = 0  # guard: _rid_lock
        self._rid_lock = make_lock("client.rid")
        self._pending: Dict[int, dict] = {}
        self._hello = threading.Event()
        self._hello_msg: Optional[dict] = None
        self._reader = threading.Thread(target=self._read_loop,
                                        name="client-reader", daemon=True)
        self._reader.start()
        self._send({"t": "driver_hello"})
        if not self._hello.wait(10):
            raise ConnectionError("raylet handshake timed out")
        self.node_id = self._hello_msg["node_id"]
        self.session_dir = self._hello_msg["session_dir"]
        store_path = self._hello_msg.get("store_path")
        if store_path:
            try:
                self.store = ShmObjectStore(store_path)
            except OSError:
                self.store = None  # different host: no shm access
        from ray_tpu_torch.util import profiling, tracing

        tracing.maybe_enable_from_env()
        if tracing.tracing_enabled():
            # ship this driver's spans (task.submit / task.get / serve
            # hops) to the raylet like a worker does — the raylet batches
            # them into the GCS trace table
            tracing.set_flush_target(
                lambda spans, dropped: self._send(
                    {"t": "spans", "spans": spans, "dropped": dropped}))
        # continuous profiling of the driver process: folded samples ride
        # the same worker route (raylet -> GCS profile table)
        profiling.ensure_profiler("driver")
        profiling.set_flush_target(
            lambda samples, dropped: self._send(
                {"t": "profile_samples", "samples": samples,
                 "dropped": dropped}))
        # metric time-series delta points ride it too (raylet -> GCS
        # metrics table); registered unconditionally — the per-process
        # flusher only runs once a metric is registered, and checks the
        # metrics_history flag itself
        from ray_tpu_torch.util import metrics as _metrics_mod

        _metrics_mod.set_points_target(
            lambda points, dropped: self._send(
                {"t": "metric_points", "points": points,
                 "dropped": dropped}))
        # Direct worker→worker transport (remote-driver caller side): the
        # raylet brokers actor addresses / worker leases over the request
        # protocol; direct_fence control frames arrive on the read loop.
        from ray_tpu_torch.core.config import config as _config

        if _config.direct_calls:
            from ray_tpu_torch.core.direct import DirectCallClient

            # broker/lease round trips are bounded like the in-process
            # driver's (.result(2.0)): a stalled raylet must cost the
            # submit path one timeout and a relayed fallback, never a
            # wedged burst
            self._direct = DirectCallClient(
                self,
                broker=lambda aid: self._request("direct_lookup",
                                                 actor_id=aid,
                                                 _wait_timeout=2.0),
                resubmit=self._submit_relayed,
                lease=lambda spec: self._request("direct_lease", spec=spec,
                                                 _wait_timeout=2.0),
                lease_release=lambda lid: self._request(
                    "direct_lease_release", lease_id=lid,
                    _wait_timeout=2.0),
            )

    # Worker.get/put/wait/submit use _send/_request like worker mode does.

    def _read_loop(self):
        reader = protocol.FrameReader(self.sock)
        while True:
            try:
                msg = reader.recv_msg()
            except (OSError, protocol.ProtocolError):
                msg = None
            if msg is None:
                err = ConnectionError("raylet connection lost")
                for entry in list(self._pending.values()):
                    entry["msg"] = {"ok": False, "error": err}
                    entry["event"].set()
                return
            t = msg.get("t")
            if t == "hello_reply":
                self._hello_msg = msg
                self._hello.set()
            elif t == "reply":
                entry = self._pending.pop(msg["rid"], None)
                if entry is not None:
                    entry["msg"] = msg
                    entry["event"].set()
            elif t == "direct_fence":
                if self._direct is not None:
                    self._direct.on_fence(msg)
            elif t == "log":
                # Worker stdout/stderr tailed by the raylet (reference: the
                # LogMonitor → driver console path, `log_monitor.py:102`).
                if self.log_to_driver:
                    prefix = (f"({msg.get('pid')}, "
                              f"node={str(msg.get('node_id'))[:8]}) ")
                    out = "".join(prefix + ln + "\n"
                                  for ln in msg.get("lines", ()))
                    try:
                        sys.stdout.write(out)
                        sys.stdout.flush()
                    except (OSError, ValueError):
                        pass

    def _send(self, msg):
        protocol.send_msg(self.sock, msg, self.send_lock)

    def _request(self, op, _wait_timeout=None, **fields):
        with self._rid_lock:
            self._rid += 1
            rid = self._rid
        entry = {"event": threading.Event(), "msg": None}
        self._pending[rid] = entry
        self._send({"t": "request", "rid": rid, "op": op, **fields})
        if not entry["event"].wait(_wait_timeout):
            self._pending.pop(rid, None)
            self._send({"t": "request", "rid": rid + (1 << 62),
                        "op": "cancel_request", "target_rid": rid})
            raise TimeoutError(f"request {op} timed out")
        msg = entry["msg"]
        if not msg["ok"]:
            raise msg["error"]
        return msg["value"]

    def _gcs_call(self, op, *args):
        """GCS ops with reconnect retries — after a GCS restart (fault
        tolerance) the old socket is dead but the service comes back
        within a few seconds.  Re-dials ride the unified jittered backoff
        policy: a fleet of drivers (or one driver fanning many threads
        into this path) spreads its re-dials instead of hammering the
        port the instant it reopens."""
        try:
            return getattr(self.gcs, op)(*args)
        except (ConnectionError, TimeoutError, OSError):
            pass
        policy = BackoffPolicy()
        attempts = max(1, config.gcs_client_reconnect_attempts)
        for attempt in range(attempts):
            try:
                new = GcsClient(self._gcs_address)
            except (ConnectionError, TimeoutError, OSError):
                if attempt == attempts - 1:
                    raise
                time.sleep(policy.delay(attempt))
                continue
            old, self.gcs = self.gcs, new
            try:
                old.close()
            except Exception:  # noqa: BLE001
                pass
            return getattr(self.gcs, op)(*args)

    def gcs_nodes(self):
        return self._gcs_call("nodes")

    def kv_put(self, key: bytes, value: bytes, namespace: str = ""):
        self._gcs_call("kv_put", namespace, key, value)

    def kv_get(self, key: bytes, namespace: str = ""):
        return self._gcs_call("kv_get", namespace, key)

    def kv_del(self, key: bytes, namespace: str = ""):
        return self._gcs_call("kv_del", namespace, key)

    def kv_keys(self, prefix: bytes, namespace: str = ""):
        return self._gcs_call("kv_keys", namespace, prefix)

    def _push_function(self, fid, blob: bytes):
        self._gcs_call("put_function", fid.binary(), blob)

    def shutdown(self):
        if self._direct is not None:
            self._direct.close()  # hand leases back before disconnecting
            self._direct = None
        try:
            self.sock.close()
        except OSError:
            pass
        try:
            self.gcs.close()
        except Exception:  # noqa: BLE001
            pass
        if self.store is not None:
            try:
                self.store.close()
            except Exception:  # noqa: BLE001
                pass
