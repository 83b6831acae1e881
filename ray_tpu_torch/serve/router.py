"""DeploymentHandle — routes requests to replicas, power-of-two-choices.

Reference analogues: `python/ray/serve/handle.py:86` (``RayServeHandle``),
`serve/_private/router.py:244` (``PowerOfTwoChoicesReplicaScheduler``:
sample two replicas, probe queue lengths, pick the shorter queue —
`:639,856`).  Config PUSH: a background listener long-polls the controller
(`listen_for_change`, the `_private/long_poll.py:187` analogue), so a
redeploy updates every handle the moment the routing version bumps — no
staleness window.
"""

from __future__ import annotations

import random
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import ray_tpu_torch.serve.replica  # noqa: F401 — defines serve_backpressure
from ray_tpu_torch.core.config import config
from ray_tpu_torch.serve.controller import CONTROLLER_NAME, NAMESPACE

config.define("serve_probe_timeout_s", float, 1.0,
              "Queue-length probe timeout on the request routing path.  "
              "Was 5 s: a dead or partitioned replica then stalled every "
              "request that sampled it for the full window; with "
              "suspicion-based liveness a short probe plus immediate "
              "local exclusion re-picks in about a second worst-case.")
config.define("serve_reject_retry_budget", int, 3,
              "Per-request retry budget when a replica rejects with "
              "BackPressureError (max_ongoing_requests admission): the "
              "router re-picks another replica up to this many times "
              "(jittered backoff between attempts) before shedding the "
              "request — HTTP 503 + Retry-After on the proxy.")


class _DeploymentRouting:
    """Process-wide routing cache for ONE deployment, fed by a single
    long-poll listener thread — every DeploymentHandle (and every
    ``.options()`` copy) shares it, so N handles cost one parked
    ``listen_for_change`` call on the controller, not N."""

    def __init__(self, deployment: str):
        self.deployment = deployment
        self.lock = threading.Lock()
        self.replicas: List[Any] = []
        self.fetched = False
        self.version = -1
        self.request_timeout_s: Optional[float] = None
        self.max_ongoing = 0  # guard: lock
        # Router-side in-flight count per replica (reference: the Serve
        # router tracks its own per-replica in-flight and never
        # over-dispatches): ``call()`` claims a slot BEFORE submitting,
        # so an overloaded deployment rejects at the router in
        # microseconds instead of the request queueing replica-side.
        self.inflight: Dict[Any, int] = {}  # guard: lock
        self._listener: Optional[threading.Thread] = None

    def _controller(self):
        import ray_tpu_torch

        return ray_tpu_torch.get_actor(CONTROLLER_NAME, namespace=NAMESPACE)

    def apply(self, routing: dict):
        import ray_tpu_torch

        entry = routing["deployments"].get(self.deployment)
        if entry is None:
            raise ValueError(f"no deployment named {self.deployment!r}")
        handles = [ray_tpu_torch.get_actor(n, namespace=NAMESPACE)
                   for n in entry["replicas"]]
        with self.lock:
            self.replicas = handles
            self.fetched = True
            self.version = routing["version"]
            self.request_timeout_s = entry.get("request_timeout_s")
            self.max_ongoing = int(entry.get("max_ongoing_requests") or 0)

    def refresh(self, force: bool = False):
        import ray_tpu_torch

        with self.lock:
            if not force and self.fetched:
                return
        self.apply(
            ray_tpu_torch.get(self._controller().get_routing.remote(), timeout=10))
        self.ensure_listener()

    def ensure_listener(self):
        with self.lock:
            if self._listener is not None and self._listener.is_alive():
                return
            self._listener = threading.Thread(
                target=self._listen_loop, name=f"serve-lp-{self.deployment}",
                daemon=True)
            self._listener.start()

    def _listen_loop(self):
        """Push channel: parked on the controller until the routing version
        moves; an idle timeout just re-issues the poll."""
        import ray_tpu_torch

        while True:
            try:
                routing = ray_tpu_torch.get(
                    self._controller().listen_for_change.remote(
                        self.version, 30.0),
                    timeout=45)
                if routing["deployments"].get(self.deployment) is None:
                    with _routing_lock:
                        _routing.pop(self.deployment, None)
                    _prune_affinity(self.deployment)
                    return  # deployment deleted: stop listening
                self.apply(routing)
            except Exception:  # noqa: BLE001 controller restart/teardown
                time.sleep(0.2)
                try:
                    self._controller()
                except Exception:  # noqa: BLE001 serve is gone
                    with _routing_lock:
                        _routing.pop(self.deployment, None)
                    return


_routing: dict = {}
_routing_lock = threading.Lock()

#: Short-TTL cache of cluster liveness for the routing hot path: node ids
#: that are SUSPECT (missed heartbeats, probe pending) or dead.  Replicas
#: hosted there are excluded from picks immediately — routing around a
#: suspect costs nothing, while probing into one costs a timeout.
_unhealthy_nodes_cache: dict = {"at": 0.0, "nodes": frozenset()}
_unhealthy_nodes_lock = threading.Lock()
_UNHEALTHY_TTL_S = 1.0


def _unhealthy_nodes() -> frozenset:
    now = time.monotonic()
    with _unhealthy_nodes_lock:
        if now - _unhealthy_nodes_cache["at"] < _UNHEALTHY_TTL_S:
            return _unhealthy_nodes_cache["nodes"]
        _unhealthy_nodes_cache["at"] = now  # claim the refresh window
    try:
        from ray_tpu_torch.core.worker import global_worker

        nodes = frozenset(
            n["node_id"] for n in global_worker().gcs_nodes()
            if not n.get("alive", True) or n.get("suspect")
            or n.get("draining"))
    except Exception:  # noqa: BLE001 — liveness view is best-effort
        nodes = frozenset()
    with _unhealthy_nodes_lock:
        _unhealthy_nodes_cache["nodes"] = nodes
    return nodes


def _replica_nodes(replicas) -> dict:
    """Map replica handle -> hosting node id via the actor table (one GCS
    round trip, only consulted when some node is unhealthy)."""
    try:
        from ray_tpu_torch.core.worker import global_worker

        w = global_worker()
        if w.mode == "driver":
            table = w.raylet.gcs.list_actors()
        elif w.mode == "client":
            table = w.gcs.list_actors()
        elif w.mode == "worker":
            table = w._request("gcs_list_actors")
        else:
            return {}
        by_id = {a["actor_id"]: a.get("exec_node") or a.get("owner_node")
                 for a in table}
        return {r: by_id.get(r._actor_id.hex()) for r in replicas}
    except Exception:  # noqa: BLE001
        return {}


def _routing_for(deployment: str) -> _DeploymentRouting:
    with _routing_lock:
        entry = _routing.get(deployment)
        if entry is None:
            entry = _routing[deployment] = _DeploymentRouting(deployment)
        return entry


#: (deployment, model_id) -> replica handle that served it last.  Model
#: affinity for multiplexed deployments (reference: the router's
#: multiplexed-model-id replica ranking): repeat requests for the same
#: model prefer the replica that already has it loaded.  Bounded LRU: a
#: rotating model-id space must not grow process memory forever.
_model_affinity: "OrderedDict" = OrderedDict()
_model_affinity_lock = threading.Lock()
_MODEL_AFFINITY_CAP = 4096
#: replica -> (queue_len, ts): short-TTL cache of the affinity probe so the
#: multiplexed hot path doesn't pay a round trip per request
_affinity_probe_cache: "OrderedDict" = OrderedDict()
_AFFINITY_PROBE_TTL_S = 1.0


def _prune_affinity(deployment: str):
    """Drop every affinity entry of a deleted deployment — entries (and
    their dead replica handles) would otherwise accumulate forever across
    deploy/delete cycles."""
    with _model_affinity_lock:
        for key in [k for k in _model_affinity if k[0] == deployment]:
            del _model_affinity[key]


class DeploymentHandle:
    def __init__(self, deployment_name: str, method_name: str = "__call__",
                 stream: bool = False, multiplexed_model_id: str = ""):
        self._deployment = deployment_name
        self._method = method_name
        self._stream = stream
        self._model_id = multiplexed_model_id

    # ------------------------------------------------------------- plumbing

    @property
    def _routing(self) -> _DeploymentRouting:
        return _routing_for(self._deployment)

    def _refresh(self, force: bool = False):
        self._routing.refresh(force)

    def _exclude_replicas(self, bad: List[Any]):
        """Drop failed replicas from the SHARED routing table immediately
        — every handle of this deployment skips them until the next
        controller push re-asserts membership."""
        if not bad:
            return
        routing = self._routing
        with routing.lock:
            routing.replicas = [r for r in routing.replicas
                                if r not in bad]

    def _live_replicas(self):
        """Current replica set minus SUSPECT/dead/draining hosts.  The
        liveness filter is advisory: when it would empty the set (every
        host suspect — likely a detector blip) the unfiltered set wins,
        availability over purity."""
        routing = self._routing
        self._refresh()
        with routing.lock:
            replicas = list(routing.replicas)
        deadline = time.time() + 30.0
        while not replicas:
            if time.time() > deadline:
                raise RuntimeError(
                    f"deployment {self._deployment!r} has no ready replicas")
            time.sleep(0.1)
            self._refresh(force=True)
            with routing.lock:
                replicas = list(routing.replicas)
        unhealthy = _unhealthy_nodes()
        if unhealthy:
            hosts = _replica_nodes(replicas)
            healthy = [r for r in replicas
                       if hosts.get(r) not in unhealthy]
            if healthy:
                return healthy
        return replicas

    def _pick_replica(self):
        """Power-of-two-choices (reference `router.py:639`): sample two,
        probe in-flight counts, route to the less loaded.  Probes are
        SHORT (serve_probe_timeout_s, default 1 s — was a routing-stalling
        5 s) and a probe failure excludes the replica from the shared
        routing table immediately before re-picking; replicas on SUSPECT
        hosts are never sampled in the first place."""
        import ray_tpu_torch

        timeout = max(0.1, config.serve_probe_timeout_s)
        for _attempt in range(3):
            replicas = self._live_replicas()
            if len(replicas) == 1:
                a, b = replicas[0], None
            else:
                a, b = random.sample(replicas, 2)
            pair = [a] if b is None else [a, b]
            refs = [r.get_queue_len.remote() for r in pair]
            try:
                if b is None:
                    ray_tpu_torch.get(refs[0], timeout=timeout)
                    return a
                qa, qb = ray_tpu_torch.get(refs, timeout=timeout)
                return a if qa <= qb else b
            except Exception:  # noqa: BLE001 — dead/stale/stalled replica
                # Identify the failure (the batched get hides which ref
                # errored): anything not resolved within a grace beat is
                # treated as dead and excluded NOW — later controller
                # pushes re-add survivors.
                done, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                       timeout=0.2)
                bad = []
                for r, ref in zip(pair, refs):
                    if ref not in done:
                        bad.append(r)
                        continue
                    try:
                        ray_tpu_torch.get(ref, timeout=0.1)
                    except Exception:  # noqa: BLE001
                        bad.append(r)
                # NOT followed by a forced refresh: a refetch would just
                # re-add the corpse from the controller's not-yet-updated
                # table — the exclusion stands until the next controller
                # PUSH re-asserts membership (and _live_replicas force-
                # refreshes on its own if the set empties).  An empty
                # ``bad`` means every probe resolved fine, just late
                # (loaded-but-healthy replicas): retry without evicting.
                self._exclude_replicas(bad)
        # three strikes: hand out an unprobed member rather than failing —
        # the call itself surfaces the error if the replica is truly gone
        replicas = self._live_replicas()
        return random.choice(replicas)

    # ------------------------------------------------------------- calling

    def _pick_replica_affine(self):
        """Model affinity: prefer the replica that last served this model
        (it has the model in its LRU) unless it is heavily loaded relative
        to a power-of-two alternative.

        The affinity probe is cached (~1s TTL) and short-timeout: the
        reference pushes loaded-model ids to the router instead of probing,
        so a per-request synchronous 5s probe on the hot path — blocking
        a full 5s whenever the cached replica just died — was the wrong
        trade.  A stale-but-fresh queue length only risks a slightly
        suboptimal pick; a dead replica costs at most 0.5s once per TTL."""
        import ray_tpu_torch

        key = (self._deployment, self._model_id)
        with _model_affinity_lock:
            cached = _model_affinity.get(key)
            if cached is not None:
                _model_affinity.move_to_end(key)
        routing = self._routing
        self._refresh()
        with routing.lock:
            alive = set(routing.replicas)
        if cached is not None and cached in alive:
            now = time.time()
            with _model_affinity_lock:
                probe = _affinity_probe_cache.get(cached)
            if probe is not None and now - probe[1] < _AFFINITY_PROBE_TTL_S:
                if probe[0] <= 4:
                    return cached
            else:
                try:
                    q = ray_tpu_torch.get(cached.get_queue_len.remote(),
                                    timeout=0.5)
                    with _model_affinity_lock:
                        _affinity_probe_cache[cached] = (q, now)
                        while len(_affinity_probe_cache) > \
                                _MODEL_AFFINITY_CAP:
                            _affinity_probe_cache.popitem(last=False)
                    if q <= 4:  # loaded-model locality beats a cold load
                        return cached
                except Exception:  # noqa: BLE001 — replica gone
                    pass
        replica = self._pick_replica()
        with _model_affinity_lock:
            _model_affinity[key] = replica
            while len(_model_affinity) > _MODEL_AFFINITY_CAP:
                _model_affinity.popitem(last=False)
        return replica

    def remote(self, request: Any = None, _replica: Any = None,
               _counted: bool = False):
        """Dispatch; returns an ObjectRef (resolve with ray_tpu_torch.get), or an
        ObjectRefGenerator when the handle has ``stream=True``."""
        from ray_tpu_torch.serve.telemetry import serve_metrics
        from ray_tpu_torch.util import tracing

        if not _counted:
            # offered-load series (call() already counted its request —
            # including attempts that shed before ever dispatching)
            serve_metrics()["requests"].inc(
                tags={"deployment": self._deployment})
        if not tracing.tracing_enabled():
            return self._remote_inner(request, _replica)
        # router→replica hop: the serve request's root span (or a child,
        # when the handle call itself runs inside a traced request) —
        # replica pick + probes + the actor-call submit all parent here,
        # so the routing cost is visible next to replica execution time
        with tracing.span(f"serve.route {self._deployment}",
                          method=self._method, stream=self._stream):
            return self._remote_inner(request, _replica)

    def _remote_inner(self, request: Any, _replica: Any = None):
        if _replica is not None:
            replica = _replica  # slot-claimed by call() — must dispatch
            # to the replica the slot was charged to, or the inflight map
            # drifts from real placement
        elif self._model_id:
            replica = self._pick_replica_affine()
        else:
            replica = self._pick_replica()
        # Deadline stamp (Serve request_timeout_s): the replica call — and
        # everything it fans out to — inherits an absolute deadline;
        # expiry anywhere sheds/interrupts instead of running on forever.
        timeout_s = self._routing.request_timeout_s
        if self._stream:
            method = replica.handle_request_stream.options(
                num_returns="streaming")
            if timeout_s is not None and config.deadlines:
                method = method.options(deadline_s=timeout_s)
            return method.remote(request, self._method, self._model_id)
        method = replica.handle_request
        if timeout_s is not None and config.deadlines:
            method = method.options(deadline_s=timeout_s)
        return method.remote(request, self._method, self._model_id)

    def _acquire_slot(self):
        """Router-side admission: claim the least-loaded live replica
        still below ``max_ongoing_requests`` AS COUNTED BY THIS ROUTER
        (reference: the Serve router tracks per-replica in-flight and
        never over-dispatches).  Returns the claimed replica, None when
        every replica is full (caller backs off / sheds — the request
        never queues replica-side, which is what keeps admitted p99
        bounded under overload), or the sentinel False when admission is
        unenforced (no cap / kill switch) and the caller should use the
        legacy probe-based pick."""
        routing = self._routing
        self._refresh()
        with routing.lock:
            cap = routing.max_ongoing
        if cap <= 0 or not config.serve_backpressure or self._model_id:
            # unenforced (no cap / kill switch), or a multiplexed request
            # — model affinity picks its own replica, so a slot charged
            # to the least-loaded one would just drift the inflight map;
            # multiplexed calls rely on the replica-side gate
            return False
        replicas = self._live_replicas()
        # NOT pruned against the live set: a probe-suspected replica's
        # in-flight work is still running — resetting its count to zero
        # on recovery would over-admit; entries self-clean because every
        # claim's finally releases (pop at count<=1)
        with routing.lock:
            if not replicas:
                return None
            count, _, best = min(
                (routing.inflight.get(r, 0), i, r)
                for i, r in enumerate(replicas))
            if count >= cap:
                return None
            routing.inflight[best] = count + 1
        return best

    def _release_slot(self, replica):
        routing = self._routing
        with routing.lock:
            count = routing.inflight.get(replica, 0)
            if count > 1:
                routing.inflight[replica] = count - 1
            else:
                routing.inflight.pop(replica, None)

    def call(self, request: Any = None, timeout: Optional[float] = None):
        """Submit AND resolve, under router-side admission: a slot on the
        least-loaded replica is claimed BEFORE submitting (so an
        overloaded deployment rejects in microseconds at the router —
        the request never sits in a replica queue inflating its
        latency), re-tried under a per-request budget (jittered backoff
        from ``util/retry.py``, short — the wait is for an in-flight
        request to finish); when every attempt finds all replicas full —
        the deployment is saturated — the request is SHED with a typed
        ``BackPressureError`` (HTTP proxy: 503 + Retry-After).  The
        replica-side ``max_ongoing_requests`` check stays as the
        authoritative gate (other routers/drivers race this one); plain
        ``.remote()`` callers observe those rejects at ``get()``."""
        import ray_tpu_torch
        from ray_tpu_torch.core.exceptions import BackPressureError
        from ray_tpu_torch.serve.telemetry import serve_metrics
        from ray_tpu_torch.util.retry import BackoffPolicy

        m = serve_metrics()
        tags = {"deployment": self._deployment}
        m["requests"].inc(tags=tags)
        t_start = time.perf_counter()
        budget = max(0, config.serve_reject_retry_budget)
        backoff = BackoffPolicy(base_s=0.01, max_s=0.25)
        last: Optional[BackPressureError] = None
        for attempt in range(budget + 1):
            if attempt:
                m["retries"].inc(tags=tags)
                time.sleep(backoff.delay(attempt - 1))
            slot = self._acquire_slot()
            if slot is None:
                last = BackPressureError(
                    f"all replicas of {self._deployment!r} at "
                    f"max_ongoing_requests")
                continue
            m["admitted"].inc(tags=tags)
            try:
                result = ray_tpu_torch.get(
                    self.remote(request, _replica=slot or None,
                                _counted=True),
                    timeout=timeout)
                m["latency"].observe(time.perf_counter() - t_start,
                                     tags=tags)
                return result
            except BackPressureError as e:
                last = e  # replica-side race (another router's traffic)
            finally:
                if slot is not False:
                    self._release_slot(slot)
        m["shed"].inc(tags=tags)
        raise BackPressureError(
            f"deployment {self._deployment!r} saturated: "
            f"{budget + 1} attempts all rejected ({last})")

    def options(self, method_name: Optional[str] = None,
                stream: Optional[bool] = None,
                multiplexed_model_id: Optional[str] = None,
                ) -> "DeploymentHandle":
        return DeploymentHandle(
            self._deployment,
            self._method if method_name is None else method_name,
            self._stream if stream is None else stream,
            self._model_id if multiplexed_model_id is None
            else multiplexed_model_id)

    @property
    def method(self):
        """``handle.method.<name>.remote(x)`` sugar."""
        return _MethodNamespace(self)

    def __reduce__(self):
        return (DeploymentHandle, (self._deployment, self._method,
                                   self._stream, self._model_id))

    def __repr__(self):
        return f"DeploymentHandle({self._deployment!r})"


class _MethodNamespace:
    def __init__(self, handle: DeploymentHandle):
        self._handle = handle

    def __getattr__(self, name):
        return DeploymentHandle(self._handle._deployment, name)
