"""ServeController — reconciles desired deployment state onto replicas.

Reference analogues: `python/ray/serve/controller.py:74`
(``ServeController`` + ``deploy_apps :587``),
`serve/_private/deployment_state.py` (replica reconciliation),
`serve/_private/autoscaling_policy.py:95` (``BasicAutoscalingPolicy`` —
queue-depth driven replica targets).

One named controller actor per runtime.  A background thread ticks
reconcile + autoscale; public methods mutate desired state under a lock.
Replicas are named actors (``SERVE_REPLICA::<deployment>#<uid>``) so
routers resolve them by name without shipping handles.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional

CONTROLLER_NAME = "SERVE_CONTROLLER"
NAMESPACE = "serve"
RECONCILE_INTERVAL_S = 0.25
_MAX_START_FAILURES = 3


def replica_actor_name(deployment: str, uid: int) -> str:
    return f"SERVE_REPLICA::{deployment}#{uid}"


class _ReplicaState:
    def __init__(self, name: str, handle, uid: int):
        self.name = name
        self.handle = handle
        self.uid = uid
        self.ready = False
        self.ready_ref = None
        self.health_ref = None  # outstanding liveness probe
        self.dead = False
        # rolling redeploy: old-version replicas keep serving until the new
        # ones are ready, then drain (killed once idle or after timeout)
        self.draining = False
        self.drain_since = None
        self.drain_probe = None


class _DeploymentState:
    def __init__(self, spec: dict):
        self.spec = spec
        self.replicas: List[_ReplicaState] = []
        self.next_uid = 0
        self.target = spec["num_replicas"]
        # autoscaler bookkeeping
        self.ongoing_ema = 0.0
        self.over_since: Optional[float] = None
        self.under_since: Optional[float] = None
        self.version = 0
        # consecutive replica-start failures; at _MAX_START_FAILURES the
        # deployment is marked unhealthy instead of respawn-looping
        self.start_failures = 0
        self.unhealthy_reason: Optional[str] = None
        self.flip_at: Optional[float] = None  # rollout traffic-flip time


class ServeController:
    def __init__(self):
        self._lock = threading.RLock()
        # long-poll listeners wake on every routing-version bump
        # (reference: LongPollHost, `serve/_private/long_poll.py:187`)
        self._change = threading.Condition(self._lock)
        self._deployments: Dict[str, _DeploymentState] = {}
        self._routes: Dict[str, str] = {}  # route_prefix -> deployment name
        self._version = 0
        self._shutdown = False
        self._thread = threading.Thread(target=self._control_loop,
                                        name="serve-controller",
                                        daemon=True)
        self._thread.start()

    # --------------------------------------------------------------- deploy

    def deploy(self, specs: List[dict]):
        """specs: [{name, deployment_def(blob), init_args, init_kwargs,
        num_replicas, max_ongoing_requests, user_config, route_prefix,
        autoscaling_config}]"""
        with self._lock:
            for spec in specs:
                name = spec["name"]
                existing = self._deployments.get(name)
                if existing is not None:
                    # In-place ROLLING update (reference: deployment_state
                    # rolling replica replacement): old replicas keep
                    # serving until new-version replicas are ready, then
                    # drain — requests never hit a just-killed replica and
                    # there is no empty-replica window.
                    existing.spec = spec
                    existing.target = self._initial_target(spec)
                    existing.flip_at = None
                    now = time.time()
                    for r in existing.replicas:
                        if not r.draining:
                            r.draining = True
                            r.drain_since = now
                    existing.version += 1
                else:
                    st = _DeploymentState(spec)
                    st.target = self._initial_target(spec)
                    self._deployments[name] = st
                if spec.get("route_prefix"):
                    self._routes[spec["route_prefix"]] = name
            self._version += 1
            self._change.notify_all()
        self._reconcile()
        return True

    def _initial_target(self, spec) -> int:
        ac = spec.get("autoscaling_config")
        if ac:
            return max(ac.get("min_replicas", 1),
                       min(spec["num_replicas"], ac.get("max_replicas", 1)))
        return spec["num_replicas"]

    def delete_deployment(self, name: str):
        with self._lock:
            st = self._deployments.pop(name, None)
            if st is None:
                return False
            for r in st.replicas:
                self._kill_replica(r)
            self._routes = {p: d for p, d in self._routes.items()
                            if d != name}
            self._version += 1
            self._change.notify_all()
        return True

    def shutdown(self):
        with self._lock:
            self._shutdown = True
            for st in self._deployments.values():
                for r in st.replicas:
                    self._kill_replica(r)
            self._deployments.clear()
            self._routes.clear()
        return True

    # --------------------------------------------------------------- queries

    def get_routing(self) -> dict:
        """Routing table for handles/proxies: deployment -> replica actor
        names (ready only), plus route prefixes and a version counter."""
        with self._lock:
            return {
                "version": self._version,
                "deployments": {
                    name: {
                        "replicas": self._serving_replica_names(st),
                        "max_ongoing_requests":
                            st.spec.get("max_ongoing_requests", 100),
                        "request_timeout_s":
                            st.spec.get("request_timeout_s"),
                    }
                    for name, st in self._deployments.items()
                },
                "routes": dict(self._routes),
            }

    def listen_for_change(self, known_version: int,
                          timeout: float = 30.0) -> dict:
        """Long-poll (reference: `serve/_private/long_poll.py:187`): block
        until the routing version moves past ``known_version`` (or the
        idle timeout lapses — the client just re-issues), then return the
        fresh routing table.  Handles learn of redeploys the instant they
        land instead of on a poll interval."""
        deadline = time.time() + timeout
        with self._change:
            while self._version == known_version and not self._shutdown:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                self._change.wait(remaining)
        return self.get_routing()

    def _serving_replica_names(self, st) -> list:
        # Blue/green flip: traffic moves to the new version only when its
        # FULL replica set is ready — a partial flip would funnel all
        # traffic through the first fresh replica while the rest start.
        fresh = [r.name for r in st.replicas
                 if r.ready and not r.dead and not r.draining]
        if len(fresh) >= st.target:
            return fresh
        # mid-rollout: the old version serves until the new one is up
        old = [r.name for r in st.replicas
               if r.ready and not r.dead and r.draining]
        return old if old else fresh

    def status(self) -> dict:
        with self._lock:
            return {
                name: {
                    "target": st.target,
                    "running": sum(1 for r in st.replicas
                                   if r.ready and not r.dead),
                    "starting": sum(1 for r in st.replicas if not r.ready),
                    "version": st.version,
                    "unhealthy": st.unhealthy_reason,
                }
                for name, st in self._deployments.items()
            }

    def wait_ready(self, name: str, timeout: float = 60.0) -> bool:
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                st = self._deployments.get(name)
                if st is not None and st.unhealthy_reason is not None:
                    raise RuntimeError(
                        f"deployment {name!r} unhealthy: "
                        f"{st.unhealthy_reason}")
                if st is not None and st.target >= 1 and \
                        sum(1 for r in st.replicas if r.ready
                            and not r.dead and not r.draining) >= st.target:
                    return True
            time.sleep(0.05)
        return False

    # --------------------------------------------------------------- loop

    def _control_loop(self):
        tick = 0
        while not self._shutdown:
            try:
                self._reconcile()
                self._autoscale()
                if tick % 4 == 0:  # ~1s cadence
                    self._health_check()
            except Exception:  # noqa: BLE001 - keep the loop alive
                pass
            tick += 1
            time.sleep(RECONCILE_INTERVAL_S)

    def _health_check(self):
        """Probe ready replicas; mark the dead for reaping (reference:
        deployment_state health checks each tick).  Probes are
        fire-and-collect — never block the control loop on a replica."""
        import ray_tpu_torch

        with self._lock:
            replicas = [r for st in self._deployments.values()
                        for r in st.replicas if r.ready and not r.dead]
        for r in replicas:
            if r.health_ref is None:
                r.health_ref = r.handle.check_health.remote()
                continue
            ready, _ = ray_tpu_torch.wait([r.health_ref], num_returns=1, timeout=0)
            if not ready:
                continue  # busy replica; collect next pass
            try:
                ray_tpu_torch.get(r.health_ref, timeout=1)
            except Exception:  # noqa: BLE001 - actor died
                r.dead = True
            r.health_ref = None

    def _reconcile(self):
        import ray_tpu_torch
        from ray_tpu_torch.serve.replica import Replica

        with self._lock:
            if self._shutdown:
                return
            for name, st in self._deployments.items():
                # mark started replicas ready — a resolved ready_ref can be
                # an ERROR (constructor raised): wait() reports errored
                # objects as "ready", so the get() is what distinguishes a
                # live replica from a dead one.
                for r in list(st.replicas):
                    if not r.ready and r.ready_ref is not None:
                        ready, _ = ray_tpu_torch.wait([r.ready_ref], num_returns=1,
                                                timeout=0)
                        if not ready:
                            continue
                        try:
                            ray_tpu_torch.get(r.ready_ref, timeout=1)
                        except Exception as e:  # noqa: BLE001
                            st.replicas.remove(r)
                            self._kill_replica(r)
                            st.start_failures += 1
                            if st.start_failures >= _MAX_START_FAILURES:
                                st.unhealthy_reason = (
                                    f"replica failed to start "
                                    f"{st.start_failures}x: {e!r}")
                            self._version += 1
                            self._change.notify_all()
                            continue
                        r.ready = True
                        r.ready_ref = None
                        st.start_failures = 0
                        st.unhealthy_reason = None
                        self._version += 1
                        self._change.notify_all()
                # reap ready replicas that died after startup (health probe
                # issued by _health_check; a dead actor errors its calls)
                for r in list(st.replicas):
                    if r.ready and getattr(r, "dead", False):
                        st.replicas.remove(r)
                        self._version += 1
                        self._change.notify_all()
                # drain old-version replicas once the new version serves
                self._reap_draining(st)
                # scale up (draining replicas don't count toward target)
                spec = st.spec
                if st.unhealthy_reason is not None:
                    continue
                active = [r for r in st.replicas if not r.draining]
                while len(active) < st.target:
                    uid = st.next_uid
                    st.next_uid += 1
                    actor_name = replica_actor_name(name, uid)
                    res = dict(spec.get("ray_actor_options") or {})
                    cls = ray_tpu_torch.remote(
                        num_cpus=res.get("num_cpus", 1),
                        num_tpus=res.get("num_tpus", 0),
                        max_concurrency=max(
                            spec.get("max_ongoing_requests", 100), 8) + 4,
                        name=actor_name, namespace=NAMESPACE,
                    )(Replica)
                    handle = cls.remote(
                        spec["deployment_def"], spec.get("init_args") or (),
                        spec.get("init_kwargs") or {},
                        spec.get("user_config"),
                        # the replica enforces this by REJECTING beyond it
                        # (typed BackPressureError; router retries/sheds)
                        spec.get("max_ongoing_requests", 100),
                        deployment_name=name, replica_name=actor_name,
                    )
                    r = _ReplicaState(actor_name, handle, uid)
                    r.ready_ref = handle.check_health.remote()
                    st.replicas.append(r)
                    active.append(r)
                # scale down (newest-first, reference removes most recent)
                while len(active) > st.target:
                    victim = active.pop()
                    st.replicas.remove(victim)
                    self._kill_replica(victim)
                    self._version += 1
                    self._change.notify_all()

    def _reap_draining(self, st: "_DeploymentState"):
        """Kill draining replicas once (a) the new version is serving and
        (b) they are idle (queue probe == 0) or the drain grace expired.
        Runs under the controller lock."""
        import ray_tpu_torch

        draining = [r for r in st.replicas if r.draining]
        if not draining:
            return
        fresh_ready = sum(1 for r in st.replicas
                          if r.ready and not r.dead and not r.draining)
        if fresh_ready < st.target and st.target > 0:
            return  # old version still carries the traffic
        now = time.time()
        # moment traffic flipped to the new version: in-flight picks made
        # against the old routing need a beat to land before any kill
        if st.flip_at is None:
            st.flip_at = now
        if now - st.flip_at < 0.75:
            return
        for r in draining:
            idle = False
            if r.dead:
                idle = True
            elif now - (r.drain_since or now) > 10.0:
                idle = True  # grace expired: force
            else:
                if r.drain_probe is None:
                    r.drain_probe = r.handle.get_queue_len.remote()
                else:
                    done, _ = ray_tpu_torch.wait([r.drain_probe], num_returns=1,
                                           timeout=0)
                    if done:
                        try:
                            idle = ray_tpu_torch.get(r.drain_probe, timeout=1) == 0
                        except Exception:  # noqa: BLE001
                            idle = True  # already dead
                        r.drain_probe = None
            if idle:
                st.replicas.remove(r)
                self._kill_replica(r)
                self._version += 1
                self._change.notify_all()

    def _kill_replica(self, r: _ReplicaState):
        import ray_tpu_torch

        try:
            ray_tpu_torch.kill(r.handle)
        except Exception:  # noqa: BLE001
            pass

    def _autoscale(self):
        import ray_tpu_torch

        # Snapshot replica lists AND the state generation under the lock:
        # deploy()/delete_deployment() run concurrently on other actor
        # threads and clear/replace st.replicas; the EMA/target update
        # below is skipped if the deployment changed underneath us.
        with self._lock:
            states = [(name, st, [r for r in st.replicas if r.ready
                                  and not r.dead and not r.draining],
                       st.version)
                      for name, st in self._deployments.items()]
        for name, st, ready, version in states:
            ac = st.spec.get("autoscaling_config")
            if not ac:
                continue
            if not ready:
                continue
            # probe in-flight counts (best effort, short timeout)
            total = 0
            probes = [(r, r.handle.get_queue_len.remote()) for r in ready]
            for r, ref in probes:
                try:
                    total += ray_tpu_torch.get(ref, timeout=1.0)
                except Exception:  # noqa: BLE001
                    pass
            now = time.time()
            with self._lock:
                if (self._deployments.get(name) is not st
                        or st.version != version):
                    continue  # redeployed/deleted mid-probe: stale sample
                alpha = ac.get("smoothing_factor", 0.6)
                st.ongoing_ema = alpha * total + (1 - alpha) * st.ongoing_ema
                target_per = ac.get("target_ongoing_requests", 1.0)
                desired = math.ceil(st.ongoing_ema / max(target_per, 1e-9))
                desired = max(ac.get("min_replicas", 1),
                              min(ac.get("max_replicas", 1), desired))
                if desired > st.target:
                    st.under_since = None
                    if st.over_since is None:
                        st.over_since = now
                    if now - st.over_since >= ac.get("upscale_delay_s", 0.0):
                        st.target = desired
                        st.over_since = None
                elif desired < st.target:
                    st.over_since = None
                    if st.under_since is None:
                        st.under_since = now
                    if now - st.under_since >= ac.get(
                            "downscale_delay_s", 2.0):
                        st.target = desired
                        st.under_since = None
                else:
                    st.over_since = st.under_since = None
