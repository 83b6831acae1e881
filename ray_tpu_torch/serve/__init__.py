"""ray_tpu_torch.serve — model serving on replica actors.

Reference analogues: `python/ray/serve/api.py:414` (``serve.run``),
`api.py:242` (``@serve.deployment``), `serve/deployment.py:261`
(``Deployment.bind``).  Architecture: a named controller actor reconciles
deployments onto named replica actors (`ray_tpu_torch/serve/controller.py`);
handles route with power-of-two-choices (`router.py`); HTTP ingress is a
proxy actor (`http_proxy.py`); queue-depth autoscaling runs in the
controller's control loop.

Composition: a bound deployment passed as an init arg to another bind()
is deployed too and replaced with a DeploymentHandle (the reference's
deployment-graph behavior for the common one-level case).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch._vendor import cloudpickle

from ray_tpu_torch.serve.batching import batch, batch_sizes_of
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed
from ray_tpu_torch.serve.controller import CONTROLLER_NAME, NAMESPACE, ServeController
from ray_tpu_torch.serve.http_proxy import PROXY_NAME, HTTPProxy
from ray_tpu_torch.serve.router import DeploymentHandle

__all__ = [
    "deployment", "run", "start", "shutdown", "delete", "status",
    "get_deployment_handle", "get_app_handle", "Deployment", "Application",
    "AutoscalingConfig", "DeploymentHandle", "batch", "batch_sizes_of",
    "get_multiplexed_model_id", "multiplexed",
    "run_config",
]

_state_lock = threading.Lock()
_started = False
_http_port: Optional[int] = None


@dataclass
class AutoscalingConfig:
    """Reference analogue: `serve/config.py` AutoscalingConfig /
    `_private/autoscaling_policy.py:95`."""

    min_replicas: int = 1
    max_replicas: int = 1
    target_ongoing_requests: float = 1.0
    upscale_delay_s: float = 0.0
    downscale_delay_s: float = 2.0
    smoothing_factor: float = 0.6

    def to_dict(self) -> dict:
        return {
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "target_ongoing_requests": self.target_ongoing_requests,
            "upscale_delay_s": self.upscale_delay_s,
            "downscale_delay_s": self.downscale_delay_s,
            "smoothing_factor": self.smoothing_factor,
        }


@dataclass
class Deployment:
    """A deployable unit (reference: `serve/deployment.py`)."""

    func_or_class: Any
    name: str
    num_replicas: int = 1
    max_ongoing_requests: int = 100
    # End-to-end request deadline (reference: Serve request_timeout_s):
    # stamped as an absolute deadline on every replica call this
    # deployment serves — expiry anywhere in the pipeline sheds the work
    # and raises DeadlineExceededError at the caller (HTTP 504 on the
    # proxy).  None = no deadline.
    request_timeout_s: Optional[float] = None
    user_config: Optional[dict] = None
    autoscaling_config: Optional[AutoscalingConfig] = None
    ray_actor_options: Optional[dict] = None
    route_prefix: Optional[str] = None

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    def options(self, **overrides) -> "Deployment":
        import copy

        d = copy.copy(self)
        for k, v in overrides.items():
            if not hasattr(d, k):
                raise TypeError(f"unknown deployment option {k!r}")
            setattr(d, k, v)
        return d


@dataclass
class Application:
    deployment: Deployment
    init_args: tuple
    init_kwargs: dict


def deployment(_func_or_class=None, *, name: Optional[str] = None,
               num_replicas: int = 1, max_ongoing_requests: int = 100,
               request_timeout_s: Optional[float] = None,
               user_config: Optional[dict] = None,
               autoscaling_config: Optional[AutoscalingConfig] = None,
               ray_actor_options: Optional[dict] = None):
    """``@serve.deployment`` (reference: `serve/api.py:242`)."""

    def wrap(obj):
        if isinstance(autoscaling_config, dict):
            ac = AutoscalingConfig(**autoscaling_config)
        else:
            ac = autoscaling_config
        return Deployment(
            func_or_class=obj,
            name=name or getattr(obj, "__name__", "deployment"),
            num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            request_timeout_s=request_timeout_s,
            user_config=user_config,
            autoscaling_config=ac,
            ray_actor_options=ray_actor_options,
        )

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap


# ---------------------------------------------------------------------------
# Runtime management


def _controller():
    import ray_tpu_torch

    return ray_tpu_torch.get_actor(CONTROLLER_NAME, namespace=NAMESPACE)


def start(http_host: str = "127.0.0.1", http_port: int = 0,
          with_proxy: bool = True):
    """Ensure the controller (and optionally the HTTP proxy) exist."""
    global _started, _http_port
    import ray_tpu_torch

    with _state_lock:
        if _started:
            return
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        # Attach-or-create: a second driver (e.g. the `serve deploy` CLI
        # run twice) must reuse the live controller, not collide on the
        # actor name.
        try:
            ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME, namespace=NAMESPACE)
        except ValueError:
            ctrl_cls = ray_tpu_torch.remote(
                num_cpus=0.1, name=CONTROLLER_NAME, namespace=NAMESPACE,
                # long-poll listeners each hold a slot while parked
                max_concurrency=64,
            )(ServeController)
            ctrl = ctrl_cls.remote()
        if with_proxy:
            try:
                proxy = ray_tpu_torch.get_actor(PROXY_NAME, namespace=NAMESPACE)
            except ValueError:
                proxy_cls = ray_tpu_torch.remote(
                    num_cpus=0.1, name=PROXY_NAME, namespace=NAMESPACE,
                    max_concurrency=64,
                )(HTTPProxy)
                proxy = proxy_cls.remote(http_host, http_port)
            _http_port = ray_tpu_torch.get(proxy.get_port.remote(), timeout=30)
        ray_tpu_torch.get(ctrl.status.remote(), timeout=30)  # wait alive
        _started = True


def http_port() -> Optional[int]:
    return _http_port


def _collect_specs(app: Application, route_prefix: str,
                   specs: List[dict]) -> dict:
    """Depth-first: nested bound deployments become handles."""
    dep = app.deployment
    init_args = []
    for a in app.init_args:
        if isinstance(a, Application):
            child_spec = _collect_specs(a, None, specs)
            init_args.append(DeploymentHandle(child_spec["name"]))
        else:
            init_args.append(a)
    init_kwargs = {}
    for k, v in app.init_kwargs.items():
        if isinstance(v, Application):
            child_spec = _collect_specs(v, None, specs)
            init_kwargs[k] = DeploymentHandle(child_spec["name"])
        else:
            init_kwargs[k] = v
    ac = dep.autoscaling_config
    if isinstance(ac, dict):  # options(autoscaling_config={...}) raw dict
        ac = AutoscalingConfig(**ac)
    spec = {
        "name": dep.name,
        "deployment_def": cloudpickle.dumps(dep.func_or_class),
        "init_args": tuple(init_args),
        "init_kwargs": init_kwargs,
        "num_replicas": dep.num_replicas,
        "max_ongoing_requests": dep.max_ongoing_requests,
        "request_timeout_s": dep.request_timeout_s,
        "user_config": dep.user_config,
        "autoscaling_config": ac.to_dict() if ac else None,
        "ray_actor_options": dep.ray_actor_options,
        "route_prefix": route_prefix,
    }
    specs.append(spec)
    return spec


def run(app: Application, *, name: str = "default",
        route_prefix: str = "/", blocking_ready: bool = True,
        timeout: float = 120.0) -> DeploymentHandle:
    """Deploy an application; returns the ingress handle
    (reference: `serve/api.py:414`)."""
    import ray_tpu_torch

    if isinstance(app, Deployment):
        app = app.bind()
    start()
    specs: List[dict] = []
    ingress = _collect_specs(app, route_prefix, specs)
    ctrl = _controller()
    ray_tpu_torch.get(ctrl.deploy.remote(specs), timeout=30)
    if blocking_ready:
        from ray_tpu_torch.core.exceptions import TaskError

        for spec in specs:
            try:
                ok = ray_tpu_torch.get(
                    ctrl.wait_ready.remote(spec["name"], timeout),
                    timeout=timeout + 10)
            except TaskError as e:
                # controller raises when the deployment went unhealthy
                # (e.g. replica constructor keeps failing)
                raise RuntimeError(str(e)) from None
            if not ok:
                raise TimeoutError(
                    f"deployment {spec['name']!r} not ready in {timeout}s")
    # push routes to the proxy
    try:
        proxy = ray_tpu_torch.get_actor(PROXY_NAME, namespace=NAMESPACE)
        routing = ray_tpu_torch.get(ctrl.get_routing.remote(), timeout=10)
        ray_tpu_torch.get(proxy.update_routes.remote(routing["routes"]), timeout=10)
    except ValueError:
        pass  # proxy-less mode
    # Application record (GCS KV): app name -> its deployment names, so
    # delete()/status by APP name works from any process (reference:
    # application-level state in the serve controller).
    import json as _json

    from ray_tpu_torch.core.worker import global_worker

    global_worker().kv_put(
        name.encode(),
        _json.dumps([s["name"] for s in specs]).encode(),
        namespace="serve_apps")
    return DeploymentHandle(ingress["name"])


def get_deployment_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name)


get_app_handle = get_deployment_handle


def status() -> dict:
    import ray_tpu_torch

    return ray_tpu_torch.get(_controller().status.remote(), timeout=10)


def delete(name: str):
    """Delete by APPLICATION name (removing all its deployments) or by a
    single deployment name."""
    import json as _json

    import ray_tpu_torch
    from ray_tpu_torch.core.worker import global_worker

    w = global_worker()
    raw = w.kv_get(name.encode(), namespace="serve_apps")
    if raw is not None:
        ok = True
        for dep in _json.loads(raw):
            ok = ray_tpu_torch.get(
                _controller().delete_deployment.remote(dep),
                timeout=30) and ok
        w.kv_del(name.encode(), namespace="serve_apps")
        _push_routes_to_proxy()
        return ok
    result = ray_tpu_torch.get(_controller().delete_deployment.remote(name),
                         timeout=30)
    _push_routes_to_proxy()
    return result


def _push_routes_to_proxy():
    """Sync the proxy's route table with the controller (the proxy holds a
    pushed copy; deletions must push too, or stale prefixes route to dead
    deployments and hang instead of 404ing)."""
    import ray_tpu_torch

    try:
        proxy = ray_tpu_torch.get_actor(PROXY_NAME, namespace=NAMESPACE)
        routing = ray_tpu_torch.get(_controller().get_routing.remote(), timeout=10)
        ray_tpu_torch.get(proxy.update_routes.remote(routing["routes"]),
                    timeout=10)
    except Exception:  # noqa: BLE001 — proxy-less mode / teardown races
        pass


def shutdown():
    global _started, _http_port
    import ray_tpu_torch

    with _state_lock:
        # No early-exit on _started: a FRESH process (the `serve shutdown`
        # CLI) must still be able to tear down a live serve instance on
        # the cluster it attached to.
        if not ray_tpu_torch.is_initialized():
            return
        try:
            ray_tpu_torch.get(_controller().shutdown.remote(), timeout=30)
            ray_tpu_torch.kill(_controller())
        except Exception:  # noqa: BLE001
            pass
        try:
            proxy = ray_tpu_torch.get_actor(PROXY_NAME, namespace=NAMESPACE)
            ray_tpu_torch.get(proxy.shutdown.remote(), timeout=10)
            ray_tpu_torch.kill(proxy)
        except Exception:  # noqa: BLE001
            pass
        _started = False
        _http_port = None


def run_config(config, *, blocking: bool = False):
    """Deploy applications from a declarative config (reference: the
    ``serve deploy`` YAML schema, `python/ray/serve/schema.py` —
    ``applications: [{name, route_prefix, import_path}]``).  ``config``
    is a dict, a YAML/JSON file path, or a YAML string; each
    ``import_path`` is ``"module:attr"`` resolving to an Application (a
    bound deployment) or a Deployment (bound with no args).
    """
    import importlib
    import os as _os

    if isinstance(config, str):
        import yaml

        if _os.path.exists(config):
            with open(config) as f:
                config = yaml.safe_load(f)
        else:
            config = yaml.safe_load(config)
    apps = config.get("applications", [])
    if not apps:
        raise ValueError("config has no applications")
    out = []
    for app_cfg in apps:
        module_name, _, attr = app_cfg["import_path"].partition(":")
        target = getattr(importlib.import_module(module_name), attr)
        if not isinstance(target, (Application, Deployment)):
            raise TypeError(
                f"{app_cfg['import_path']} resolved to {type(target)}; "
                "expected an Application (deployment.bind()) or Deployment")
        # run() normalizes Deployment -> Application
        out.append(run(
            target,
            name=app_cfg.get("name", attr),
            route_prefix=app_cfg.get("route_prefix", "/"),
        ))
    if blocking:
        import time as _time

        try:
            while True:
                _time.sleep(3600)
        except KeyboardInterrupt:
            pass
    return out
