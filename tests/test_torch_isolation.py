"""The port stands alone: ray_tpu_torch and chip_smoke.py import no JAX,
nothing of ray_tpu, and not the installed cloudpickle (the runtime ships
functions with its vendored copy, ``ray_tpu_torch._vendor.cloudpickle``)."""

import ast
import os
import subprocess
import sys

from test_torch_runtime_parity import run_driver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cloudpickle", "ray_tpu")
# the port's scripts at the repo root
SCRIPTS = ("chip_smoke.py", "flash_fwd_ab.py", "flash_bwd_ab.py")


def _port_files():
    out = [os.path.join(ROOT, f) for f in SCRIPTS]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "ray_tpu_torch")):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_forbidden_imports():
    files = _port_files()
    assert len(files) >= 10
    bad = [(os.path.relpath(p, ROOT), m) for p in files
           for m in _imported_roots(p) if m in FORBIDDEN]
    assert bad == []


def _port_modules():
    return sorted(
        os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".")
        .removesuffix(".__init__")
        for p in _port_files()
        if not p.endswith(SCRIPTS))


def test_all_names_every_subpackage():
    """``ray_tpu_torch.__all__`` lists each public sub-package beside the
    runtime's API, and the walk that the blocked import takes reaches every
    module (the RL learners, the MNIST model, the runtime, the vendored
    cloudpickle, the native build, ``cluster_utils``, ``air``, ``data``
    ``train``, ``tune``, RLlib's runtime, the workflows, job submission,
    the actor pool, queue and ``Pool``, the dashboard, the autoscaler, the
    chaos schedules and the CLI included)."""
    import ray_tpu_torch

    pkg = os.path.join(ROOT, "ray_tpu_torch")
    subs = {d for d in os.listdir(pkg)
            if os.path.isfile(os.path.join(pkg, d, "__init__.py"))}
    listed = {n for n in ray_tpu_torch.__all__
              if os.path.isdir(os.path.join(pkg, n))}
    assert listed == subs - {"_vendor"}
    assert {"init", "remote", "get", "put", "wait"} <= set(
        ray_tpu_torch.__all__)
    assert {"ray_tpu_torch.rllib", "ray_tpu_torch.rllib.optim",
            "ray_tpu_torch.rllib.sac", "ray_tpu_torch.models.mnist",
            "ray_tpu_torch.core.raylet", "ray_tpu_torch.core.worker_main",
            "ray_tpu_torch.util.chaos", "ray_tpu_torch.native.build",
            "ray_tpu_torch._vendor.cloudpickle",
            "ray_tpu_torch._vendor.cloudpickle.cloudpickle",
            "ray_tpu_torch.cluster_utils", "ray_tpu_torch.air.checkpoint",
            "ray_tpu_torch.data.iterator", "ray_tpu_torch.train.torch",
            "ray_tpu_torch.train.sklearn", "ray_tpu_torch.tune",
            "ray_tpu_torch.tune.tune_controller",
            "ray_tpu_torch.rllib.algorithm", "ray_tpu_torch.rllib.env_runner",
            "ray_tpu_torch.rllib.learner_group",
            "ray_tpu_torch.rllib.multi_agent",
            "ray_tpu_torch.rllib.replay_buffers", "ray_tpu_torch.workflow",
            "ray_tpu_torch.job_submission", "ray_tpu_torch.util.queue",
            "ray_tpu_torch.util.actor_pool",
            "ray_tpu_torch.util.multiprocessing",
            "ray_tpu_torch.util.chaos_schedule", "ray_tpu_torch.dashboard",
            "ray_tpu_torch.autoscaler", "ray_tpu_torch.autoscaler.gce",
            "ray_tpu_torch.autoscaler.monitor_main",
            "ray_tpu_torch.scripts"} <= set(
                _port_modules())


def test_package_imports_with_jax_and_ray_tpu_blocked():
    mods = _port_modules()
    code = (
        "import sys\n"
        f"for m in {FORBIDDEN!r}: sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {mods + [s[:-3] for s in SCRIPTS]!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(sys.modules.get(m) for m in "
        f"{FORBIDDEN!r})\n"
        "print('ok', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


CLUSTER = """
import os, sys
for m in FORBIDDEN:
    sys.modules[m] = None
import ray_tpu_torch as rt

rt.init(num_cpus=2)


def loaded():
    return sorted(m for m in FORBIDDEN if sys.modules.get(m) is not None)


@rt.remote
def task(x):
    return [x * 2, loaded()]


@rt.remote
class Actor:
    def __init__(self, base):
        self.base = base

    def add(self, x):
        return [self.base + x, loaded()]


print("task", rt.get(task.remote(21), timeout=60))
print("actor", rt.get(Actor.remote(1).add.remote(2), timeout=60))

from ray_tpu_torch import tune


def trial(config):
    tune.report({"y": config["x"] * 2, "loaded": loaded()})


grid = tune.Tuner(
    trial, param_space={"x": tune.grid_search([1, 2])},
    tune_config=tune.TuneConfig(metric="y", mode="max"),
    run_config=tune.RunConfig(name="iso", storage_path=sys.argv[1])).fit()
best = grid.get_best_result()
print("tune", best.metrics["y"], best.metrics["loaded"], len(grid.errors))
print("driver", loaded())
rt.shutdown()
"""


def test_cluster_runs_with_jax_and_ray_tpu_blocked(tmp_path):
    """A port cluster starts in a driver where jax, jaxlib, ray_tpu and the
    installed cloudpickle cannot be imported; a task and an actor call
    return, a Tune sweep runs its two trials in trial actors, and neither
    the workers nor the driver loaded any of them."""
    main = tmp_path / "main.py"
    main.write_text(f"FORBIDDEN = {FORBIDDEN!r}\n" + CLUSTER)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc, stdout, stderr = run_driver(
        [sys.executable, str(main), str(tmp_path / "results")],
        str(tmp_path), env)
    assert proc.returncode == 0, stderr
    assert stdout.splitlines() == [
        "task [42, []]", "actor [3, []]", "tune 4 [] 0", "driver []"], stdout


SERVE_APP = """
import json, os, sys, urllib.request
for m in FORBIDDEN:
    sys.modules[m] = None
import ray_tpu_torch as rt
from ray_tpu_torch import serve

rt.init(num_cpus=4)
serve.start()


def loaded():
    return sorted(m for m in FORBIDDEN if sys.modules.get(m) is not None)


@serve.deployment(name="doubler")
class Doubler:
    def __call__(self, req):
        return {"y": 2 * req["x"], "loaded": loaded()}


h = serve.run(Doubler.bind(), route_prefix="/double")
print("handle", json.dumps(rt.get(h.remote({"x": 21}), timeout=60)))
req = urllib.request.Request(
    f"http://127.0.0.1:{serve.http_port()}/double",
    data=json.dumps({"x": 4}).encode(), method="POST")
with urllib.request.urlopen(req, timeout=60) as resp:
    print("http", resp.status, resp.read().decode())
print("driver", loaded(), sorted(m for m in sys.modules
                                 if m.startswith("ray_tpu_torch.serve.")))
serve.shutdown()
rt.shutdown()
"""


def test_serve_app_runs_with_jax_and_ray_tpu_blocked(tmp_path):
    """``ray_tpu_torch.serve`` starts its controller and HTTP proxy and
    serves a deployment over a handle and over HTTP in a driver where jax,
    jaxlib, ray_tpu and the installed cloudpickle cannot be imported;
    neither the replica nor the driver loaded any of them."""
    main = tmp_path / "main.py"
    main.write_text(f"FORBIDDEN = {FORBIDDEN!r}\n" + SERVE_APP)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc, stdout, stderr = run_driver([sys.executable, str(main)],
                                      str(tmp_path), env)
    assert proc.returncode == 0, stderr
    lines = stdout.splitlines()
    assert lines[:2] == ['handle {"y": 42, "loaded": []}',
                         'http 200 {"y": 8, "loaded": []}'], stdout
    mods = ("ray_tpu_torch.serve.batching", "ray_tpu_torch.serve.controller",
            "ray_tpu_torch.serve.http_proxy",
            "ray_tpu_torch.serve.multiplex", "ray_tpu_torch.serve.router")
    assert lines[2].startswith("driver [] ") and all(
        repr(m) in lines[2] for m in mods), stdout


CLUSTER_TRAIN = """
import os, sys
for m in FORBIDDEN:
    sys.modules[m] = None
import ray_tpu_torch as rt
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer


def loaded():
    return sorted(m for m in FORBIDDEN if sys.modules.get(m) is not None)


c = Cluster(initialize_head=True, head_resources={"num_cpus": 2})
try:
    c.add_node(num_cpus=1, resources={"other": 1})
    c.wait_for_nodes(2)
    c.connect()

    @rt.remote(resources={"other": 1})
    def there():
        return [os.environ["RAY_TPU_NODE_ID"], loaded()]

    node, mods = rt.get(there.remote(), timeout=60)
    print("node", node == c.nodes[1].node_id, mods)

    def loop(config):
        from ray_tpu_torch.train import session
        from ray_tpu_torch.train.torch import get_device

        session.report({"x": config["x"] * 2, "device": get_device().type,
                        "loaded": loaded()})

    result = TorchTrainer(
        loop, train_loop_config={"x": 21},
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="iso", storage_path=sys.argv[1])).fit()
    print("fit", result.metrics)
    print("driver", loaded())
finally:
    c.shutdown()
"""


def test_cluster_and_trainer_run_with_jax_and_ray_tpu_blocked(tmp_path):
    """A two-node port ``Cluster`` (a GCS and two raylets as processes)
    runs a task on its second node, and a one-worker ``TorchTrainer.fit``
    on the CPU reports through it, in a driver where jax, jaxlib, ray_tpu
    and the installed cloudpickle cannot be imported; neither the workers
    nor the driver loaded any of them."""
    main = tmp_path / "main.py"
    main.write_text(f"FORBIDDEN = {FORBIDDEN!r}\n" + CLUSTER_TRAIN)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc, stdout, stderr = run_driver(
        [sys.executable, str(main), str(tmp_path / "results")],
        str(tmp_path), env)
    assert proc.returncode == 0, stderr
    assert stdout.splitlines() == [
        "node True []",
        "fit {'x': 42, 'device': 'cpu', 'loaded': []}",
        "driver []"], stdout


CLUSTER_TOOLS = """
import json, os, sys, urllib.request
for m in FORBIDDEN:
    sys.modules[m] = None
import ray_tpu_torch as rt
from ray_tpu_torch import workflow
from ray_tpu_torch.autoscaler import AutoscalingCluster
from ray_tpu_torch.dashboard import DashboardHead
from ray_tpu_torch.job_submission import JobSubmissionClient
from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.multiprocessing import Pool
from ray_tpu_torch.util.queue import Queue


def loaded():
    return sorted(m for m in FORBIDDEN if sys.modules.get(m) is not None)


c = AutoscalingCluster(head_resources={"CPU": 2.0}, worker_node_types={},
                       max_workers=0)
try:
    client = JobSubmissionClient(c.address)

    @rt.remote
    def add(a, b):
        return [a + b, loaded()]

    @rt.remote
    def first(pair):
        return pair[0] * 10

    workflow.init_storage(os.path.join(sys.argv[1], "wf"))
    print("workflow", workflow.run(first.bind(add.bind(1, 2)),
                                   workflow_id="w"))
    print("task", rt.get(add.remote(2, 3), timeout=60))
    q = Queue()
    q.put(loaded())
    print("queue", q.get(timeout=30))
    q.shutdown()

    @rt.remote
    class Echo:
        def f(self, x):
            return [x, loaded()]

    print("actor_pool", list(ActorPool([Echo.remote()]).map(
        lambda a, v: a.f.remote(v), [1])))
    with Pool(processes=1) as p:
        print("pool", p.map(lambda x: [x, loaded()], [2]))
    job = client.submit_job(entrypoint="echo job-ran")
    print("job", client.wait_until_finished(job, timeout=60),
          client.get_job_logs(job).strip())
    d = DashboardHead(c.address)
    with urllib.request.urlopen(d.url + "/api/cluster_resources",
                                timeout=10) as resp:
        print("dashboard", json.loads(resp.read())["total"]["CPU"])
    d.shutdown()
    print("driver", loaded())
finally:
    c.shutdown()
"""


def test_workflow_job_pool_and_dashboard_run_with_jax_and_ray_tpu_blocked(
        tmp_path):
    """On a port ``AutoscalingCluster`` in a driver where jax, jaxlib,
    ray_tpu and the installed cloudpickle cannot be imported: a workflow
    runs, a ``Queue``, an ``ActorPool`` and a ``Pool`` pass values, a job
    runs its entrypoint, and the dashboard answers; neither the workers
    nor the driver loaded any of them."""
    main = tmp_path / "main.py"
    main.write_text(f"FORBIDDEN = {FORBIDDEN!r}\n" + CLUSTER_TOOLS)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc, stdout, stderr = run_driver([sys.executable, str(main),
                                       str(tmp_path)], str(tmp_path), env)
    assert proc.returncode == 0, stderr
    assert stdout.splitlines() == [
        "workflow 30", "task [5, []]", "queue []", "actor_pool [[1, []]]",
        "pool [[2, []]]", "job SUCCEEDED job-ran", "dashboard 2.0",
        "driver []"], stdout
