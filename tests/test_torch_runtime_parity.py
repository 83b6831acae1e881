"""One driver program, two packages: the port's runtime gives what the JAX
package's gives.

Each test writes one driver program, runs it through ``ray_tpu`` and through
``ray_tpu_torch`` (the package is the program's first argument), each in its
own subprocess started from a directory outside the repo, and compares the
JSON the two print.  The programs define their functions, closures and
classes in ``__main__``, so both runtimes ship them by value with
cloudpickle: the installed package in the JAX package, the vendored copy in
the port.  Exception classes are compared by name and messages as they
stand, once the package's name and the random ids in them are made equal.

Each driver runs under a session root of its own
(``ray_tpu_torch.session_root.new_session_root``, passed as
``RAY_TPU_TEMP_DIR``, a flag of both packages), so no two drivers, of one
package or of both, meet in the default ``/tmp`` root.  The port's own runs
are also held to its leak audit: no ``ray_tpu_torch.core.*_main`` process
and no ``rtt_store_`` segment of the driver is left after it exits.  The
audit counts only what the drivers a test started left
(``assert_port_left_nothing``), so the port's clusters in other test
workers do not count; the other port runtime test files use both.
"""

import concurrent.futures
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from ray_tpu_torch.session_root import new_session_root

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("ray_tpu", "ray_tpu_torch")

HEADER = """\
import importlib, json, sys, time
rt = importlib.import_module(sys.argv[1])
OUT = {}


def error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001
        return [type(e).__name__, str(e)]
    return None


"""
FOOTER = """
rt.shutdown()
print("RESULT " + json.dumps(OUT, sort_keys=True))
"""


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def port_leftovers(driver_pids, roots=(), since=None):
    """The port's runtime processes and store segments of the drivers with
    these pids, and of the clusters started under these session roots.
    A worker of a driver's own node names its driver in its session
    directory (``session_<time>_<pid>_<hex>``, in ``RAY_TPU_SESSION_DIR``),
    a segment its owner in its name (``rtt_store_<pid>_<hex>``).  The GCS,
    raylets and workers of a ``Cluster`` carry the root they were started
    under in ``RAY_TPU_TEMP_DIR`` (a worker's session directory lies under
    it too); a killed raylet's segment names a pid that no longer runs,
    so with ``since`` (a ``time.time()``) a segment made since then whose
    owner is gone counts as well.  Only the port's modules and ``rtt_store``
    segments are looked at: the JAX package's never count."""
    from ray_tpu_torch.util import chaos

    mine = {str(p) for p in driver_pids}
    roots = tuple(os.path.realpath(r) for r in roots)
    procs = []
    for pid, module in chaos._runtime_pids().items():
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                env = dict(var.decode(errors="replace").split("=", 1)
                           for var in f.read().split(b"\0") if b"=" in var)
        except OSError:  # exited since
            continue
        session = env.get("RAY_TPU_SESSION_DIR", "")
        parts = os.path.basename(session).split("_")
        under = [os.path.realpath(p) for p in (
            env.get("RAY_TPU_TEMP_DIR"), os.path.dirname(session)) if p]
        if (parts[0] == "session" and parts[2:3] and parts[2] in mine) or \
                any(u in roots for u in under):
            procs.append(f"pid {pid} ({module})")
    segments = []
    for seg in chaos._shm_segments():
        owner = seg.split("_")[2:3]
        if not owner or not owner[0].isdigit():
            continue
        if owner[0] in mine:
            segments.append(seg)
        elif since is not None and not _pid_alive(int(owner[0])):
            try:
                made = os.stat(os.path.join("/dev/shm", seg)).st_ctime
            except OSError:  # reaped since
                continue
            if made >= since:
                segments.append(seg)
    return procs + segments


def assert_port_left_nothing(driver_pids, grace_s=15.0, roots=(),
                             since=None):
    """Teardown is asynchronous: poll up to ``grace_s`` for the drivers'
    and the roots' processes and segments to go."""
    deadline = time.monotonic() + grace_s
    while True:
        left = port_leftovers(driver_pids, roots, since)
        if not left:
            return
        assert time.monotonic() < deadline, f"left after shutdown: {left}"
        time.sleep(0.25)


@contextlib.contextmanager
def port_session_root():
    """A session root for the port's processes that this process starts
    (``config.temp_dir`` points at it meanwhile; pass it to a cluster's
    processes as ``RAY_TPU_TEMP_DIR``); on exit, what they left is held to
    the leak audit and the root is removed."""
    import ray_tpu_torch

    root = new_session_root()
    since = time.time()
    default, ray_tpu_torch.config.temp_dir = ray_tpu_torch.config.temp_dir, \
        root
    try:
        yield root
    finally:
        ray_tpu_torch.config.temp_dir = default
        try:
            assert_port_left_nothing([os.getpid()], roots=(root,),
                                     since=since)
        finally:
            shutil.rmtree(root, ignore_errors=True)


def run_driver(args, cwd, env, timeout=120):
    """Run a driver program under a session root of its own, removed after
    it exits: (proc, stdout, stderr), its port processes and segments held
    to the leak audit."""
    root = new_session_root()
    since = time.time()
    try:
        proc = subprocess.Popen(
            args, cwd=cwd, env=dict(env, RAY_TPU_TEMP_DIR=root),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            stdout, stderr = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        assert_port_left_nothing([proc.pid], roots=(root,), since=since)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return proc, stdout, stderr


def _normalize(value):
    text = json.dumps(value, sort_keys=True).replace("ray_tpu_torch",
                                                     "ray_tpu")
    return json.loads(re.sub(r"\b[0-9a-f]{16,}\b", "<id>", text))


def run_both(tmp_path, body, timeout=120):
    """The program's OUT through each package, normalized: {package: OUT}.
    The two drivers run at the same time, each under its own root."""
    main = tmp_path / "main.py"
    main.write_text(HEADER + body + FOOTER)
    env = dict(os.environ, PYTHONPATH=ROOT)
    with concurrent.futures.ThreadPoolExecutor(len(PACKAGES)) as pool:
        runs = {pkg: pool.submit(run_driver, [sys.executable, str(main), pkg],
                                 str(tmp_path), env, timeout)
                for pkg in PACKAGES}
        ended = {pkg: run.result() for pkg, run in runs.items()}
    out = {}
    for pkg, (proc, stdout, stderr) in ended.items():
        assert proc.returncode == 0, f"{pkg}:\n{stdout}\n{stderr}"
        line = [l for l in stdout.splitlines() if l.startswith("RESULT ")]
        assert line, f"{pkg}: no result\n{stdout}\n{stderr}"
        out[pkg] = _normalize(json.loads(line[-1][len("RESULT "):]))
    return out


def check_same(tmp_path, body, want=None, timeout=120):
    out = run_both(tmp_path, body, timeout)
    assert out["ray_tpu_torch"] == out["ray_tpu"]
    if want is not None:
        for key, value in want.items():
            assert out["ray_tpu"][key] == value, key
    return out["ray_tpu"]


TASKS = """
import concurrent.futures
import dataclasses

rt.init(num_cpus=4)
BASE = 7


def helper(x):
    return x + BASE


@rt.remote
def closure_task(x):
    return helper(x) * 2


class Point:
    def __init__(self, x, y):
        self.x, self.y = x, y

    def norm2(self):
        return self.x ** 2 + self.y ** 2


@rt.remote
def make_point(x, y):
    return Point(x, y)


@rt.remote
def use_point(p):
    return [type(p).__name__, type(p).__module__, p.norm2()]


def fact(n):
    return 1 if n <= 1 else n * fact(n - 1)


@rt.remote
def recursive(n):
    return fact(n)


@dataclasses.dataclass
class Cfg:
    a: int
    b: str = "x"


@rt.remote
def bump(c):
    return dataclasses.replace(c, a=c.a + 1)


@rt.remote
def inner(x):
    return x * 10


@rt.remote
def outer(x):
    return rt.get(inner.remote(x)) + 1


@rt.remote
def fan_out(n):
    return sum(rt.get([inner.remote(i) for i in range(n)]))


def make_adder(k):
    @rt.remote
    def add(x):
        return x + k
    return add


@rt.remote
def uses_submodule():
    return concurrent.futures.ThreadPoolExecutor.__name__


@rt.remote(num_returns=2)
def two(a, b=5):
    return a, b


OUT["closure"] = rt.get([closure_task.remote(i) for i in range(4)])
OUT["class"] = rt.get(use_point.remote(make_point.remote(3, 4)))
p = rt.get(make_point.remote(1, 2))
OUT["class_in_driver"] = [type(p).__name__, p.norm2(), type(p) is Point]
OUT["recursive"] = rt.get(recursive.remote(12))
OUT["dataclass"] = repr(rt.get(bump.remote(Cfg(1))))
OUT["nested"] = rt.get(outer.remote(4))
OUT["fan_out"] = rt.get(fan_out.remote(5))
OUT["local_closure"] = rt.get(make_adder(5).remote(1))
OUT["submodule"] = rt.get(uses_submodule.remote())
OUT["num_returns"] = rt.get(list(two.remote(1, b=3)))
OUT["ref_arg"] = rt.get(inner.remote(rt.put(6)))
OUT["lambda"] = rt.get(rt.remote(lambda x: x - 1).remote(10))
"""


def test_tasks(tmp_path):
    check_same(tmp_path, TASKS, {
        "closure": [14, 16, 18, 20], "class": ["Point", "__main__", 25],
        "class_in_driver": ["Point", 5, True], "recursive": 479001600,
        "dataclass": "Cfg(a=2, b='x')", "nested": 41, "fan_out": 100,
        "local_closure": 6, "submodule": "ThreadPoolExecutor",
        "num_returns": [1, 3], "ref_arg": 60, "lambda": 9})


ACTORS = """
rt.init(num_cpus=4)


@rt.remote
class Counter:
    def __init__(self, start):
        self.n = start
        self.log = []

    def incr(self, k=1):
        self.n += k
        self.log.append(k)
        return self.n

    def state(self):
        return [self.n, self.log]

    def fail(self):
        raise ValueError("counter refused")


c = Counter.remote(10)
OUT["calls"] = [rt.get(c.incr.remote()) for _ in range(3)]
OUT["ordered"] = rt.get([c.incr.remote(k) for k in range(5)])
OUT["state"] = rt.get(c.state.remote())
OUT["method_error"] = error(lambda: rt.get(c.fail.remote()))
OUT["after_error"] = rt.get(c.incr.remote())
named = Counter.options(name="ctr").remote(0)
rt.get(named.incr.remote(5))
OUT["named"] = rt.get(rt.get_actor("ctr").incr.remote())
OUT["missing_name"] = error(lambda: rt.get_actor("nope"))
OUT["handle_arg"] = rt.get(rt.remote(lambda h: rt.get(h.incr.remote(100)))
                           .remote(named))
rt.kill(c)
OUT["killed"] = error(lambda: rt.get(c.incr.remote(), timeout=30))[0]
rt.kill(named)
"""


def test_actors(tmp_path):
    out = check_same(tmp_path, ACTORS, {
        "calls": [11, 12, 13], "ordered": [13, 14, 16, 19, 23],
        "state": [23, [1, 1, 1, 0, 1, 2, 3, 4]], "after_error": 24,
        "named": 6, "handle_arg": 106,
        "missing_name": ["ValueError", "no actor named 'nope'"],
        "killed": "ActorDiedError"})
    assert out["method_error"][0] == "TaskError"
    assert "ValueError: counter refused" in out["method_error"][1]


OBJECTS = """
import numpy as np
import pytest
import torch

rt.init(num_cpus=4)
a = np.arange(1 << 20, dtype=np.float64)
b = rt.get(rt.put(a))
OUT["numpy"] = [type(b).__name__, str(b.dtype), bool((a == b).all()),
                b.base is not None and not b.flags.owndata]


@rt.remote
def ones(n):
    return np.ones(n, np.float32)


c = rt.get(ones.remote(1 << 21))
OUT["numpy_task"] = [float(c.sum()), c.base is not None]
g = torch.Generator().manual_seed(0)
t32 = torch.randn(512, 1024, generator=g)
for name, t in (("f32", t32), ("bf16", t32.to(torch.bfloat16)),
                ("i64", torch.arange(12).reshape(3, 4)),
                ("scalar", torch.tensor(2.5)), ("empty", torch.zeros(0, 3))):
    u = rt.get(rt.put(t))
    OUT["put_" + name] = [type(u).__name__, str(u.dtype), list(u.shape),
                          u.device.type, torch.equal(u, t)]


@rt.remote
def double(t):
    return [str(t.dtype), t * 2]


dt, d = rt.get(double.remote(t32.to(torch.bfloat16)))
OUT["task_bf16"] = [dt, str(d.dtype),
                    torch.equal(d, t32.to(torch.bfloat16) * 2)]
inner = rt.put([1, 2, 3])
outer = rt.put({"r": inner, "s": [rt.put("x")]})
got = rt.get(outer)
OUT["ref_in_value"] = [rt.get(got["r"]), rt.get(got["s"][0])]


@rt.remote
def total(refs):
    return sum(rt.get(refs))


OUT["refs_in_arg"] = rt.get(total.remote([rt.put(i) for i in range(5)]))


@rt.remote
def make_ref():
    return {"ref": rt.put(np.full(4, 3.0))}


OUT["ref_from_task"] = rt.get(rt.get(make_ref.remote())["ref"]).tolist()
OUT["free"] = error(lambda: rt.free([rt.put(1)]))
"""


def test_objects(tmp_path):
    tensor = ["Tensor", "torch.float32", [512, 1024], "cpu", True]
    check_same(tmp_path, OBJECTS, {
        "numpy": ["ndarray", "float64", True, True],
        "numpy_task": [float(1 << 21), True],
        "put_f32": tensor,
        "put_bf16": tensor[:1] + ["torch.bfloat16"] + tensor[2:],
        "put_i64": ["Tensor", "torch.int64", [3, 4], "cpu", True],
        "put_scalar": ["Tensor", "torch.float32", [], "cpu", True],
        "put_empty": ["Tensor", "torch.float32", [0, 3], "cpu", True],
        "task_bf16": ["torch.bfloat16", "torch.bfloat16", True],
        "ref_in_value": [[1, 2, 3], "x"], "refs_in_arg": 10,
        "ref_from_task": [3.0, 3.0, 3.0, 3.0], "free": None})


WAIT_CANCEL = """
rt.init(num_cpus=4)


@rt.remote
def quick(t):
    time.sleep(t)
    return t


@rt.remote
def long_loop(n):
    for _ in range(n):
        time.sleep(0.05)
    return n


refs = [quick.remote(0.01), quick.remote(0.02), long_loop.remote(600)]
ready, rest = rt.wait(refs, num_returns=2, timeout=20)
OUT["wait_two"] = [sorted(rt.get(ready)), len(rest), rest[0] == refs[2]]
ready, rest = rt.wait(refs, num_returns=3, timeout=0.5)
OUT["wait_timeout"] = [len(ready), len(rest)]
ready, rest = rt.wait(refs[:2], num_returns=1)
OUT["wait_one"] = [len(ready), len(rest)]
OUT["wait_duplicate"] = error(lambda: rt.wait([refs[0], refs[0]]))
OUT["wait_zero"] = error(lambda: rt.wait(refs, num_returns=0))
OUT["wait_not_list"] = error(lambda: rt.wait(refs[0]))
OUT["get_timeout"] = error(lambda: rt.get(refs[2], timeout=0.0))
OUT["cancel_running"] = rt.cancel(refs[2])
OUT["cancelled"] = error(lambda: rt.get(refs[2], timeout=30))


@rt.remote(num_cpus=4)
def hog():
    time.sleep(3)
    return "hog"


h = hog.remote()
time.sleep(0.5)
queued = quick.remote(0)
OUT["cancel_queued"] = rt.cancel(queued)
OUT["queued"] = error(lambda: rt.get(queued, timeout=30))
OUT["hog"] = rt.get(h, timeout=30)
OUT["cancel_done"] = rt.cancel(refs[0])
"""


def test_wait_and_cancel(tmp_path):
    out = check_same(tmp_path, WAIT_CANCEL, {
        "wait_two": [[0.01, 0.02], 1, True], "wait_timeout": [2, 1],
        "wait_one": [1, 1],
        "wait_duplicate": ["ValueError", "wait() got duplicate ObjectRefs"],
        "wait_zero": ["ValueError", "num_returns must be in [1, 3]"],
        "wait_not_list": ["TypeError", "wait() expects a list of ObjectRefs"],
        "get_timeout": ["GetTimeoutError", "get() timed out after 0.0s"],
        "hog": "hog"})
    assert out["cancel_running"] and out["cancel_queued"]
    assert out["cancelled"][0] == out["queued"][0] == "TaskCancelledError"


ERRORS = """
rt.init(num_cpus=2)


@rt.remote
def bad(x):
    raise ValueError(f"bad {x}")


@rt.remote
def echo(x):
    return x


@rt.remote
def catches():
    try:
        rt.get(bad.remote(7))
    except rt.TaskError as e:
        return ["caught", type(e).__name__, "ValueError: bad 7" in str(e)]


OUT["task"] = error(lambda: rt.get(bad.remote(3)))
OUT["dependency"] = error(lambda: rt.get(echo.remote(bad.remote(1))))
OUT["inside_task"] = rt.get(catches.remote())
OUT["is_rt_error"] = issubclass(rt.TaskError, rt.RayTpuError)
OUT["get_type"] = error(lambda: rt.get(1))
OUT["get_mixed"] = error(lambda: rt.get([echo.remote(1), 2]))
OUT["put_ref"] = error(lambda: rt.put(echo.remote(1)))
OUT["remote_positional"] = error(lambda: rt.remote(1, 2))
OUT["direct_call"] = error(lambda: echo(1))
OUT["reinit"] = error(lambda: rt.init())
OUT["bad_pg"] = error(lambda: rt.placement_group([{"CPU": 1}], "RING"))
"""


def test_errors(tmp_path):
    out = check_same(tmp_path, ERRORS, {
        "inside_task": ["caught", "TaskError", True], "is_rt_error": True,
        "get_type": ["TypeError", "get() got <class 'int'>"],
        "put_ref": ["TypeError", "put() of an ObjectRef is not allowed"]})
    for key in ("task", "dependency"):
        assert out[key][0] == "TaskError"
        assert out[key][1].startswith("task bad failed:\nTraceback")
    for key in ("get_mixed", "remote_positional", "direct_call", "reinit",
                "bad_pg"):
        assert out[key] is not None, key


PLACEMENT = """
PlacementGroupSchedulingStrategy = importlib.import_module(
    sys.argv[1] + ".util.scheduling_strategies"
).PlacementGroupSchedulingStrategy

rt.init(num_cpus=4)


def cpus():
    return rt.available_resources().get("CPU")


@rt.remote
def where():
    ctx = rt.get_runtime_context()
    return ctx.get_node_id() == NODE


NODE = rt.nodes()[0]["NodeID"]
OUT["total"] = rt.cluster_resources()
OUT["nodes"] = [len(rt.nodes()), rt.nodes()[0]["Alive"]]
pack = rt.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
OUT["pack_ready"] = rt.get(pack.ready(), timeout=30)
OUT["pack_wait"] = pack.wait(10)
OUT["cpus_with_pack"] = cpus()
spread = rt.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="SPREAD")
OUT["spread_ready"] = spread.wait(30)
OUT["cpus_with_both"] = cpus()
OUT["in_bundle"] = rt.get([where.options(
    scheduling_strategy=PlacementGroupSchedulingStrategy(
        pack, placement_group_bundle_index=i)).remote() for i in (0, 1)],
    timeout=30)
OUT["in_group"] = rt.get(where.options(
    scheduling_strategy=PlacementGroupSchedulingStrategy(spread)).remote(),
    timeout=30)
OUT["too_big"] = error(lambda: rt.placement_group([{"CPU": 64}]))
rt.remove_placement_group(spread)
rt.remove_placement_group(pack)
deadline = time.monotonic() + 10
while cpus() != 4.0 and time.monotonic() < deadline:
    time.sleep(0.05)
OUT["cpus_after_remove"] = cpus()
OUT["bundle_count"] = pack.bundle_count
"""


def test_placement_groups(tmp_path):
    check_same(tmp_path, PLACEMENT, {
        "total": {"CPU": 4.0}, "nodes": [1, True], "pack_ready": True,
        "pack_wait": True, "cpus_with_pack": 2.0, "spread_ready": True,
        "cpus_with_both": 0.0, "in_bundle": [True, True], "in_group": True,
        "cpus_after_remove": 4.0, "bundle_count": 2,
        "too_big": ["ValueError",
                    "placement group [{'CPU': 64}] exceeds cluster capacity"]})


SERVE = """
import os
import threading
import urllib.error
import urllib.request

serve = importlib.import_module(sys.argv[1] + ".serve")
rt.init(num_cpus=8)
serve.start()
PORT = serve.http_port()


def http(path, body=None, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{PORT}{path}",
        data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return [resp.status, [json.loads(line) for line in resp]]
    except urllib.error.HTTPError as e:
        return [e.code, e.read().decode()[:80]]


@serve.deployment
def echo(req):
    return {"echo": req}


h = serve.run(echo.bind(), route_prefix="/echo")
OUT["function"] = rt.get(h.remote({"x": 1}), timeout=30)
OUT["http_200"] = http("/echo", {"v": 2})
OUT["http_404"] = http("/no-such-route", {"a": 1})
OUT["healthz"] = http("/-/healthz")[0]
serve.delete("echo")


@serve.deployment(name="adder")
class Adder:
    def __init__(self, base):
        self.base = base

    def __call__(self, req):
        return {"sum": self.base + req["v"]}

    def peek(self, req):
        return {"base": self.base, "req": req}


h = serve.run(Adder.bind(10), route_prefix="/adder")
OUT["class"] = [rt.get(h.remote({"v": 5}), timeout=30),
                rt.get(h.method.peek.remote(None), timeout=30),
                rt.get(h.options(method_name="peek").remote(3), timeout=30),
                http("/adder", {"v": 32}), http("/-/routes")]
serve.delete("adder")


@serve.deployment(name="tokenizer")
class Tokenizer:
    def __call__(self, text):
        return text.split()


@serve.deployment(name="pipeline")
class Pipeline:
    def __init__(self, tok_handle):
        self.tok = tok_handle

    def __call__(self, req):
        toks = rt.get(self.tok.remote(req["text"]), timeout=30)
        return {"n_tokens": len(toks), "tokens": toks}


h = serve.run(Pipeline.bind(Tokenizer.bind()), route_prefix="/pipe")
OUT["nested"] = [rt.get(h.remote({"text": "a b c d"}), timeout=60),
                 sorted(serve.status())]
serve.delete("pipeline")
serve.delete("tokenizer")


@serve.deployment(name="pair", num_replicas=2)
class Pair:
    def __init__(self):
        self.pid = os.getpid()

    def __call__(self, req):
        time.sleep(0.3)
        return [self.pid, req * 3]


h = serve.run(Pair.bind(), route_prefix="/pair")
got = rt.get([h.remote(i) for i in range(4)], timeout=60)
OUT["replicas"] = [len({pid for pid, _ in got}), [v for _, v in got],
                   serve.status()["pair"]["running"]]
serve.delete("pair")


@serve.deployment(name="batched", max_ongoing_requests=32)
class Batched:
    @serve.batch(max_batch_size=4, batch_wait_timeout_s=1.0)
    def __call__(self, reqs):
        return [{"n": len(reqs), "v": r * 2} for r in reqs]

    def sizes(self, _req):
        return serve.batch_sizes_of(type(self).__call__)


h = serve.run(Batched.bind(), route_prefix="/batched")
outs = rt.get([h.remote(i) for i in range(8)], timeout=60)
OUT["batch"] = [[o["v"] for o in outs], sorted(o["n"] for o in outs),
                sorted(rt.get(h.options(method_name="sizes").remote(None),
                              timeout=30))]
serve.delete("batched")


@serve.deployment(name="mux", num_replicas=1)
class MultiModel:
    @serve.multiplexed(max_num_models_per_replica=2)
    def get_model(self, model_id):
        return {"id": model_id, "scale": float(len(model_id))}

    def __call__(self, request):
        model = self.get_model()
        return {"model": model["id"], "y": model["scale"] * request["x"]}


serve.run(MultiModel.bind(), name="muxapp", route_prefix="/mux")
posts = [http("/mux", {"x": x}, {"serve_multiplexed_model_id": mid})
         for mid, x in (("aa", 3), ("bbb", 2), ("aa", 1), ("cccc", 1))]
replica = serve.get_deployment_handle("mux")._pick_replica()
OUT["mux_lru"] = [posts, sorted(rt.get(
    replica.multiplexed_model_ids.remote(), timeout=30))]
serve.delete("muxapp")


@serve.deployment(name="mux2", num_replicas=2)
class Affine:
    @serve.multiplexed(max_num_models_per_replica=1)
    def load(self, model_id):
        return {"pid": os.getpid(), "id": model_id}

    def __call__(self, request):
        m = self.load()
        return {"pid": m["pid"], "model": m["id"]}


serve.run(Affine.bind(), name="mux2app", route_prefix="/mux2")
h = serve.get_deployment_handle("mux2").options(multiplexed_model_id="mA")
got = [rt.get(h.remote({}), timeout=60) for _ in range(7)]
OUT["mux_affinity"] = [len({g["pid"] for g in got}),
                       sorted({g["model"] for g in got}),
                       serve.get_multiplexed_model_id()]
serve.delete("mux2app")


@serve.deployment(name="streamer")
class Streamer:
    def __call__(self, req):
        for i in range(req["n"]):
            yield {"i": i, "sq": i * i}


h = serve.run(Streamer.bind(), route_prefix="/streamer")
OUT["stream_http"] = http("/streamer?stream=1", {"n": 4})
OUT["stream_handle"] = [rt.get(r, timeout=30) for r in
                        h.options(stream=True).remote({"n": 3})]
serve.delete("streamer")
OUT["status_after"] = serve.status()
serve.shutdown()
"""


def test_serve(tmp_path):
    """Serve through both packages: a function and a class deployment
    (methods by handle and by name, HTTP), a nested bind, two replicas,
    ``@serve.batch``'s batch sizes, ``@serve.multiplexed``'s LRU and
    affinity, HTTP 200, 404 and a streamed response, and a streamed
    handle.  Pids and times are not compared: the count of distinct pids
    is."""
    check_same(tmp_path, SERVE, {
        "function": {"echo": {"x": 1}},
        "http_200": [200, [{"echo": {"v": 2}}]],
        "http_404": [404, '{"error": "no route for /no-such-route"}'],
        "healthz": 200,
        "class": [{"sum": 15}, {"base": 10, "req": None},
                  {"base": 10, "req": 3}, [200, [{"sum": 42}]],
                  [200, [{"/adder": "adder"}]]],
        "nested": [{"n_tokens": 4, "tokens": ["a", "b", "c", "d"]},
                   ["pipeline", "tokenizer"]],
        "replicas": [2, [0, 3, 6, 9], 2],
        "batch": [[0, 2, 4, 6, 8, 10, 12, 14], [4] * 8, [4, 4]],
        "mux_lru": [[[200, [{"model": "aa", "y": 6.0}]],
                     [200, [{"model": "bbb", "y": 6.0}]],
                     [200, [{"model": "aa", "y": 2.0}]],
                     [200, [{"model": "cccc", "y": 4.0}]]],
                    ["aa", "cccc"]],
        "mux_affinity": [1, ["mA"], ""],
        "stream_http": [200, [{"i": i, "sq": i * i} for i in range(4)]],
        "stream_handle": [{"i": i, "sq": i * i} for i in range(3)],
        "status_after": {},
    }, timeout=300)


TRAIN_MNIST = """
import numpy as np
import pytest

PKG = sys.argv[1]
train = importlib.import_module(PKG + ".train")
rt.init(num_cpus=4)
STEPS, WORKERS, B = 3, 2, 16


def he(rng, shape, fan_in):
    return (rng.standard_normal(shape) * (2.0 / fan_in) ** 0.5).astype(
        np.float32)


rng = np.random.default_rng(0)
# JAX's layout (HWIO conv kernels); the port carries it across with
# models/mnist.py's params_from_numpy
PARAMS = {
    "conv1": {"kernel": he(rng, (3, 3, 1, 32), 9),
              "bias": np.zeros(32, np.float32)},
    "conv2": {"kernel": he(rng, (3, 3, 32, 64), 9 * 32),
              "bias": np.zeros(64, np.float32)},
    "fc1": {"kernel": he(rng, (7 * 7 * 64, 128), 7 * 7 * 64),
            "bias": np.zeros(128, np.float32)},
    "fc2": {"kernel": he(rng, (128, 10), 128),
            "bias": np.zeros(10, np.float32)},
}


def batch_of(step, rank):
    r = np.random.default_rng(1000 * step + rank)
    labels = r.integers(0, 10, B).astype(np.int32)
    ramp = np.linspace(0, 1, 784, dtype=np.float32).reshape(28, 28, 1)
    image = (r.standard_normal((B, 28, 28, 1)).astype(np.float32) * 0.1
             + (labels[:, None, None, None] / 10.0).astype(np.float32)
             * ramp[None])
    return {"image": image.astype(np.float32), "label": labels}


def loop(config):
    import importlib

    pkg = config["pkg"]
    session = importlib.import_module(pkg + ".train.session")
    col = importlib.import_module(pkg + ".collective")
    ctx = session.get_context()
    col.init_collective_group(ctx.world_size, ctx.world_rank,
                              group_name="mnist")

    def mean(x):
        return col.allreduce(x, group_name="mnist", op="mean")

    if pkg == "ray_tpu_torch":
        import torch

        from ray_tpu_torch.models import mnist
        from ray_tpu_torch.rllib import optim

        params = mnist.params_from_numpy(config["params"], device="cpu")
        opt = optim.adam(params, 1e-3)
        for step in range(config["steps"]):
            batch = {k: torch.from_numpy(v) for k, v in
                     batch_of(step, ctx.world_rank).items()}
            loss, _ = mnist.loss_fn(params, batch)
            grads = optim.tree_map(mean, optim.grads_of(loss, params))
            optim.apply_gradients(opt, params, grads)
            session.report({"step": step + 1,
                            "loss": float(mean(loss.detach()))})
    else:
        import jax
        import jax.numpy as jnp
        import optax

        from ray_tpu.models import mnist

        params = jax.tree.map(jnp.asarray, config["params"])
        opt = optax.adam(1e-3)
        state = opt.init(params)
        for step in range(config["steps"]):
            batch = batch_of(step, ctx.world_rank)
            (loss, _), grads = jax.value_and_grad(
                mnist.loss_fn, has_aux=True)(params, batch)
            grads = jax.tree.map(lambda g: jnp.asarray(mean(np.asarray(g))),
                                 grads)
            updates, state = opt.update(grads, state, params)
            params = optax.apply_updates(params, updates)
            session.report({"step": step + 1,
                            "loss": float(mean(np.asarray(loss)))})


result = train.DataParallelTrainer(
    loop, train_loop_config={"pkg": PKG, "params": PARAMS, "steps": STEPS},
    scaling_config=train.ScalingConfig(num_workers=WORKERS),
    run_config=train.RunConfig(name="mnist", storage_path=os.path.join(
        os.environ["RAY_TPU_TEMP_DIR"], "results"))).fit()
OUT["error"] = result.error
OUT["steps"] = [m["step"] for m in result.metrics_history]
# exact, as hex floats (13 hex digits: not taken for an id by _normalize)
OUT["losses"] = [float(m["loss"]).hex() for m in result.metrics_history]
"""

# f32 on both sides: XLA's and torch's CPU convolutions and reductions sum
# in other orders; after 3 Adam steps the losses differ by up to ~6e-6
MNIST_LOSS_ATOL = 1e-4


def test_train_mnist(tmp_path):
    """One Train program through both packages: ``DataParallelTrainer``
    over 2 CPU workers runs the MNIST loop (JAX with optax's Adam in the
    reference, ``models/mnist.py`` with the port's Adam here) from the same
    numpy parameters on the same per-rank batches for 3 steps, its
    gradients averaged over the workers with the host collectives
    (``collective.allreduce``, op mean, both packages).  Each step's loss,
    averaged over the workers, is held to JAX's within
    ``MNIST_LOSS_ATOL``."""
    out = run_both(tmp_path, "import os\n" + TRAIN_MNIST, timeout=300)
    ref, port = out["ray_tpu"], out["ray_tpu_torch"]
    assert ref["error"] is None and port["error"] is None
    assert ref["steps"] == port["steps"] == [1, 2, 3]
    ref_losses = [float.fromhex(x) for x in ref["losses"]]
    np.testing.assert_allclose([float.fromhex(x) for x in port["losses"]],
                               ref_losses, rtol=0, atol=MNIST_LOSS_ATOL)
    assert ref_losses[-1] < ref_losses[0]


DATA = """
import numpy as np
import pytest

data = importlib.import_module(sys.argv[1] + ".data")
rt.init(num_cpus=4)
ds = data.range(64, parallelism=4).map_batches(
    lambda b: {"id": b["id"], "x": (b["id"] * 0.5).astype(np.float64)})
scaled = data.StandardScaler(["x"]).fit_transform(ds)
shards = scaled.streaming_split(2)
rows = [(int(r["id"]), float(r["x"]).hex()) for sh in shards
        for r in sh.iter_rows()]
OUT["rows"] = sorted(rows)
OUT["count"] = len(rows)
"""


def test_data_pipeline(tmp_path):
    """One ``Dataset`` pipeline through both packages — ``map_batches``,
    a fitted ``StandardScaler`` and a streaming split into 2 shards — gives
    the same rows (the shards' union; which shard takes a block depends on
    timing), each value bit for bit (hex floats)."""
    out = check_same(tmp_path, DATA, {"count": 64})
    ids = [r[0] for r in out["rows"]]
    assert ids == list(range(64))


TUNE_SWEEP = """
tune = importlib.import_module(sys.argv[1] + ".tune")
rt.init(num_cpus=4)


def objective(config):
    for i in range(8):
        tune.report({"score": -(config["x"] - 3.0) ** 2 * config["w"]
                     + 0.25 * i})


sched = tune.ASHAScheduler(metric="score", mode="max", max_t=8,
                           grace_period=2, reduction_factor=2)
grid = tune.Tuner(
    objective,
    param_space={"x": tune.uniform(-10.0, 10.0),
                 "w": tune.grid_search([1.0, 2.0])},
    tune_config=tune.TuneConfig(
        metric="score", mode="max", num_samples=5, scheduler=sched,
        search_alg=tune.TPESearcher(n_initial_points=4, seed=0),
        max_concurrent_trials=1),
    run_config=tune.RunConfig(name="sweep", storage_path=os.path.join(
        os.environ["RAY_TPU_TEMP_DIR"], "results"))).fit()
OUT["configs"] = [[r.config["x"].hex(), r.config["w"]] for r in grid]
OUT["iterations"] = [r.metrics["training_iteration"] for r in grid]
OUT["scores"] = [r.metrics["score"].hex() for r in grid]
best = grid.get_best_result()
OUT["best"] = [best.config["x"].hex(), best.metrics["score"].hex()]
OUT["errors"] = len(grid.errors)
"""


def test_tune_sweep(tmp_path):
    """One Tune program through both packages: ``TPESearcher(seed=0)`` over
    a uniform and a ``grid_search`` dimension, 10 trials one at a time,
    under ``ASHAScheduler`` (rungs at 2 and 4 of 8 reports).  Both give the
    same trial configs, the same trials stopped at the same rungs, the
    same scores and the same best result, bit for bit (hex floats)."""
    out = check_same(tmp_path, "import os\n" + TUNE_SWEEP, {"errors": 0},
                     timeout=300)
    assert len(out["configs"]) == 10
    assert min(out["iterations"]) < 8 == max(out["iterations"])


RL_STUB = """
import pickle
import types

import numpy as np
import pytest

PKG, ALGO, INIT, FINAL = sys.argv[1:5]
rllib = importlib.import_module(PKG + ".rllib")
sample_batch = importlib.import_module(PKG + ".rllib.sample_batch")
rt.init(num_cpus=3)
T, B, ITERS = 16, 4, 3


class StubEnv:
    observation_space = types.SimpleNamespace(shape=(4,))
    action_space = types.SimpleNamespace(n=2)

    def close(self):
        pass


class StubRunner:
    \"\"\"Rollouts drawn from a numpy generator by call index: the same
    transitions whatever weights the runner holds.\"\"\"

    def __init__(self, env_creator, num_envs, rollout_length, policy_init,
                 seed=0, **kwargs):
        self.seed, self.calls = seed, 0

    def set_weights(self, weights):
        return True

    def sample(self):
        rng = np.random.default_rng([self.seed, self.calls])
        self.calls += 1
        n = T * B
        logits = rng.standard_normal((n, 2))
        actions = rng.integers(0, 2, n)
        logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
        cols = {
            "obs": rng.standard_normal((n, 4)).astype(np.float32),
            "actions": actions,
            "logps": logp[np.arange(n), actions].astype(np.float32),
            "values": rng.standard_normal(n).astype(np.float32),
            "rewards": rng.standard_normal(n).astype(np.float32),
            "dones": (rng.random(n) < 0.1).astype(np.float32),
            "next_obs": rng.standard_normal((n, 4)).astype(np.float32),
        }
        return {"batch": sample_batch.SampleBatch(cols), "t_shape": (T, B),
                "last_values": rng.standard_normal(B).astype(np.float32),
                "metrics": {"episodes": [(float(rng.normal(20, 5)), 20)],
                            "env_steps": n}}


class Algo(getattr(rllib, ALGO)):
    def runner_class(self):
        return StubRunner


cfg = (getattr(rllib, ALGO + "Config")().environment(StubEnv)
       .env_runners(num_env_runners=1, num_envs_per_runner=B,
                    rollout_length=T).debugging(seed=0))
if ALGO == "DQN":
    # uniform replay: its draws depend on the generator alone (PER's would
    # also follow |td|, which the two packages round apart)
    cfg.training(learning_starts=32, train_batch_size=32,
                 num_updates_per_iter=4, prioritized_replay=False,
                 target_network_update_freq=10 ** 9)
if PKG == "ray_tpu_torch":
    cfg.training(learner_device="cpu")
algo = Algo(cfg)
if os.path.exists(INIT):
    with open(INIT, "rb") as f:
        algo.set_weights(pickle.load(f))
    algo.sync_weights()
else:
    with open(INIT, "wb") as f:
        pickle.dump(algo.get_weights(), f)
results = [algo.train() for _ in range(ITERS)]
with open(FINAL, "wb") as f:
    pickle.dump(algo.get_weights(), f)
algo.stop()
OUT["keys"] = [sorted(r) for r in results]
OUT["results"] = [{k: float(v) for k, v in r.items()
                   if k != "env_steps_per_sec"} for r in results]
"""

# the learners' updates after the same weights on the same rollouts, f32 on
# both sides in another order: result metrics |a - b| <= RL_RESULT_RTOL |b|
# + RL_RESULT_ATOL, and each leaf of the final weights ||p - p_jax|| <=
# RL_MOVE_RTOL ||p_jax - p_0||: the learner tests' tolerances
# (tests/test_torch_rllib_learners.py, METRIC_RTOL, METRIC_ATOL, MOVE_RTOL;
# measured here: metrics 2.5e-7 relative, leaves 1.2e-5 of the distance
# moved, after 3 iterations)
RL_RESULT_RTOL, RL_RESULT_ATOL = 1e-5, 1e-6
RL_MOVE_RTOL = 1e-3


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    return [np.asarray(tree)]


@pytest.mark.parametrize("algo", ["Impala", "DQN"])
def test_rl_algorithm_on_stub_rollouts(tmp_path, algo):
    """One RLlib program through both packages: ``Impala`` (one runner, so
    iteration i consumes rollout i) and ``DQN`` (uniform replay) train 3
    iterations on a stub runner's rollouts, drawn by call index from a
    numpy generator; the port's learner (on the CPU) starts from
    ``set_weights(jax_algo.get_weights())``.  Both report the same keys,
    the same env steps and episode returns, metrics within
    ``RL_RESULT_RTOL``/``ATOL``, and final weights within the learner
    tests' tolerance of JAX's."""
    import pickle

    main = tmp_path / "main.py"
    main.write_text(HEADER + "import os\n" + RL_STUB + FOOTER)
    env = dict(os.environ, PYTHONPATH=ROOT)
    init = str(tmp_path / "init.pkl")
    out, finals = {}, {}
    for pkg in PACKAGES:  # the reference first: it writes the initial weights
        final = str(tmp_path / f"final_{pkg}.pkl")
        proc, stdout, stderr = run_driver(
            [sys.executable, str(main), pkg, algo, init, final],
            str(tmp_path), env, timeout=300)
        assert proc.returncode == 0, f"{pkg}:\n{stdout}\n{stderr}"
        line = [l for l in stdout.splitlines() if l.startswith("RESULT ")]
        out[pkg] = json.loads(line[-1][len("RESULT "):])
        with open(final, "rb") as f:
            finals[pkg] = pickle.load(f)
    ref, port = out["ray_tpu"], out["ray_tpu_torch"]
    assert port["keys"] == ref["keys"]
    for r_ref, r_port in zip(ref["results"], port["results"]):
        for k in ("num_env_steps_sampled", "episode_reward_mean",
                  "training_iteration"):
            assert r_port[k] == r_ref[k], k
        np.testing.assert_allclose(
            [r_port[k] for k in sorted(r_ref)],
            [r_ref[k] for k in sorted(r_ref)],
            rtol=RL_RESULT_RTOL, atol=RL_RESULT_ATOL, equal_nan=True)
    with open(init, "rb") as f:
        before = pickle.load(f)
    pick = (lambda w: w["params"]) if algo == "DQN" else (lambda w: w)
    for got, want, p0 in zip(_tree_leaves(pick(finals["ray_tpu_torch"])),
                             _tree_leaves(pick(finals["ray_tpu"])),
                             _tree_leaves(pick(before))):
        assert got.shape == want.shape
        assert np.linalg.norm(got - want) <= \
            RL_MOVE_RTOL * np.linalg.norm(want - p0)


WORKFLOW = """
import os
import shutil

workflow = importlib.import_module(sys.argv[1] + ".workflow")
rt.init(num_cpus=4)
store = os.path.join(os.environ["RAY_TPU_TEMP_DIR"], "workflows")
workflow.init_storage(store)
flag, touch = os.path.join(store, "ok"), os.path.join(store, "touch")


@rt.remote
def double(x, path):
    with open(path, "a") as f:
        f.write("ran\\n")
    return x * 2


@rt.remote(max_retries=0)
def flaky(x, flag_path):
    if not os.path.exists(flag_path):
        raise RuntimeError("flaky failure")
    return x + 100


dag = flaky.bind(double.bind(7, touch), flag)
err = error(lambda: workflow.run(dag, workflow_id="w"))
OUT["run_error"] = [err[0], "flaky failure" in err[1]]
OUT["failed"] = workflow.get_status("w")
OUT["runs"] = [open(touch).read().count("ran")]
OUT["files"] = sorted(os.listdir(os.path.join(store, "w")))
open(flag, "w").write("go")
OUT["resumed"] = workflow.resume("w")
OUT["runs"].append(open(touch).read().count("ran"))
OUT["status"] = workflow.get_status("w")
OUT["output"] = workflow.get_output("w")
OUT["rerun"] = workflow.run(dag, workflow_id="w")
OUT["list"] = [[m["workflow_id"], m["status"]] for m in workflow.list_all()]
shutil.rmtree(store)
"""


def test_workflow_failed_and_resumed(tmp_path):
    """One workflow through both packages: its second step fails, the
    first step's checkpoint is committed, and ``resume`` completes it
    without running the first step again; the same statuses, files,
    outputs and run counts."""
    check_same(tmp_path, WORKFLOW, {
        "run_error": ["TaskError", True], "failed": "FAILED",
        "runs": [1, 1], "resumed": 114, "status": "SUCCESSFUL",
        "output": 114, "rerun": 114, "list": [["w", "SUCCESSFUL"]],
        "files": ["000_double.pkl", "dag.pkl", "meta.json"]})


JOBS = """
cluster_utils = importlib.import_module(sys.argv[1] + ".cluster_utils")
jobs = importlib.import_module(sys.argv[1] + ".job_submission")
c = cluster_utils.Cluster(initialize_head=True,
                          head_resources={"num_cpus": 2})
try:
    c.wait_for_nodes(1)
    client = jobs.JobSubmissionClient(c.address)
    ok = client.submit_job(
        entrypoint=sys.executable + " -c \\"print('hello from job')\\"",
        submission_id="job-ok", metadata={"owner": "parity"})
    bad = client.submit_job(
        entrypoint=sys.executable + " -c \\"print('about to fail'); "
        "import sys; sys.exit(3)\\"", submission_id="job-bad")
    OUT["status"] = [client.wait_until_finished(j, timeout=60)
                     for j in (ok, bad)]
    OUT["logs"] = [client.get_job_logs(j) for j in (ok, bad)]
    infos = [client.get_job_info(j) for j in (ok, bad)]
    OUT["info"] = [[i.submission_id, i.status, i.message, i.metadata,
                    i.end_time >= i.start_time] for i in infos]
    OUT["listed"] = sorted(j.submission_id for j in client.list_jobs())
    OUT["deleted"] = client.delete_job(bad)
    OUT["after_delete"] = error(lambda: client.get_job_info(bad))
    rt.shutdown()
finally:
    c.shutdown()
"""


def test_job_submission(tmp_path):
    """One job program through both packages, each on a cluster of its
    own package: a job that succeeds and one that exits 3 reach the same
    statuses, logs, messages and metadata, and list and delete alike."""
    check_same(tmp_path, JOBS, {
        "status": ["SUCCEEDED", "FAILED"],
        "logs": ["hello from job\n", "about to fail\n"],
        "info": [["job-ok", "SUCCEEDED", "", {"owner": "parity"}, True],
                 ["job-bad", "FAILED", "entrypoint exited with code 3", {},
                  True]],
        "listed": ["job-bad", "job-ok"], "deleted": True,
        "after_delete": ["ValueError", "no job 'job-bad'"]}, timeout=180)


QUEUE_POOL = """
queue = importlib.import_module(sys.argv[1] + ".util.queue")
actor_pool = importlib.import_module(sys.argv[1] + ".util.actor_pool")
mp = importlib.import_module(sys.argv[1] + ".util.multiprocessing")
rt.init(num_cpus=4)

q = queue.Queue(maxsize=3)


@rt.remote
def producer(q, items):
    for x in items:
        q.put(x)
    return q.qsize()


OUT["queue_sizes"] = rt.get(producer.remote(q, ["a", "b"]))
q.put_nowait("c")
OUT["queue_full"] = [q.full(), error(lambda: q.put_nowait("d"))[0]]
OUT["queue"] = [q.get(timeout=10), *q.get_nowait_batch(2)]
OUT["queue_empty"] = [q.empty(), error(q.get_nowait)[0]]
q.shutdown()


@rt.remote
class Sq:
    def f(self, x):
        return x * x


pool = actor_pool.ActorPool([Sq.remote(), Sq.remote()])
OUT["actor_pool"] = list(pool.map(lambda a, v: a.f.remote(v), range(7)))
OUT["actor_pool_unordered"] = sorted(
    pool.map_unordered(lambda a, v: a.f.remote(v), range(7)))
with mp.Pool(processes=2) as p:
    OUT["pool_map"] = p.map(lambda x: x * 3 + 1, range(9))
    OUT["pool_starmap"] = p.starmap(lambda a, b: a - b, [(5, 2), (1, 4)])
    OUT["pool_apply"] = p.apply_async(lambda x: x ** 2, (12,)).get(30)
    OUT["pool_imap"] = list(p.imap(lambda x: -x, range(5), chunksize=2))
"""


def test_queue_actor_pool_and_pool(tmp_path):
    """``Queue`` (across a task, bounded), ``ActorPool`` (ordered and
    not) and ``multiprocessing.Pool`` through both packages give the same
    results and the same exceptions."""
    check_same(tmp_path, QUEUE_POOL, {
        "queue_sizes": 2, "queue_full": [True, "Full"],
        "queue": ["a", "b", "c"], "queue_empty": [True, "Empty"],
        "actor_pool": [0, 1, 4, 9, 16, 25, 36],
        "pool_map": [1, 4, 7, 10, 13, 16, 19, 22, 25],
        "pool_starmap": [3, -3], "pool_apply": 144,
        "pool_imap": [0, -1, -2, -3, -4]})


SCHEDULE = """
import hashlib

cs = importlib.import_module(sys.argv[1] + ".util.chaos_schedule")
text = "".join(
    cs.timeline_to_jsonl(cs.build_schedule(seed, duration, n_slots=slots,
                                           **gaps))
    for seed, duration, slots, gaps in (
        (12, 25.0, 2, {"min_gap_s": 2.0, "max_gap_s": 4.0}),
        (42, 60.0, 3, {}), (7, 120.0, 2, {})))
OUT["jsonl"] = text
OUT["sha256"] = hashlib.sha256(text.encode()).hexdigest()
"""


def test_chaos_schedule_is_byte_identical(tmp_path):
    """``build_schedule`` is a pure function of its seed: three seeds'
    timelines, as JSONL, are the same bytes in both packages."""
    out = run_both(tmp_path, SCHEDULE)
    ref, port = out["ray_tpu"], out["ray_tpu_torch"]
    assert port["jsonl"] == ref["jsonl"] and port["sha256"] == ref["sha256"]
    assert ref["jsonl"].count("\n") > 10


DEMAND = """
autoscaler = importlib.import_module(sys.argv[1] + ".autoscaler")
types = {"cpu4": {"resources": {"CPU": 4.0}, "max_workers": 3},
         "gpu1": {"resources": {"CPU": 1.0, "TPU": 1.0}, "max_workers": 2},
         "host8": {"resources": {"CPU": 8.0, "TPU": 8.0}}}
sched = autoscaler.ResourceDemandScheduler(types, max_workers=6)
demands = ([{"CPU": 1.0}] * 9 + [{"CPU": 1.0, "TPU": 1.0}] * 3
           + [{"TPU": 4.0}, {"GPU": 1.0}, {"CPU": 2.0, "custom": 1.0}])
free = [{"CPU": 1.0}, {"CPU": 2.0, "TPU": 0.5}]
OUT["decisions"] = [
    sched.get_nodes_to_launch(demands, free, {}),
    sched.get_nodes_to_launch(demands, free, {"cpu4": 2, "gpu1": 1}),
    sched.get_nodes_to_launch(demands[:9], [], {"cpu4": 3}),
    sched.get_nodes_to_launch(demands[9:12], free, {}),
]
"""


def test_demand_scheduler_decisions(tmp_path):
    """The autoscaler's ``ResourceDemandScheduler`` decides the same node
    launches in both packages on one fixed demand (CPU tasks, one-card
    tasks, a slice-sized task and infeasible shapes) against the same free
    capacity and node counts."""
    out = check_same(tmp_path, DEMAND)
    assert out["decisions"][0] and all(
        set(d) <= {"cpu4", "gpu1", "host8"} for d in out["decisions"])
