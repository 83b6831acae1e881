"""The port's runtime is a copy of the JAX package's, hunk for hunk.

Each file of ``COPIED`` is ``ray_tpu/<path>`` with every ``ray_tpu`` renamed
``ray_tpu_torch`` (hunk a, applied to the reference before the diff).  Where
the two still differ, the lines must lie in a hunk that ``HUNKS`` lists for
that file by its lines in the reference, and every listed hunk must still be
there.  The hunks:

(a) ``ray_tpu`` becomes ``ray_tpu_torch`` (the rename above);
(b) the vendored cloudpickle (``ray_tpu_torch._vendor``) in place of the
    installed one;
(c) a ``torch.Tensor`` taken to the host in place of a ``jax.Array``
    (``core/serialization.py``'s docstring, ``_device_to_host``, and
    ``serialize``'s pickler, which takes tensors on the card inside the
    value to the host too);
(d) the chip count from ``torch.cuda.device_count()`` in place of
    ``jax.devices()``, under the same conditions;
(e) CPU workers kept off the card by ``CUDA_VISIBLE_DEVICES=""`` in place of
    ``JAX_PLATFORMS=cpu``;
(f) no hunk: the chip resource keeps the key ``"TPU"`` (``num_gpus=`` is its
    alias), held by ``test_chip_resource_key``;
(g) object-store segments named ``rtt_store_`` in place of ``rt_store_``, so
    that neither package's leak audits and sweeps count the other's;
(h) the host libraries built into ``ray_tpu_torch/_build/``;
(i) burst mode's gate for lease-reused tasks (``core/direct.py``,
    ``DirectCallClient._submit_task`` and ``_fast_turnover``): the
    reference pipelines every task of one resource shape onto the leased
    worker once the channel's turnover EWMA is under
    ``direct_lease_turnover_ms``, so a short task can wait behind a long
    one and tasks that sleep run one after another.  The port pipelines a
    task onto a busy lease channel only where, besides that EWMA, the
    channel's oldest call in flight has been out for less than the
    threshold plus the calls in flight's turnover at the EWMA, and a
    direct call of the task's function on that lease shape has completed
    before (its first one, the probe); otherwise the task goes to the
    raylet.  Held by ``tests/test_torch_runtime_burst.py`` and by
    ``tests/test_torch_runtime_core.py``'s ``test_wait`` and
    ``test_parallelism``.

(j) ``air/checkpoint.py``'s ``_to_host``: the reference maps JAX arrays to
    numpy through ``jax.tree.map``; the port walks dicts (a ``state_dict``
    too, its ``_metadata`` kept), lists and tuples and copies every tensor
    to a CPU tensor of the same dtype (bf16 stays bf16, as hunk (c) keeps
    it in the serializer), so a checkpoint never pins card memory and is
    the state when it was made: a CPU tensor is copied too, since a loop
    updates its own in place (AdamW's step counters) while the reported
    checkpoint ships (ROADMAP §C, C4); numpy arrays pass unchanged;
(k) ``data/``: ``DataIterator.iter_jax_batches`` becomes
    ``iter_torch_batches(..., device="cuda")``, which stages each batch
    onto the card from pinned host memory with ``non_blocking``, onto the
    CPU only where the caller passes ``device="cpu"``, and raises where no
    card is present; ``Dataset.iter_torch_batches``'s default device
    becomes the card the same way;
(l) Train: ``TorchTrainer`` takes ``JaxTrainer``'s role.  ``train/torch.py``'s
    ``TorchConfig`` backend joins the workers to one process group through
    ``parallel.mesh.init_process_group``, over nccl where every worker holds
    a card of its own and gloo where workers share one card
    (``{"TPU": 0.5}``) or hold none (a backend given explicitly is
    honoured), at the node's address (``RAY_TPU_NODE_IP``) or loopback;
    ``get_device()`` is the worker's card where it holds a chip (the
    runtime's chip profile; a chip without a visible card raises) and the
    CPU where it holds none; ``prepare_model`` wraps DDP on that device.
    ``backend.py``, ``trainer.py`` and ``__init__.py`` keep
    ``DataParallelTrainer``, ``Backend``, ``BackendConfig`` and
    ``_find_free_port`` and drop ``JaxTrainer``, ``JaxConfig`` and
    ``JaxBackend`` (nothing is exported under a JAX name);
    ``backend_executor.py`` asks any backend config for its
    ``worker_env``; ``fit`` raises ``ValueError`` on
    ``ScalingConfig.devices_per_worker`` (XLA's virtual devices have no
    counterpart: a rank is one process), whose docstring says so;
(m) the host collectives (``collective/__init__.py``, held definition by
    definition): ``_HostGroup.allreduce`` of a tensor takes it to the host,
    as ``np.asarray`` of a device array does in the reference, and returns
    a CPU tensor; ``init_collective_group`` accepts ``"c10d"``, the port's
    in-program class, where the reference accepts ``"xla"``;
(n) RLlib's learner on the card (``rllib/algorithm.py``, held definition
    by definition): ``AlgorithmConfig.learner_device`` (``"cuda"`` unless a
    caller names ``"cpu"``) is the learner's device, and
    ``Algorithm.learner_device()`` returns it and raises where no card is
    visible, with no fall back to the CPU;
(o) the CLI's pid and cluster records (``scripts.py``'s ``_PID_DIR`` and
    ``_CLUSTER_DIR``) under the temp dir (``tempfile.gettempdir()``, which
    follows ``TMPDIR``) in place of ``/tmp``: two checkouts that each set
    ``TMPDIR`` keep apart the processes that their ``stop`` signals and the
    clusters that their ``up`` records;
(p) program regions (``util/tracing.py``'s ``region``: a
    ``record_function`` while torch's profiler records, a child span under
    an active trace context, else the shared no-op; the module still never
    imports torch) around Data's ingest and Train's report:
    ``data/iterator.py``'s ``data.claim`` and ``data.block_wait`` in
    ``StreamSplitDataIterator._claimed_blocks`` (and ``data.stage`` in
    hunk (k)'s ``iter_torch_batches``), ``train/session.py``'s
    ``train.report`` around ``_TrainSession.report`` with
    ``train.report_wait`` around its lockstep wait.

Hunk (a) is also listed where a name of the reference begins with
``ray_tpu_`` and so escapes the rename's word boundary: ``RunConfig``'s
default storage ``~/ray_tpu_results`` becomes ``~/ray_tpu_torch_results``.

``serve/`` is the reference's ``serve/`` (controller, router, HTTP proxy,
replica, batching, multiplexing, telemetry) with hunk (b) alone, and
``tune/`` (the controller, trainables, schedulers, searchers and syncers)
the reference's ``tune/`` with hunk (a) alone, the experiments restored
from a URI staged under ``~/ray_tpu_torch_results/_synced``.  The trial
actor asks for ``num_tpus``, one card a ``"TPU"`` (f), and a trial that
asks for none is kept off the card by the raylet, as every CPU worker is
(e, in ``core/raylet.py``).  ``rllib/replay_buffers.py`` is the reference's
(numpy only); ``rllib/algorithm.py``'s ``AlgorithmConfig`` and
``Algorithm`` are the reference's with hunks (e), the rollout actors kept
off the card, and (n).
``cluster_utils.py`` is the reference's with hunks (e), the cluster's
processes kept off the card by ``CUDA_VISIBLE_DEVICES=""`` unless the
caller's environment names it, and (g).  ``air/``, ``data/`` and ``train/``
are the reference's with hunks (j), (k), (l), (p) and (b)
(``train/sklearn.py``).
``util/queue.py``, ``util/actor_pool.py``, ``util/chaos_schedule.py``,
``dashboard/``, ``autoscaler/`` and ``scripts.py`` are the reference's with
hunk (a) alone, but for hunk (o) in ``scripts.py``: the CLI keeps its pid
and cluster records under ``<temp dir>/ray_tpu_torch/``, the reference under
``/tmp/ray_tpu/``, so ``stop`` of one package signals none of the other's
processes, and a node type counts its cards under ``"TPU"`` (f).
``util/multiprocessing.py`` and ``workflow/`` are the reference's with hunk
(b), the workflow's default store ``~/.ray_tpu_torch/workflows`` by the
rename; ``job_submission/`` with hunk (e) in its docstring alone: the
supervisor is a CPU worker, kept off the card, and its entrypoint inherits
its environment.

``ray_tpu_torch/__init__.py`` carries ``ray_tpu/__init__.py``'s API and
``ray_tpu_torch/native/build.py`` ``ray_tpu/native/build.py``'s host build
beside the port's own code: those definitions are held one by one.
"""

import ast
import difflib
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "ray_tpu")
PORT = os.path.join(ROOT, "ray_tpu_torch")
RENAME = re.compile(r"(?<![A-Za-z0-9_])ray_tpu(?![A-Za-z0-9_])")

CORE = sorted(f"core/{f}" for f in os.listdir(os.path.join(REF, "core"))
              if f.endswith(".py"))
UTIL = [f"util/{m}.py" for m in (
    "__init__", "locks", "retry", "scheduling_strategies", "metrics",
    "metrics_query", "alerts", "tracing", "profiling", "state", "chaos",
    "trace_analysis", "queue", "actor_pool", "multiprocessing",
    "chaos_schedule")]
SERVE = sorted(f"serve/{f}" for f in os.listdir(os.path.join(REF, "serve"))
               if f.endswith(".py"))
TRAIN = [f"{sub}/{f}" for sub in ("air", "data", "train")
         for f in sorted(os.listdir(os.path.join(REF, sub)))
         if f.endswith(".py")]
TUNE = sorted(f"tune/{f}" for f in os.listdir(os.path.join(REF, "tune"))
              if f.endswith(".py"))
AUTOSCALER = sorted(f"autoscaler/{f}" for f in os.listdir(
    os.path.join(REF, "autoscaler")) if f.endswith(".py"))
COPIED = CORE + UTIL + SERVE + TRAIN + TUNE + AUTOSCALER + [
    "runtime_context.py", "dag.py", "cluster_utils.py",
    "native/src/object_store.cc", "native/src/frame_codec.cc",
    "rllib/replay_buffers.py", "workflow/__init__.py",
    "job_submission/__init__.py", "dashboard/__init__.py", "scripts.py"]

# path -> [(hunk, first reference line, last reference line)]; an insertion
# after reference line n is at (n, n)
HUNKS = {
    "core/actor.py": [("b", 254, 254)],
    "core/direct.py": [("i", 1149, 1167)],
    "core/object_store.py": [("g", 155, 155), ("g", 169, 169)],
    "core/raylet.py": [("e", 1084, 1093), ("b", 4139, 4139),
                       ("b", 5366, 5366)],
    "core/raylet_main.py": [("g", 59, 59)],
    "core/serialization.py": [("c", 6, 6), ("c", 19, 21), ("c", 25, 28),
                              ("c", 87, 97), ("b", 124, 124),
                              ("c", 126, 126)],
    "core/worker.py": [("b", 25, 25), ("g", 658, 658), ("d", 694, 703),
                       ("g", 715, 715)],
    "core/worker_main.py": [("b", 26, 26)],
    "util/tracing.py": [("p", 50, 50), ("p", 93, 93), ("p", 442, 442)],
    "util/chaos.py": [("g", 470, 470)],
    "util/multiprocessing.py": [("b", 18, 18), ("b", 24, 24),
                                ("b", 69, 69)],
    "workflow/__init__.py": [("b", 147, 147), ("b", 160, 160)],
    "job_submission/__init__.py": [("e", 9, 9)],
    "serve/__init__.py": [("b", 22, 22)],
    "serve/replica.py": [("b", 30, 30)],
    "cluster_utils.py": [("e", 54, 54), ("e", 68, 70), ("g", 234, 234)],
    "air/checkpoint.py": [("j", 4, 7), ("j", 21, 32)],
    "air/config.py": [("l", 22, 26), ("l", 35, 35), ("a", 81, 81),
                      ("a", 86, 86)],
    "data/dataset.py": [("k", 673, 681), ("k", 695, 695)],
    "data/iterator.py": [("k", 5, 7), ("k", 12, 12), ("k", 32, 47),
                         ("p", 80, 81), ("p", 87, 87), ("p", 100, 100)],
    "train/__init__.py": [("l", 6, 10), ("l", 21, 21), ("l", 34, 34),
                          ("l", 43, 44)],
    "train/backend.py": [("l", 8, 17), ("l", 23, 24), ("l", 51, 175)],
    "train/backend_executor.py": [("l", 22, 22), ("l", 60, 61)],
    "train/session.py": [("p", 18, 18), ("p", 78, 82)],
    "train/sklearn.py": [("b", 41, 41), ("b", 82, 82)],
    "train/torch.py": [("l", 9, 123)],
    "train/trainer.py": [("l", 1, 1), ("l", 22, 22), ("l", 36, 39),
                         ("l", 117, 120), ("l", 218, 228)],
    "tune/__init__.py": [("a", 180, 180)],
    "scripts.py": [("o", 40, 40), ("o", 42, 42), ("o", 189, 189)],
}

# hunks whose new lines are the reference's under one textual substitution
SUBSTITUTE = {
    "a": ("ray_tpu_results", "ray_tpu_torch_results"),
    "b": ("import cloudpickle", "from ray_tpu_torch._vendor import cloudpickle"),
    "g": ("rt_store", "rtt_store"),
}


def _renamed(path):
    with open(os.path.join(REF, path), encoding="utf-8") as f:
        return RENAME.sub("ray_tpu_torch", f.read())


def _read(path):
    with open(os.path.join(PORT, path), encoding="utf-8") as f:
        return f.read()


def _check_hunks(ref_lines, port_lines, hunks, first_line=1):
    """Every difference lies in a listed hunk, every hunk is there, and the
    substitution hunks are exactly their substitution."""
    ops = [op for op in difflib.SequenceMatcher(
        None, ref_lines, port_lines, autojunk=False).get_opcodes()
        if op[0] != "equal"]
    seen = set()
    for _, i1, i2, j1, j2 in ops:
        lo = i1 + first_line
        hi = max(i2 + first_line - 1, lo - (i1 == i2))
        lo = min(lo, hi)
        inside = [h for h in hunks if h[1] <= lo and hi <= h[2]]
        assert inside, (f"reference lines {lo}-{hi} differ outside the "
                        f"listed hunks: {ref_lines[i1:i2]} -> "
                        f"{port_lines[j1:j2]}")
        label = inside[0][0]
        seen.add(inside[0])
        if label in SUBSTITUTE:
            old, new = SUBSTITUTE[label]
            assert [l.replace(old, new) for l in ref_lines[i1:i2]] == \
                port_lines[j1:j2], (label, ref_lines[i1:i2],
                                    port_lines[j1:j2])
    assert seen == set(hunks), f"listed hunks not found: {set(hunks) - seen}"


@pytest.mark.parametrize("path", COPIED)
def test_copy_differs_only_in_listed_hunks(path):
    hunks = HUNKS.get(path, [])
    assert {h[0] for h in hunks} <= set("abcdeghijklop")
    _check_hunks(_renamed(path).splitlines(), _read(path).splitlines(),
                 hunks)


def test_copy_list_is_whole():
    """Every module of the reference's core, util, serve, air, data, train,
    tune, autoscaler, workflow, job_submission and dashboard is copied,
    and those sub-packages of the port hold nothing that is not a copy."""
    subs = ("core", "util", "serve", "air", "data", "train", "tune",
            "autoscaler", "workflow", "job_submission", "dashboard")
    for sub in subs:
        port = {f"{sub}/{f}" for f in os.listdir(os.path.join(PORT, sub))
                if f.endswith(".py")}
        assert port == {p for p in COPIED if p.startswith(sub + "/")}
    assert set(CORE) == {f"core/{f}" for f in os.listdir(
        os.path.join(REF, "core")) if f.endswith(".py")}
    assert len(SERVE) == 8
    assert len(TRAIN) == 5 + 6 + 8
    assert len(TUNE) == 6
    assert len(AUTOSCALER) == 3
    for sub in subs:
        ref = {f"{sub}/{f}" for f in os.listdir(os.path.join(REF, sub))
               if f.endswith(".py")}
        assert ref <= set(COPIED), ref - set(COPIED)
    assert set(HUNKS) <= set(COPIED)


def _definitions(source):
    """name -> (first line, lines) of each top-level def, class and
    assignment to one name."""
    out = {}
    lines = source.splitlines()
    for node in ast.parse(source).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            name = node.name
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = getattr(node, "targets", None) or [node.target]
            if len(targets) != 1 or not isinstance(targets[0], ast.Name):
                continue
            name = targets[0].id
        else:
            continue
        first = min([node.lineno] + [d.lineno for d in getattr(
            node, "decorator_list", [])])
        out[name] = (first, lines[first - 1:node.end_lineno])
    return out


HOST_BUILD = ("_LIBS", "_warned", "NativeBuildError", "_build", "lib_path",
              "try_lib_path")
# (h): the output directory, at ray_tpu/native/build.py's lib_path
HOST_BUILD_HUNKS = {"lib_path": [("h", 74, 74)]}


@pytest.mark.parametrize("name", HOST_BUILD)
def test_host_build_is_the_reference(name):
    ref = _definitions(_renamed("native/build.py"))
    port = _definitions(_read("native/build.py"))
    first, ref_lines = ref[name]
    _check_hunks(ref_lines, port[name][1], HOST_BUILD_HUNKS.get(name, []),
                 first_line=first)


HOST_COLLECTIVES = ("_HostGroup", "_groups", "init_collective_group",
                    "get_group", "destroy_collective_group", "allreduce",
                    "allgather", "broadcast", "barrier", "send", "recv")
# (m): a tensor's allreduce on the host; the in-program backend's name
HOST_COLLECTIVE_HUNKS = {"_HostGroup": [("m", 152, 152)],
                         "init_collective_group": [("m", 193, 194)]}


@pytest.mark.parametrize("name", HOST_COLLECTIVES)
def test_host_collectives_are_the_reference(name):
    """``ray_tpu_torch/collective/__init__.py`` holds the reference's host
    group beside ``c10d``, each definition as it stands there but for
    hunk (m)."""
    ref = _definitions(_renamed("collective/__init__.py"))
    port = _definitions(_read("collective/__init__.py"))
    first, ref_lines = ref[name]
    _check_hunks(ref_lines, port[name][1],
                 HOST_COLLECTIVE_HUNKS.get(name, []), first_line=first)


ALGORITHM = ("AlgorithmConfig", "Algorithm")
# (e): the rollout actors off the card; (n): the learner's device
ALGORITHM_HUNKS = {"AlgorithmConfig": [("n", 27, 27)],
                   "Algorithm": [("e", 93, 98), ("n", 125, 125)]}


@pytest.mark.parametrize("name", ALGORITHM)
def test_algorithm_is_the_reference(name):
    """``ray_tpu_torch/rllib/algorithm.py`` holds the reference's
    ``AlgorithmConfig`` and ``Algorithm``, each as it stands there but for
    hunks (e) and (n)."""
    ref = _definitions(_renamed("rllib/algorithm.py"))
    port = _definitions(_read("rllib/algorithm.py"))
    first, ref_lines = ref[name]
    _check_hunks(ref_lines, port[name][1], ALGORITHM_HUNKS[name],
                 first_line=first)


def test_host_allreduce_of_a_tensor():
    """(m): a tensor's allreduce returns a CPU tensor of the reduction, a
    numpy array's a numpy array, as in the reference; ``"xla"`` is not a
    backend of the port."""
    import numpy as np
    import torch

    from ray_tpu_torch import collective as col

    group = col._HostGroup("solo", 1, 0)
    group.allgather_obj = lambda obj, timeout=120.0: [obj, obj + 1]
    x = torch.arange(3, dtype=torch.bfloat16)
    out = group.allreduce(x)
    assert out.dtype == torch.bfloat16 and out.device.type == "cpu"
    assert out.tolist() == [1.0, 3.0, 5.0]
    assert group.allreduce(torch.arange(3), op="mean").tolist() == [
        0.5, 1.5, 2.5]
    assert group.allreduce(x, op="max").tolist() == [1.0, 2.0, 3.0]
    assert group.allreduce(x, op="min").tolist() == [0.0, 1.0, 2.0]
    assert isinstance(group.allreduce(np.arange(3.0)), np.ndarray)
    with pytest.raises(ValueError):
        col.init_collective_group(1, 0, backend="xla")


def test_api_is_the_reference():
    """``ray_tpu_torch/__init__.py`` defines every function of
    ``ray_tpu/__init__.py`` as it stands there, imports what it imports
    and exports what it exports; its lazy ``__getattr__`` names only
    sub-packages the port has."""
    ref_src = _renamed("__init__.py")
    port_src = _read("__init__.py")
    ref, port = _definitions(ref_src), _definitions(port_src)
    funcs = [n for n, (_, lines) in ref.items()
             if lines[0].startswith("def ") and n != "__getattr__"]
    assert len(funcs) == 14
    for name in funcs:
        assert port[name][1] == ref[name][1], name

    def imports(src):
        return [ast.unparse(n) for n in ast.parse(src).body
                if isinstance(n, (ast.Import, ast.ImportFrom))]

    assert imports(port_src) == imports(ref_src)
    import ray_tpu_torch

    ref_all = ast.literal_eval(ref["__all__"][1][0].split("=", 1)[1].strip()
                               + "".join(ref["__all__"][1][1:]))
    assert set(ref_all) <= set(ray_tpu_torch.__all__)
    getattr_node = next(n for n in ast.parse(port_src).body
                        if isinstance(n, ast.FunctionDef)
                        and n.name == "__getattr__")
    lazy = next(ast.literal_eval(n.comparators[0]) for n in ast.walk(
        getattr_node) if isinstance(n, ast.Compare))
    for name in lazy:
        assert os.path.isfile(os.path.join(PORT, name, "__init__.py")), name
        assert getattr(ray_tpu_torch, name).__name__ == f"ray_tpu_torch.{name}"


def test_chip_resource_key():
    """(f): ``num_gpus=`` and ``num_tpus=`` ask for the key ``"TPU"``, one
    accelerator chip, as in the reference."""
    from ray_tpu.core.remote_function import _build_resources as ref_build

    from ray_tpu_torch.core.remote_function import _build_resources

    for opts in ({"num_gpus": 1}, {"num_tpus": 2, "num_cpus": 0},
                 {"num_cpus": 2, "resources": {"x": 1}}):
        assert _build_resources(opts) == ref_build(opts)
    assert _build_resources({"num_gpus": 1}) == {"CPU": 1.0, "TPU": 1.0}
