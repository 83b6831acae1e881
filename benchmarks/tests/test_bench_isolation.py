"""Nothing the command loads imports jax or the JAX package, and the
reference imports nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

from benchmarks.harness import cell

BLOCKER = r'''
import importlib.abc, sys
BLOCKED = {"jax", "jaxlib", "flax", "ray_tpu"}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".", 1)[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
sys.path.insert(0, ROOT)
import benchmarks.run, benchmarks.control
from benchmarks.harness import cell, data, port, result, rooflines, runtime, trace, yardstick
from benchmarks.drivers import train
from benchmarks.reference import gpt2
for m in cell.benchmark()["per_layer"]:
    cell.reader(m["name"])
import ray_tpu_torch
from ray_tpu_torch.models import gpt2 as port_gpt2
from ray_tpu_torch.data import Dataset
from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer, session
from ray_tpu_torch.train.torch import get_device
from ray_tpu_torch.util import chaos
from ray_tpu_torch.session_root import new_session_root
left = sorted({n.split(".", 1)[0] for n in sys.modules} & BLOCKED)
assert not left, left
print("isolated")
'''


def test_command_modules_load_with_jax_blocked():
    code = f"ROOT = {cell.ROOT!r}\n" + BLOCKER
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=cell.ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().endswith("isolated")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(cell.BENCH, "reference", "*.py"))
    assert files
    for path in files:
        tops = {name.split(".", 1)[0] for name in _imports(path)}
        assert not tops & {"ray_tpu_torch", "ray_tpu", "jax", "benchmarks"}, \
            (path, tops)


def test_no_file_imports_jax_or_the_jax_package():
    for path in glob.glob(os.path.join(cell.BENCH, "**", "*.py"),
                          recursive=True):
        tops = {name.split(".", 1)[0] for name in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "ray_tpu"}, (path, tops)
