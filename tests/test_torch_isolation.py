"""The port stands alone: ray_tpu_torch and chip_smoke.py import no JAX,
nothing of ray_tpu, and no cloudpickle."""

import ast
import os
import subprocess
import sys

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
    """``ray_tpu_torch.__all__`` lists each sub-package, and the walk that
    the blocked import takes reaches every module (the RL learners and
    the MNIST model included)."""
    import ray_tpu_torch

    pkg = os.path.join(ROOT, "ray_tpu_torch")
    subs = {d for d in os.listdir(pkg)
            if os.path.isfile(os.path.join(pkg, d, "__init__.py"))}
    assert subs == set(ray_tpu_torch.__all__) - {"__version__"}
    assert {"ray_tpu_torch.rllib", "ray_tpu_torch.rllib.optim",
            "ray_tpu_torch.rllib.sac",
            "ray_tpu_torch.models.mnist"} <= set(_port_modules())


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
