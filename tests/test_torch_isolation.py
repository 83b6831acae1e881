"""The port stands alone: ray_tpu_torch and chip_smoke.py import no JAX,
nothing of ray_tpu, and no cloudpickle."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cloudpickle", "ray_tpu")


def _port_files():
    out = [os.path.join(ROOT, f) for f in ("chip_smoke.py", "flash_fwd_ab.py")]
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


def test_package_imports_with_jax_and_ray_tpu_blocked():
    mods = sorted(
        os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".")
        .removesuffix(".__init__")
        for p in _port_files()
        if not p.endswith(("chip_smoke.py", "flash_fwd_ab.py")))
    code = (
        "import sys\n"
        f"for m in {FORBIDDEN!r}: sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {mods!r} + ['chip_smoke', 'flash_fwd_ab']:\n"
        "    importlib.import_module(m)\n"
        "assert not any(sys.modules.get(m) for m in "
        f"{FORBIDDEN!r})\n"
        "print('ok', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
