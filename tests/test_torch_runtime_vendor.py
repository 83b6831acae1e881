"""The vendored cloudpickle (``ray_tpu_torch/_vendor/cloudpickle``) is
cloudpickle 3.1.2 byte for byte, and what it pickles needs no installed
cloudpickle to load."""

import hashlib
import os
import pickletools
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VENDOR = os.path.join(ROOT, "ray_tpu_torch", "_vendor", "cloudpickle")
# sha256 of each file, from the cloudpickle 3.1.2 wheel's RECORD
DIGESTS = {
    "__init__.py":
        "12b2b2beaa8012b3a46c2a30ae2ce11a937d0cdf93683db642da88f4243db03c",
    "cloudpickle.py":
        "29c2c0fee031a762ae3096fdbda4d5bdeec52c5510bbb998903ddd0ac7317917",
    "cloudpickle_fast.py":
        "008e5929fd806cb3710fc957c8b0e9299cb3799da87c5b5d2b565616afde7357",
}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_vendored_file_is_the_release(name):
    assert hashlib.sha256(_read(os.path.join(VENDOR, name))).hexdigest() \
        == DIGESTS[name]


def _installed(name):
    """Path of ``name`` in the installed cloudpickle 3.1.2, or a skip."""
    from importlib import metadata

    try:
        dist = metadata.distribution("cloudpickle")
    except metadata.PackageNotFoundError:
        pytest.skip("cloudpickle is not installed")
    if dist.version != "3.1.2":
        pytest.skip(f"cloudpickle {dist.version} is installed, not 3.1.2")
    if name == "LICENSE":
        rel = next(f for f in dist.files if f.name == "LICENSE")
    else:
        rel = next(f for f in dist.files if f.parts == ("cloudpickle", name))
    return str(dist.locate_file(rel))


@pytest.mark.parametrize("name", sorted(DIGESTS) + ["LICENSE"])
def test_vendored_file_equals_installed(name):
    assert _read(os.path.join(VENDOR, name)) == _read(_installed(name))


def test_version():
    from ray_tpu_torch._vendor import cloudpickle

    assert cloudpickle.__version__ == "3.1.2"
    assert cloudpickle.__file__.startswith(VENDOR)


DUMP = """
import sys
sys.modules["cloudpickle"] = None
from ray_tpu_torch._vendor import cloudpickle
from ray_tpu_torch.core import serialization

SCALE = 3


def scaled(x):
    return SCALE * x + offset(x)


def offset(x):
    return 0 if x <= 0 else 1 + offset(x - 1)


class Box:
    def __init__(self, v):
        self.v = v

    def get(self):
        return scaled(self.v)


def make():
    k = 10
    return lambda x: Box(x).get() + k


with open(sys.argv[1], "wb") as f:
    f.write(cloudpickle.dumps(make()))
with open(sys.argv[2], "wb") as f:
    f.write(serialization.dumps(make()))
"""

LOAD = """
import pickle, sys
sys.modules["cloudpickle"] = None
from ray_tpu_torch.core import serialization

with open(sys.argv[1], "rb") as f:
    fn = pickle.loads(f.read())
with open(sys.argv[2], "rb") as f:
    fn2 = serialization.loads(f.read())
print(fn(4), fn2(5), "cloudpickle" in sys.modules and
      sys.modules["cloudpickle"] is not None)
"""


def test_main_closure_loads_without_installed_cloudpickle(tmp_path):
    """A closure over ``__main__`` globals, a ``__main__`` class and a
    recursive function, pickled by the vendored copy (directly and through
    the runtime's serializer) in one process, loads and runs in another;
    both processes block the installed cloudpickle, and the stream names
    no module ``cloudpickle``."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    paths = [str(tmp_path / "fn.pkl"), str(tmp_path / "fn.rt")]
    for code in (DUMP, LOAD):
        script = tmp_path / "main.py"
        script.write_text(code)
        proc = subprocess.run([sys.executable, str(script), *paths],
                              cwd=str(tmp_path), env=env,
                              capture_output=True, text=True, timeout=60)
        assert proc.returncode == 0, proc.stderr
    # 4 -> 3 * 4 + 4 + 10, 5 -> 3 * 5 + 5 + 10
    assert proc.stdout.split() == ["26", "30", "False"]
    strings = {arg for _, arg, _ in pickletools.genops(_read(paths[0]))
               if isinstance(arg, str)}
    assert "ray_tpu_torch._vendor.cloudpickle.cloudpickle" in strings
    assert not [s for s in strings
                if s == "cloudpickle" or s.startswith("cloudpickle.")]
