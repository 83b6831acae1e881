"""The port's object serialization (``ray_tpu_torch/core/serialization.py``):
the JAX package's wire format, with a ``torch.Tensor`` value taken to the
host as one out-of-band buffer of its bytes beside its dtype and shape
(hunk c), so it comes back as a CPU tensor, bit for bit, in every dtype."""

import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from ray_tpu.core import serialization as ref
from ray_tpu_torch.core import serialization

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bits(t):
    return t.contiguous().view(torch.uint8) if t.dim() else \
        t.reshape(1).view(torch.uint8)


def _tensors():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(64, 48, generator=g)
    return {
        "f32": x, "f64": x.double(), "f16": x.half(),
        "bf16": x.to(torch.bfloat16), "i8": (x * 50).to(torch.int8),
        "u8": (x.abs() * 50).to(torch.uint8), "i32": (x * 1e4).int(),
        "i64": (x * 1e9).long(), "bool": x > 0,
        "c64": torch.complex(x, -x), "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 7), "transposed": x.t(),
        "sliced": x[::3, 5:20], "grad": x.clone().requires_grad_(),
        "parameter": torch.nn.Parameter(x.clone()),
        "nan_inf": torch.tensor([float("nan"), float("inf"), -0.0]),
    }


@pytest.mark.parametrize("name", sorted(_tensors()))
def test_tensor_round_trip_is_bit_equal(name):
    t = _tensors()[name]
    back = serialization.loads(serialization.dumps(t))
    assert type(back) is torch.Tensor
    assert back.device.type == "cpu" and not back.requires_grad
    assert back.dtype == t.dtype and back.shape == t.shape
    assert torch.equal(_bits(back), _bits(t.detach()))


def test_tensor_bytes_go_out_of_band_and_come_back_aliased():
    t = torch.arange(1 << 16, dtype=torch.float32).to(torch.bfloat16)
    ser = serialization.serialize(t)
    assert [b.nbytes for b in ser.buffers] == [t.numel() * 2]
    assert len(ser.pickled) < 512  # only the dtype, the shape and a name
    data = bytearray(ser.to_bytes())
    back = serialization.deserialize(memoryview(data))
    assert torch.equal(back, t)
    # the tensor is a view of the buffer it was read from: no copy
    off = data.index(t.view(torch.uint8).numpy().tobytes()[:64])
    data[off:off + 2] = torch.tensor([7.0], dtype=torch.bfloat16).view(
        torch.uint8).numpy().tobytes()
    assert back[0].item() == 7.0


def test_immutable_source_is_copied_without_a_warning():
    data = serialization.dumps(torch.ones(1000))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        back = serialization.loads(bytes(data))
    back += 1  # writable: its own memory, not the immutable bytes
    assert torch.equal(back, torch.full((1000,), 2.0))


def test_nested_tensor_takes_torchs_own_reducer():
    value = {"t": torch.arange(6).reshape(2, 3), "n": np.ones(4)}
    back = serialization.loads(serialization.dumps(value))
    assert torch.equal(back["t"], value["t"]) and back["n"].sum() == 4.0
    assert len(serialization.serialize(value).buffers) == 1  # numpy only


@pytest.mark.parametrize("value", [
    b"bytes", "text", 3, 2.5, None, {"a": [1, (2, 3)], "b": {"c": None}},
    np.arange(1000, dtype=np.int32), np.zeros((3, 4), np.float16),
    {"arr": np.ones(5), "list": [np.int64(3)]},
], ids=["bytes", "str", "int", "float", "none", "nested", "numpy",
        "numpy_f16", "numpy_in_dict"])
def test_wire_format_is_the_reference(value):
    """Values that are not tensors serialize to the JAX package's bytes
    (the vendored cloudpickle is the installed release)."""
    assert serialization.dumps(value) == ref.dumps(value)
    back = serialization.loads(ref.dumps(value))
    assert repr(back) == repr(ref.loads(ref.dumps(value)))


def test_serializing_never_imports_torch():
    """The runtime stays torch-free until a tensor is met: a process
    that serializes numpy arrays and dicts does not load torch."""
    code = ("import sys\n"
            "from ray_tpu_torch.core import serialization as s\n"
            "import numpy as np\n"
            "s.loads(s.dumps({'a': np.ones(3), 'b': [1, 'x']}))\n"
            "print('torch' in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"


def test_nested_cpu_tensors_load_as_in_the_reference():
    """Only tensors on the card inside a value are taken to the host: a
    CPU tensor inside one keeps torch's reducer, its class and
    ``requires_grad``, as in the JAX package."""
    x = torch.arange(6.0).reshape(2, 3)
    value = {"p": torch.nn.Parameter(x.clone()),
             "g": x.clone().requires_grad_(), "t": [x]}
    back, want = (serialization.loads(serialization.dumps(value)),
                  ref.loads(ref.dumps(value)))
    for key in ("p", "g"):
        assert type(back[key]) is type(want[key])
        assert back[key].requires_grad == want[key].requires_grad
        assert torch.equal(back[key].detach(), want[key].detach())
    assert torch.equal(back["t"][0], want["t"][0])
    assert serialization.dumps(value) == ref.dumps(value)
