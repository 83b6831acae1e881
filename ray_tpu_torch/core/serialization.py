"""Object serialization: pickle protocol 5 with out-of-band buffers.

Mirrors the reference's serialization design
(`python/ray/_private/serialization.py:398` — msgpack envelope + pickle5 with
zero-copy buffer callbacks): large contiguous buffers (numpy arrays, bytes,
torch tensors) are split out of the pickle stream so that, when an object is
read from the shared-memory store, numpy views can alias the mmap directly
with no copy.

Wire format (little-endian):

    [u32 magic][u32 n_buffers][u64 pickled_len]
    [u64 buf_len * n_buffers]
    [pickled bytes]
    [padding to 64] [buffer 0] [padding to 64] [buffer 1] ...

Each buffer is aligned to 64 bytes so XLA/numpy get aligned host memory.

Tensors: a ``torch.Tensor`` value, on the card or not, is taken to the host
on serialize (the object plane is host memory by design — device-to-device
tensors move via collectives, not the object store; see SURVEY.md §2.6
"Object plane") and comes back as a CPU ``torch.Tensor`` of the same dtype
and shape.  Its bytes travel as one out-of-band buffer, zero-copy as a numpy
array's do, beside its dtype and shape, so bf16 (which numpy lacks) comes
back bit for bit.  A tensor on the card inside another value takes the same
path, so the value loads in any process, a CPU worker's too, as a nested
``jax.Array`` does (its reducer pickles the host value).  A CPU tensor
inside another value is pickled by torch's own reducer, as in the JAX
package, and keeps its class and ``requires_grad``.
"""

from __future__ import annotations

import functools
import io
import pickle
import struct
import sys

import numpy as np
from typing import Any, List

_MAGIC = 0x52545055  # "RTPU"
_ALIGN = 64
_HEADER = struct.Struct("<IIQ")


class SerializedObject:
    """A serialized object as (meta, list of zero-copy buffers)."""

    __slots__ = ("pickled", "buffers")

    def __init__(self, pickled: bytes, buffers: List[memoryview]):
        self.pickled = pickled
        self.buffers = buffers

    def total_bytes(self) -> int:
        size = _HEADER.size + 8 * len(self.buffers) + len(self.pickled)
        size = _aligned(size)
        for b in self.buffers:
            size = _aligned(size + b.nbytes)
        return size

    def write_into(self, dest: memoryview) -> int:
        """Serialize into a writable buffer; returns bytes written."""
        n = len(self.buffers)
        _HEADER.pack_into(dest, 0, _MAGIC, n, len(self.pickled))
        off = _HEADER.size
        for b in self.buffers:
            struct.pack_into("<Q", dest, off, b.nbytes)
            off += 8
        dest[off : off + len(self.pickled)] = self.pickled
        off = _aligned(off + len(self.pickled))
        for b in self.buffers:
            flat = b.cast("B") if b.ndim != 1 or b.format != "B" else b
            if flat.nbytes >= (1 << 16):
                # numpy's copy loop runs ~3x faster than memoryview slice
                # assignment for large transfers (vectorized memcpy);
                # measured 2.25 -> 6.6 GiB/s host-bandwidth on v5e hosts.
                np.copyto(
                    np.frombuffer(dest, np.uint8, flat.nbytes, off),
                    np.frombuffer(flat, np.uint8))
            else:
                dest[off : off + flat.nbytes] = flat
            off = _aligned(off + flat.nbytes)
        return off

    def to_bytes(self) -> bytes:
        out = bytearray(self.total_bytes())
        self.write_into(memoryview(out))
        return bytes(out)


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _device_to_host(obj: Any) -> Any:
    # torch is not imported here: the core runtime must not require it, and
    # a tensor exists only in a process that has loaded it.
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(obj, torch.Tensor):
        return _HostTensor(obj)
    return obj


class _HostTensor:
    """A tensor on the host, pickled as its bytes (one out-of-band buffer),
    its dtype and its shape."""

    __slots__ = ("tensor",)

    def __init__(self, tensor):
        self.tensor = tensor.detach().cpu().contiguous()

    def __reduce_ex__(self, protocol):
        t = self.tensor
        raw = t.reshape(-1).view(sys.modules["torch"].uint8).numpy()
        return _tensor_from_host, (pickle.PickleBuffer(raw), t.dtype,
                                   tuple(t.shape))


def _dumps(cloudpickle, obj, callback) -> bytes:
    """``cloudpickle.dumps``, with every tensor on the card inside the value
    taken to the host as ``_device_to_host`` takes the value itself."""
    if "torch" not in sys.modules:  # no tensor exists in this process
        return cloudpickle.dumps(obj, protocol=5, buffer_callback=callback)
    with io.BytesIO() as f:
        _card_to_host(cloudpickle.Pickler)(
            f, protocol=5, buffer_callback=callback).dump(obj)
        return f.getvalue()


@functools.cache
def _card_to_host(pickler):
    torch = sys.modules["torch"]

    class CardToHost(pickler):
        def reducer_override(self, obj):
            if isinstance(obj, torch.Tensor) and obj.is_cuda:
                return _HostTensor(obj).__reduce_ex__(5)
            return super().reducer_override(obj)

    return CardToHost


def _tensor_from_host(buf, dtype, shape):
    import torch

    raw = np.frombuffer(buf, np.uint8)
    if raw.size == 0:  # torch views no empty buffer as another dtype
        return torch.empty(shape, dtype=dtype)
    if not raw.flags.writeable:  # an immutable source: torch cannot alias it
        raw = raw.copy()
    return torch.from_numpy(raw).view(dtype).reshape(shape)


# Exact types whose pickle-5 stream is identical under stdlib pickle and
# cloudpickle, never triggers the out-of-band buffer callback, and needs
# no device-to-host conversion: the C ``pickle.dumps`` skips cloudpickle's
# per-call Pickler construction (~10µs), which dominates serializing the
# small scalar results the direct-transport hot path returns.
_FAST_TYPES = frozenset((bytes, str, int, float, bool, type(None)))


def serialize(obj: Any) -> SerializedObject:
    if type(obj) in _FAST_TYPES:
        return SerializedObject(pickle.dumps(obj, protocol=5), [])
    buffers: List[memoryview] = []

    def callback(pb: pickle.PickleBuffer) -> bool:
        raw = pb.raw()
        buffers.append(raw)
        return False  # out-of-band

    obj = _device_to_host(obj)
    # cloudpickle, not stdlib pickle: user scripts pass functions/classes
    # defined in __main__ or locally (train loops, actor classes) — stdlib
    # pickle serializes those BY REFERENCE (module+qualname), which silently
    # "succeeds" and then fails to resolve inside the worker process.
    # cloudpickle pickles them by value and delegates everything else to the
    # stdlib machinery (same protocol-5 out-of-band buffer handling).
    from ray_tpu_torch._vendor import cloudpickle

    pickled = _dumps(cloudpickle, obj, callback)
    return SerializedObject(pickled, buffers)


def serialize_with_refs(obj: Any):
    """serialize() + the ObjectIDs of every ObjectRef pickled inside the
    value — callers pin those ids for the serialized bytes' lifetime (the
    borrow-pinning protocol; see object_ref.collect_serialized_refs)."""
    if type(obj) in _FAST_TYPES:
        # no ObjectRef can hide inside a scalar/bytes value: skip the
        # collector context (a contextvar round per result otherwise)
        return serialize(obj), []
    from ray_tpu_torch.core.object_ref import collect_serialized_refs

    with collect_serialized_refs() as c:
        ser = serialize(obj)
    return ser, c.ids


def deserialize(data: memoryview) -> Any:
    magic, n, plen = _HEADER.unpack_from(data, 0)
    if magic != _MAGIC:
        raise ValueError("corrupt serialized object (bad magic)")
    off = _HEADER.size
    lens = []
    for _ in range(n):
        (l,) = struct.unpack_from("<Q", data, off)
        lens.append(l)
        off += 8
    # No bytes() copy of the pickle stream: loads accepts any buffer, and
    # the meta segment can reach inline_object_max_bytes (100KB) — on the
    # 1MB get path this plus the out-of-band views below keeps the read
    # fully zero-copy over the shm arena.
    pickled = data[off : off + plen]
    off = _aligned(off + plen)
    bufs = []
    for l in lens:
        bufs.append(data[off : off + l])
        off = _aligned(off + l)
    return pickle.loads(pickled, buffers=bufs)


def dumps(obj: Any) -> bytes:
    return serialize(obj).to_bytes()


def loads(data) -> Any:
    if isinstance(data, (bytes, bytearray)):
        data = memoryview(data)
    return deserialize(data)
