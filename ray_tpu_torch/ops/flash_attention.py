"""Flash attention forward — a CUDA kernel for Hopper, with its plain version.

Counterpart of ``ray_tpu/ops/flash_attention.py``.  Two entry points and
layouts, as there:

* ``flash_attention`` — (batch, heads, seq, head_dim);
* ``flash_attention_bshd`` — (batch, seq, heads, head_dim), the layout a
  model produces from its fused qkv projection (``mha`` is an alias).

Dispatch goes by the device of the tensors:

* on the CPU, the plain version ``_reference_attention`` runs (the tests'
  path);
* on a CUDA device, the kernel of ``ray_tpu_torch/csrc/flash_fwd.cu``
  runs, or the wrapper raises ``TypeError``/``ValueError`` for what the
  kernel does not take (dtypes other than bf16; head dims other than 32,
  64 and 128).  There is no fallback to the plain version on the card.

The kernel reads both layouts through their strides, so neither is ever
transposed (the TPU's lane kernel exists to avoid that transpose under its
128-lane tiling).  It picks its own 64-row tiles and masks a ragged
sequence tail itself: ``block_q``/``block_k`` are accepted for signature
parity and are hints that the kernel ignores.

Forward only: an input that requires grad raises ``NotImplementedError``
(the backward kernels are queued in ROADMAP.md, item "Training GPT-2").

``KERNEL_LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634  # 1/ln(2)

#: head dims the CUDA kernel is instantiated for
KERNEL_HEAD_DIMS = (32, 64, 128)

#: launches of the CUDA kernel in this process (plain-version calls and
#: refused calls do not count)
KERNEL_LAUNCHES = 0


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _reference_attention(q, k, v, sm_scale, causal):
    """Dense attention over (B, H, S, D): (o in q.dtype, lse f32 (B, H, S)).

    Scores and softmax in f32 (bf16 products are exact in f32, as with
    the JAX reference's ``preferred_element_type``)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        S = q.shape[2]
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype), lse


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from ray_tpu_torch.native import build

        lib = build.load("flash_fwd")
        lib.flash_fwd_bf16.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        lib.flash_fwd_bf16.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_kernel_inputs(q, k, v):
    if not (q.device == k.device == v.device):
        raise ValueError(
            f"q, k, v on different devices: {q.device}, {k.device}, "
            f"{v.device}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(
            "the CUDA flash-attention kernel takes bfloat16 q, k, v; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(
            f"q, k, v must share one 4-d shape; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"head dim {q.shape[-1]} not supported by the CUDA kernel "
            f"(supported: {KERNEL_HEAD_DIMS})")


def _kernel_ready(x):
    """x itself when the kernel can read it through its strides (unit
    stride along D, 16-byte aligned base and rows), else a contiguous
    copy."""
    if (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in x.stride()[:-1])):
        return x
    return x.contiguous() if not x.is_contiguous() else x.clone()


def _kernel_forward(q, k, v, causal, scale, layout):
    """Launch the kernel; layout "bhsd" or "bshd".  Returns (o, lse)."""
    global KERNEL_LAUNCHES
    _check_kernel_inputs(q, k, v)
    q, k, v = (_kernel_ready(x) for x in (q, k, v))
    if layout == "bhsd":
        B, H, S, D = q.shape
        dims = (0, 2, 1)        # (batch, seq, head) stride positions
    else:
        B, S, H, D = q.shape
        dims = (0, 1, 2)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 12)(
        *(x.stride(d) for x in (q, k, v, o) for d in dims))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel().flash_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, H, S, D, strides, scale * _LOG2E,
            int(bool(causal)), stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd_bf16 launch failed: CUDA error {rc}")
    KERNEL_LAUNCHES += 1
    return o, lse


# ---------------------------------------------------------------------------
# dispatch + public API
# ---------------------------------------------------------------------------

def _check_forward_only(q, k, v):
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash attention is forward-only in ray_tpu_torch: the backward "
            "kernels are queued in ROADMAP.md (Training GPT-2)")


def _forward(q, k, v, causal, sm_scale, layout):
    _check_forward_only(q, k, v)
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cuda":
        return _kernel_forward(q, k, v, causal, scale, layout)
    if q.device.type != "cpu":
        raise ValueError(f"no flash-attention path for device {q.device}")
    if layout == "bhsd":
        return _reference_attention(q, k, v, scale, causal)
    tr = lambda x: x.transpose(1, 2)  # noqa: E731
    o, lse = _reference_attention(tr(q), tr(k), tr(v), scale, causal)
    return tr(o), lse


def _flash_fwd(q, k, v, causal, sm_scale, block_q, block_k):
    """(B, H, S, D) forward with the JAX contract: returns
    ``o, (q, k, v, o, lse)`` with lse (B, H, S) f32 in natural-log units;
    ``sm_scale`` defaults to ``D ** -0.5``; block sizes are hints."""
    o, lse = _forward(q, k, v, causal, sm_scale, "bhsd")
    return o, (q, k, v, o, lse)


def _flash_fwd_bshd(q, k, v, causal, sm_scale, block_q, block_k):
    """(B, S, H, D) counterpart of ``_flash_fwd``; lse is still (B, H, S)."""
    o, lse = _forward(q, k, v, causal, sm_scale, "bshd")
    return o, (q, k, v, o, lse)


def flash_attention(q, k, v, causal=False, sm_scale=None,
                    block_q=None, block_k=None):
    """Multi-head attention over (batch, heads, seq, head_dim) tensors."""
    o, _ = _flash_fwd(q, k, v, causal, sm_scale, block_q, block_k)
    return o


def flash_attention_bshd(q, k, v, causal=False, sm_scale=None,
                         block_q=None, block_k=None):
    """Multi-head attention over (batch, seq, heads, head_dim) tensors, the
    layout models produce from the fused qkv projection; no transpose is
    made on the card."""
    o, _ = _flash_fwd_bshd(q, k, v, causal, sm_scale, block_q, block_k)
    return o


def mha(q, k, v, causal=False, sm_scale=None):
    """Attention over (batch, seq, heads, head_dim): alias for
    :func:`flash_attention_bshd`."""
    return flash_attention_bshd(q, k, v, causal, sm_scale)


__all__ = ["flash_attention", "flash_attention_bshd", "mha",
           "_reference_attention"]
