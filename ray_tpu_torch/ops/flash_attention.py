"""Flash attention — CUDA kernels for Hopper, with their plain versions.

Counterpart of ``ray_tpu/ops/flash_attention.py``.  Two entry points and
layouts, as there:

* ``flash_attention`` — (batch, heads, seq, head_dim);
* ``flash_attention_bshd`` — (batch, seq, heads, head_dim), the layout a
  model produces from its fused qkv projection (``mha`` is an alias).

Both are ``torch.autograd.Function``s: the forward saves (q, k, v, o, lse)
and the backward goes through ``_flash_bwd``/``_flash_bwd_bshd``, which
keep the JAX contract (lse and an optional delta used as given, as ring
attention needs).

Dispatch goes by the device of the tensors:

* on the CPU, the plain versions ``_reference_attention`` and
  ``_reference_attention_bwd`` run (the tests' path);
* on a CUDA device, the kernels run: the forward of
  ``ray_tpu_torch/csrc/flash_fwd.cu``, and the dq and dk/dv kernels of
  ``ray_tpu_torch/csrc/flash_bwd.cu``; or the wrapper raises
  ``TypeError``/``ValueError`` for what they do not take (dtypes other
  than bf16 with f32 lse and delta; head dims other than 32, 64 and 128).
  There is no fallback to the plain version on the card.

The kernels read both layouts through their strides, so neither is ever
transposed (the TPU's lane kernels exist to avoid that transpose under its
128-lane tiling).  They pick their own tiles and mask a ragged sequence
tail themselves: ``block_q``/``block_k`` are accepted for signature parity
and are hints that the kernels ignore.  The backward's delta =
rowsum(do * o) is a torch expression in f32 before the kernels, as the
JAX package computes it in XLA outside its kernels.

``KERNEL_LAUNCHES`` counts the forward kernel's launches,
``BWD_DQ_LAUNCHES`` and ``BWD_DKV_LAUNCHES`` the backward kernels'.
"""

from __future__ import annotations

import collections
import ctypes

import torch

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634  # 1/ln(2)

#: head dims the CUDA kernel is instantiated for
KERNEL_HEAD_DIMS = (32, 64, 128)

#: launches of each CUDA kernel in this process (plain-version calls and
#: refused calls do not count): the forward, then the two backward kernels
KERNEL_LAUNCHES = 0
BWD_DQ_LAUNCHES = 0
BWD_DKV_LAUNCHES = 0


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _acc_dtype(*xs):
    """f32, or f64 where an input is f64 (so gradcheck runs in f64)."""
    return (torch.float64 if any(x.dtype == torch.float64 for x in xs)
            else torch.float32)


def _scores(q, k, sm_scale, causal, dt):
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(dt), k.to(dt)) * sm_scale
    if causal:
        S = q.shape[2]
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    return s


def _reference_attention(q, k, v, sm_scale, causal):
    """Dense attention over (B, H, S, D): (o in q.dtype, lse (B, H, S)).

    Scores, softmax and lse in f32 (bf16 products are exact in f32, as
    with the JAX reference's ``preferred_element_type``), or in f64 for
    f64 inputs."""
    dt = _acc_dtype(q, k, v)
    s = _scores(q, k, sm_scale, causal, dt)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.to(dt))
    return o.to(q.dtype), lse


def _reference_attention_bwd(q, k, v, o, lse, do, sm_scale, causal,
                             delta=None):
    """Gradients of dense attention over (B, H, S, D), the XLA branch of the
    JAX ``_flash_bwd``: p from the given lse (B, H, S) and ds = p (dp -
    delta), delta = rowsum(do * o) unless given, all in f32.  Returns
    dq, dk, dv, each in its own input's dtype."""
    dt = _acc_dtype(q, k, v, do)
    dof = do.to(dt)
    p = torch.exp(_scores(q, k, sm_scale, causal, dt) - lse[..., None].to(dt))
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.to(dt))
    if delta is None:
        delta = (dof * o.to(dt)).sum(-1)
    ds = p * (dp - delta[..., None].to(dt)) * sm_scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.to(dt))
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(dt))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# library -> C entry point -> argument types (all return a CUDA error code)
_SIGNATURES = {
    "flash_fwd": {
        "flash_fwd_bf16": [_P] * 5 + [_I] * 4 + [_P, _F] + [_I] * 4 + [_P]},
    "flash_bwd": {
        "flash_bwd_dq_bf16": [_P] * 7 + [_I] * 4 + [_P, _F, _F] + [_I] * 4
        + [_P],
        "flash_bwd_dkv_bf16": [_P] * 8 + [_I] * 4 + [_P, _F, _F] + [_I] * 4
        + [_P]},
}
_libs = {}


def _kernel(name):
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        from ray_tpu_torch.native import build

        lib = build.load(name)
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def _check_kernel_inputs(q, k, v, *rest):
    """q, k, v (and o, do for the backward): one device, bf16, one 4-d
    shape, a head dim the kernels are built for."""
    xs = (q, k, v, *rest)
    if len({x.device for x in xs}) != 1:
        raise ValueError(
            f"q, k, v, ... on different devices: {[x.device for x in xs]}")
    if any(x.dtype != torch.bfloat16 for x in xs):
        raise TypeError(
            "the CUDA flash-attention kernels take bfloat16 q, k, v (and o, "
            f"do); got {[x.dtype for x in xs]}")
    if len({x.shape for x in xs}) != 1 or q.dim() != 4:
        raise ValueError(
            f"q, k, v, ... must share one 4-d shape; got "
            f"{[tuple(x.shape) for x in xs]}")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"head dim {q.shape[-1]} not supported by the CUDA kernels "
            f"(supported: {KERNEL_HEAD_DIMS})")


def _check_rows(name, x, q, shape):
    """lse or delta: f32 (B, H, S) on q's device."""
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 for the CUDA kernels; got "
                        f"{x.dtype}")
    if tuple(x.shape) != shape or x.device != q.device:
        raise ValueError(f"{name} must be {shape} on {q.device}; got "
                         f"{tuple(x.shape)} on {x.device}")


def _kernel_ready(x):
    """x itself when the kernels can read it through its strides (unit
    stride along D, 16-byte aligned base and rows), else a contiguous
    copy.  A zero stride in a leading dimension passes (0 % 8 == 0) on
    purpose: the kernels only read their inputs, so rows that share memory,
    as in a ``do`` that autograd expanded from a broadcast, are read as
    they are; a zero or other non-unit stride along D is copied.  Outputs
    are always fresh contiguous tensors."""
    if (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in x.stride()[:-1])):
        return x
    return x.contiguous() if not x.is_contiguous() else x.clone()


def _geometry(x, layout):
    """(B, H, S, D) and the (batch, seq, head) dims of a layout."""
    if layout == "bhsd":
        B, H, S, D = x.shape
        return B, H, S, D, (0, 2, 1)
    B, S, H, D = x.shape
    return B, H, S, D, (0, 1, 2)


def _strides(dims, *xs):
    """(batch, seq, head) strides of each tensor, for the C entry points."""
    return (ctypes.c_int64 * (3 * len(xs)))(
        *(x.stride(d) for x in xs for d in dims))


#: a C entry point's code for a tensor map that cuTensorMapEncodeTiled
#: refused: this plus the CUresult (csrc/sm90.cuh kEncodeError)
ENCODE_ERROR = 1 << 16


def _launch(lib, fn, device, *args):
    """Call a C entry point on the current stream of ``device``; raise on
    the error it returns (a refused launch never runs)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(_kernel(lib), fn)(*args, stream)
    if rc >= ENCODE_ERROR:
        raise RuntimeError(f"{fn}: tensor map refused: CUresult "
                           f"{rc - ENCODE_ERROR}")
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc}")


#: the H100 SXM's streaming multiprocessors, the default of the plans
H100_SMS = 132
#: shared memory a block may use on Hopper (227 KB)
SMEM_PER_BLOCK = 232448

FwdPlan = collections.namedtuple(
    "FwdPlan", "block_m stages swizzle q_blocks smem_bytes")


def _fwd_plan(B, H, S, D, sms=H100_SMS):
    """The forward kernel's plan for (B, H, S, D): q rows a block holds
    (one consumer warpgroup of 64, or two), k/v ring depth, swizzle bytes
    of a tile row, q blocks along S and dynamic shared memory, as
    ``csrc/flash_fwd.cu`` lays it out (q tiles, k and v rings of 64-row
    tiles, 8-byte barriers, 1024 bytes of alignment slack).

    Two warpgroups (128 rows) only where B·H·⌈S/128⌉ still gives every SM
    a block; else 64 rows, so that more, shorter blocks fill the card.
    Three slots in the ring: a consumer holds two (the tile whose p·v is
    in flight and the next), the third keeps a load in flight.  The
    swizzle is 128 bytes (64 columns of D a box row), 64 at D = 32, whose
    rows are 64 bytes."""
    block_m = 128 if B * H * -(-S // 128) >= sms else 64
    stages = 3
    swizzle = 64 if D == 32 else 128
    smem = (block_m + 2 * stages * 64) * D * 2 + 8 * (1 + 2 * stages) + 1024
    return FwdPlan(block_m, stages, swizzle, -(-S // block_m), smem)


BwdPlan = collections.namedtuple(
    "BwdPlan", "block_n stages swizzle k_blocks smem_bytes")


def _bwd_plan(B, H, S, D, sms=H100_SMS):
    """The dk/dv kernel's plan for (B, H, S, D): k rows a block holds (one
    consumer warpgroup of 64, or two), q/do ring depth, swizzle bytes of a
    tile row, k blocks along S and dynamic shared memory, as
    ``csrc/flash_bwd.cu`` lays it out (the block's k and v tiles, the
    ring's q and do tiles of 64 rows and its f32 lse and delta rows, 8-byte
    barriers, 1024 bytes of alignment slack).

    Two warpgroups (128 rows) by ``_fwd_plan``'s rule: only where
    B·H·⌈S/128⌉ still gives every SM a block, else 64 rows, so that more,
    shorter blocks fill the card; and never at D = 128, where two
    consumers' dk and dv accumulators (128 registers a thread) do not fit
    in the 168 registers a thread of a 384-thread block has (ptxas spilled
    ~330 bytes).  Four slots in the ring: a consumer holds one while the
    next three load.  The swizzle is 128 bytes, 64 at D = 32, whose rows
    are 64 bytes."""
    two = D < 128 and B * H * -(-S // 128) >= sms
    block_n = 128 if two else 64
    stages = 4
    swizzle = 64 if D == 32 else 128
    tiles = 2 * block_n // 64 + 2 * stages
    smem = (tiles * 64 * D * 2 + 2 * stages * 64 * 4 + 8 * (1 + 2 * stages)
            + 1024)
    return BwdPlan(block_n, stages, swizzle, -(-S // block_n), smem)


DqPlan = collections.namedtuple(
    "DqPlan", "block_m stages swizzle q_blocks smem_bytes")


def _dq_plan(B, H, S, D, sms=H100_SMS):
    """The dq kernel's plan for (B, H, S, D): q rows a block holds (one
    consumer warpgroup of 64, or two), k/v ring depth, swizzle bytes of a
    tile row, q blocks along S and dynamic shared memory, as
    ``csrc/flash_bwd.cu`` lays it out (the block's q and do tiles, the
    ring's k and v tiles of 64 rows, 8-byte barriers, 1024 bytes of
    alignment slack).

    Two warpgroups (128 rows) only at D = 128, and by ``_fwd_plan``'s
    rule: where B·H·⌈S/128⌉ still gives every SM a block, else 64 rows, so
    that more, shorter blocks fill the card.  Below D = 128 one consumer
    always: its build fits two blocks an SM, faster than one two-consumer
    block at GPT-2 training shapes; at D = 128 it fits one block an SM and
    is slower (``flash_bwd_ab.py`` rows64, PERF.md).  Four slots in the
    ring: a consumer holds one while the next three load.  The swizzle is
    128 bytes, 64 at D = 32, whose rows are 64 bytes."""
    two = D == 128 and B * H * -(-S // 128) >= sms
    block_m = 128 if two else 64
    stages = 4
    swizzle = 64 if D == 32 else 128
    tiles = 2 * block_m // 64 + 2 * stages
    smem = tiles * 64 * D * 2 + 8 * (1 + 2 * stages) + 1024
    return DqPlan(block_m, stages, swizzle, -(-S // block_m), smem)


def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _kernel_forward(q, k, v, causal, scale, layout):
    """Launch the forward kernel; layout "bhsd" or "bshd".  Returns
    (o, lse)."""
    global KERNEL_LAUNCHES
    _check_kernel_inputs(q, k, v)
    q, k, v = (_kernel_ready(x) for x in (q, k, v))
    B, H, S, D, dims = _geometry(q, layout)
    plan = _fwd_plan(B, H, S, D, _sm_count(q.device))
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", "flash_fwd_bf16", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, H, S, D, _strides(dims, q, k, v, o),
            scale * _LOG2E, int(bool(causal)), plan.block_m, plan.stages,
            plan.swizzle)
    KERNEL_LAUNCHES += 1
    return o, lse


def _bwd_operands(q, k, v, o, lse, do, layout, delta=None):
    """Validate the backward's inputs and make them kernel-ready: returns
    (q, k, v, do, lse, delta) with lse and delta f32 (B, H, S) contiguous;
    delta = rowsum(do * o) in f32 unless given."""
    _check_kernel_inputs(q, k, v, o, do)
    B, H, S, _, _ = _geometry(q, layout)
    _check_rows("lse", lse, q, (B, H, S))
    if delta is None:
        delta = (do.float() * o.float()).sum(-1)
        if layout == "bshd":
            delta = delta.transpose(1, 2)
    else:
        _check_rows("delta", delta, q, (B, H, S))
    q, k, v, do = (_kernel_ready(x) for x in (q, k, v, do))
    return q, k, v, do, lse.contiguous(), delta.contiguous()


def _launch_bwd_dq(ops, causal, scale, layout):
    """dq from ``_bwd_operands``' tuple, by the dq kernel."""
    global BWD_DQ_LAUNCHES
    q, k, v, do, lse, delta = ops
    B, H, S, D, dims = _geometry(q, layout)
    plan = _dq_plan(B, H, S, D, _sm_count(q.device))
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("flash_bwd", "flash_bwd_dq_bf16", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H, S, D,
            _strides(dims, q, k, v, do, dq), scale * _LOG2E, scale,
            int(bool(causal)), plan.block_m, plan.stages, plan.swizzle)
    BWD_DQ_LAUNCHES += 1
    return dq


def _launch_bwd_dkv(ops, causal, scale, layout):
    """(dk, dv) from ``_bwd_operands``' tuple, by the dk/dv kernel."""
    global BWD_DKV_LAUNCHES
    q, k, v, do, lse, delta = ops
    B, H, S, D, dims = _geometry(q, layout)
    plan = _bwd_plan(B, H, S, D, _sm_count(q.device))
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch("flash_bwd", "flash_bwd_dkv_bf16", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, H, S, D, _strides(dims, q, k, v, do, dk, dv), scale * _LOG2E,
            scale, int(bool(causal)), plan.block_n, plan.stages,
            plan.swizzle)
    BWD_DKV_LAUNCHES += 1
    return dk, dv


def _kernel_backward(q, k, v, o, lse, do, causal, scale, layout,
                     delta=None):
    """Launch the two backward kernels; returns (dq, dk, dv) in bf16."""
    ops = _bwd_operands(q, k, v, o, lse, do, layout, delta)
    dq = _launch_bwd_dq(ops, causal, scale, layout)
    dk, dv = _launch_bwd_dkv(ops, causal, scale, layout)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# dispatch + public API
# ---------------------------------------------------------------------------

def _scale(q, sm_scale):
    return sm_scale if sm_scale is not None else q.shape[-1] ** -0.5


def _require_cpu(q):
    if q.device.type != "cpu":
        raise ValueError(f"no flash-attention path for device {q.device}")


def _tr(x):
    return x.transpose(1, 2)


def _forward(q, k, v, causal, sm_scale, layout):
    scale = _scale(q, sm_scale)
    if q.device.type == "cuda":
        return _kernel_forward(q, k, v, causal, scale, layout)
    _require_cpu(q)
    if layout == "bhsd":
        return _reference_attention(q, k, v, scale, causal)
    o, lse = _reference_attention(_tr(q), _tr(k), _tr(v), scale, causal)
    return _tr(o), lse


def _backward(res, do, causal, sm_scale, layout, delta):
    q, k, v, o, lse = res
    scale = _scale(q, sm_scale)
    if q.device.type == "cuda":
        return _kernel_backward(q, k, v, o, lse, do, causal, scale, layout,
                                delta)
    _require_cpu(q)
    if layout == "bhsd":
        return _reference_attention_bwd(q, k, v, o, lse, do, scale, causal,
                                        delta)
    grads = _reference_attention_bwd(_tr(q), _tr(k), _tr(v), _tr(o), lse,
                                     _tr(do), scale, causal, delta)
    return tuple(_tr(g) for g in grads)


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


def _flash_bwd(causal, sm_scale, block_q, block_k, res, do, delta=None):
    """(B, H, S, D) backward with the JAX contract: ``res = (q, k, v, o,
    lse)`` as ``_flash_fwd`` returns it, lse (B, H, S) f32 in natural-log
    units and used as given; ``delta`` (B, H, S) f32, rowsum(do * o) when
    not given.  Returns (dq, dk, dv), each in its input's dtype."""
    return _backward(res, do, causal, sm_scale, "bhsd", delta)


def _flash_bwd_bshd(causal, sm_scale, block_q, block_k, res, do,
                    delta=None):
    """(B, S, H, D) counterpart of ``_flash_bwd``; lse and delta are still
    (B, H, S)."""
    return _backward(res, do, causal, sm_scale, "bshd", delta)


class _FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) in one layout; saves (q, k, v, o, lse) and
    differentiates through ``_flash_bwd``/``_flash_bwd_bshd``, once: the
    kernels' gradients carry no graph, so a second-order gradient raises on
    every device rather than drop the kernels' part on the card."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, block_q, block_k, layout):
        fwd = _flash_fwd if layout == "bhsd" else _flash_fwd_bshd
        o, res = fwd(q, k, v, causal, sm_scale, block_q, block_k)
        ctx.save_for_backward(*res)
        ctx.args = (causal, sm_scale, block_q, block_k)
        ctx.layout = layout
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        bwd = _flash_bwd if ctx.layout == "bhsd" else _flash_bwd_bshd
        dq, dk, dv = bwd(*ctx.args, ctx.saved_tensors, do)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, causal=False, sm_scale=None,
                    block_q=None, block_k=None):
    """Multi-head attention over (batch, heads, seq, head_dim) tensors;
    differentiable."""
    return _FlashAttention.apply(q, k, v, causal, sm_scale, block_q,
                                 block_k, "bhsd")


def flash_attention_bshd(q, k, v, causal=False, sm_scale=None,
                         block_q=None, block_k=None):
    """Multi-head attention over (batch, seq, heads, head_dim) tensors, the
    layout models produce from the fused qkv projection; no transpose is
    made on the card.  Differentiable."""
    return _FlashAttention.apply(q, k, v, causal, sm_scale, block_q,
                                 block_k, "bshd")


def mha(q, k, v, causal=False, sm_scale=None):
    """Attention over (batch, seq, heads, head_dim): alias for
    :func:`flash_attention_bshd`."""
    return flash_attention_bshd(q, k, v, causal, sm_scale)


__all__ = ["flash_attention", "flash_attention_bshd", "mha",
           "_reference_attention", "_reference_attention_bwd"]
