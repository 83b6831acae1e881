"""Ring and Ulysses attention: sequence parallelism over an ``sp`` process
group — counterpart of ``ray_tpu/parallel/ring_attention.py``.

Each rank holds one sequence chunk of q, k, v, (batch, heads, seq_chunk,
head_dim), chunks in rank order along the sequence (the JAX function's
``shard_map`` gives each device the same).

* ``ring_attention`` — K/V chunks travel around the ring of the ``sp``
  group's ranks (rank j sends to j + 1).  The whole forward and backward
  is one ``torch.autograd.Function``, step for step the JAX package's
  ``custom_vjp`` ring, and every chunk-vs-chunk attention goes through the
  same flash functions as single-rank attention (``_flash_fwd`` /
  ``_flash_bwd`` of ``ray_tpu_torch/ops/flash_attention.py``): on CUDA
  tensors the hand-written kernels in the bhsd layout, on CPU tensors
  their plain versions.

  - each step's kernel returns (o_i, lse_i) partials, and a running
    max-lse merge combines them, so the (Sq, S) score matrix never exists;
  - the next step's K/V hop is posted before this step's kernel and waited
    for after it, so the transfer overlaps the kernel; the received chunks
    land in fresh buffers (double buffering), and the hop after the last
    step, which would feed nothing, is not made;
  - with ``causal``, a chunk wholly in the future (source rank > this
    rank) is skipped: rank r runs r + 1 steps; the diagonal step runs the
    causal kernel and earlier chunks the non-causal one;
  - the backward hands every chunk's kernels the *global* lse and o of the
    q chunk and delta = rowsum(do * o), computed once; dq accumulates
    locally, and f32 dk/dv accumulators travel with their K/V chunk, each
    rank adding its contribution, until after n hops they are back with
    the chunk's owner (that last hop is required).

* ``ulysses_attention`` — tiled all-to-all from sequence chunks to head
  groups, ``flash_attention`` over the whole sequence of H/n heads, and
  the all-to-all back.

``ring_attention_sharded`` takes the rank's chunks; with no ``sp`` axis
over 1 in the mesh it is plain ``flash_attention``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ray_tpu_torch.collective import axis_group, c10d, exchange
from ray_tpu_torch.ops.flash_attention import (_flash_bwd, _flash_fwd,
                                               flash_attention)
from ray_tpu_torch.parallel.context import use_mesh
from ray_tpu_torch.parallel.mesh import mesh_axis_size

_NEG_INF = -1e30


def _chunk_fwd(q, k, v, scale, causal_step):
    """One chunk-vs-chunk attention partial: (o normalized, in f32; lse
    natural-log).  ``causal_step`` only on the diagonal step, where q and
    k hold the same positions."""
    o, (_, _, _, _, lse) = _flash_fwd(q, k, v, causal_step, scale, None, None)
    return o.float(), lse


def _chunk_bwd(q, k, v, o, lse, do, scale, causal_step, delta):
    """dq, dk, dv of one chunk-vs-chunk step, given the GLOBAL lse and o of
    the q chunk (globally normalized probabilities) and delta = rowsum(do
    * o), which depends on the q side only."""
    return _flash_bwd(causal_step, scale, None, None, (q, k, v, o, lse), do,
                      delta=delta)


def _merge(num, m, den, o_i, lse_i):
    """Fold one partial (o_i, lse_i) into the running (num, m, den): m the
    running max of the lse's, num and den the partials' o and weight
    rescaled to it.  A partial or state at -inf (lse <= _NEG_INF / 2: a
    skipped step, or no step yet) weighs 0 rather than exp(-inf + inf)."""
    lse_col = lse_i[..., None]
    m_new = torch.maximum(m, lse_col)
    m_safe = torch.where(m_new <= _NEG_INF / 2, 0.0, m_new)
    alpha = torch.where(m <= _NEG_INF / 2, 0.0, torch.exp(m - m_safe))
    w = torch.where(lse_col <= _NEG_INF / 2, 0.0, torch.exp(lse_col - m_safe))
    return num * alpha + o_i * w, m_new, den * alpha + w


def _ring_hop(a, b, group, tag):
    """Post a and b to the next rank and receive the previous rank's."""
    n, my = group.size(), group.rank()
    nxt, prev = (my + 1) % n, (my - 1) % n
    return exchange([(a, nxt), (b, nxt)], [(prev, a), (prev, b)], group, tag)


def _ring_fwd(q, k, v, group, causal, sm_scale):
    B, H, Sq, D = q.shape
    scale = sm_scale if sm_scale is not None else D ** -0.5
    n, my = group.size(), group.rank()
    # send buffers: one contiguous copy of the (possibly strided) chunks
    k, v = k.contiguous(), v.contiguous()
    num = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Sq, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    den = torch.zeros((B, H, Sq, 1), dtype=torch.float32, device=q.device)
    kc, vc = k, v
    for i in range(n):
        src = (my - i) % n
        # the next chunk's hop is posted before this step's kernel, which
        # does not depend on it
        hop = _ring_hop(kc, vc, group, 0) if i < n - 1 else None
        if not (causal and src > my):
            o_i, lse_i = _chunk_fwd(q, kc, vc, scale, causal and src == my)
            num, m, den = _merge(num, m, den, o_i, lse_i)
        if hop is not None:
            kc, vc = hop.wait()
    den_safe = torch.where(den == 0.0, 1.0, den)
    o = (num / den_safe).to(q.dtype)
    # global lse for the backward: log(sum_i exp(lse_i)) = m + log(den)
    lse = (m + torch.log(den_safe))[..., 0]
    return o, (q, k, v, o, lse)


def _ring_bwd(group, causal, sm_scale, res, do):
    q, k, v, o, lse = res
    D = q.shape[-1]
    scale = sm_scale if sm_scale is not None else D ** -0.5
    n, my = group.size(), group.rank()
    delta = (do.float() * o.float()).sum(-1)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk_acc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv_acc = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    kc, vc, acc_hop = k, v, None
    for i in range(n):
        src = (my - i) % n
        hop = _ring_hop(kc, vc, group, 0) if i < n - 1 else None
        grads = None
        if not (causal and src > my):
            grads = _chunk_bwd(q, kc, vc, o, lse, do, scale,
                               causal and src == my, delta)
        if acc_hop is not None:
            # the accumulators that travel with (kc, vc)
            dk_acc, dv_acc = acc_hop.wait()
        if grads is not None:
            dq_i, dk_i, dv_i = grads
            dq_acc = dq_acc + dq_i.float()
            dk_acc = dk_acc + dk_i.float()
            dv_acc = dv_acc + dv_i.float()
        # the accumulators move on with their chunk; after the n-th hop they
        # are back with its owner
        acc_hop = _ring_hop(dk_acc, dv_acc, group, 2)
        if hop is not None:
            kc, vc = hop.wait()
    dk_acc, dv_acc = acc_hop.wait()
    return dq_acc.to(q.dtype), dk_acc.to(k.dtype), dv_acc.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    """The ring's forward and its hand-written backward, once
    differentiable (the kernels' gradients carry no graph).  Every rank of
    the group enters both together."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, sm_scale):
        o, res = _ring_fwd(q, k, v, group, causal, sm_scale)
        ctx.save_for_backward(*res)
        ctx.args = (group, causal, sm_scale)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        dq, dk, dv = _ring_bwd(*ctx.args, ctx.saved_tensors, do)
        return dq, dk, dv, None, None, None


def ring_attention(q, k, v, axis_name: str = "sp", causal: bool = True,
                   sm_scale: Optional[float] = None):
    """Attention over sequence-sharded q, k, v: this rank's chunks, (batch,
    heads, seq_chunk, head_dim), over the process group of the bound
    mesh's ``axis_name``.  Differentiable."""
    group = axis_group(axis_name)
    if group.size() == 1:
        return flash_attention(q, k, v, causal, sm_scale)
    return _RingAttention.apply(q, k, v, group, causal, sm_scale)


def ring_attention_sharded(q, k, v, mesh, causal: bool = True,
                           sm_scale: Optional[float] = None,
                           variant: str = "ring"):
    """q, k, v: this rank's (batch, heads, seq, head_dim) chunks, the
    sequence sharded on the ``sp`` axis of ``mesh``.  The heads are the
    rank's own: under tensor parallelism its tp share (n_head / tp, its
    head group's q, k and v), which the ring over sp treats as any heads
    and Ulysses splits over sp, so (n_head / tp) % sp must be 0.
    ``variant`` "ring" or "ulysses"; with no ``sp`` axis over 1, plain
    ``flash_attention``."""
    if mesh_axis_size(mesh, "sp") <= 1:
        return flash_attention(q, k, v, causal, sm_scale)
    inner = ring_attention if variant == "ring" else ulysses_attention
    with use_mesh(mesh):
        return inner(q, k, v, "sp", causal, sm_scale)


def ulysses_attention(q, k, v, axis_name: str = "sp", causal: bool = True,
                      sm_scale: Optional[float] = None):
    """All-to-all (DeepSpeed-Ulysses style) sequence parallelism.  Per rank
    in: (B, H, S/n, D); reshards to (B, H/n, S, D), runs flash attention,
    and reshards back."""
    H = q.shape[1]
    n = axis_group(axis_name).size()
    if H % n:
        raise ValueError(f"num heads {H} must divide by sp axis size {n}")

    def to_heads(x):
        # (B, H, S/n, D) -> (B, H/n, S, D)
        return c10d.alltoall(x, axis_name, split_axis=1, concat_axis=2)

    def to_seq(x):
        # (B, H/n, S, D) -> (B, H, S/n, D)
        return c10d.alltoall(x, axis_name, split_axis=2, concat_axis=1)

    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
    oh = flash_attention(qh, kh, vh, causal, sm_scale)
    return to_seq(oh)
