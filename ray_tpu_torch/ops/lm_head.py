"""A tied lm head on bf16 operands: f32 logits from bf16 tensor-core GEMMs.

``tied_head(x, wte, v)`` computes logits = x wte^T for bf16 x (..., E)
and wte (V, E) with f32 sums into f32 logits.  A product of two bf16
values is exact in f32, so these are the products of the f32 GEMM of the
up-cast operands, summed in another order; on the CPU it is that f32 GEMM.

The backward (``head_grads``) takes the f32 cotangent g as two bf16 parts,
hi = bf16(g) and lo = bf16(g - hi) (``split_parts``), which hold it to
|g - hi - lo| <= 2^-16 |g|, 256 times below the bf16 rounding of the
gradients they make.  dx = hi wte + lo wte and dwte = hi^T x + lo^T x are
bf16 GEMMs with f32 sums, each part's product on its own and summed in
f32, since an H100's tensor cores lose bits as an f32 accumulation grows:
over dx's 2 x 50264 terms in one GEMM they moved dx by 1.6e-4 of its norm.
dx's vocabulary is cut further into ``HEAD_CHUNKS`` chunks (~12.5k terms
at GPT-2's, 1.5e-5 of dx's norm); dwte contracts the N rows (16384 at
B = 16, S = 1024), within 2^-14 as they are.

The vocabulary is padded with zero rows of wte to ``padded_vocab(V)``, a
multiple of 8 x ``HEAD_CHUNKS``: cuBLAS takes its TMA kernels only where
every row stride is a multiple of 16 bytes (GPT-2's V = 50257 ran the
GEMMs on older kernels at a third to a seventh of the rate), and each
chunk of a padded row starts on such a boundary.  The logits are the view
of the first V columns of the padded product.

``split_parts`` is a Triton kernel on the card (built at its first
launch; ``SPLIT_LAUNCHES`` counts its launches) and ``split_parts_plain``
on the CPU.  It replaces no TPU kernel: the JAX head multiplies bf16
operands whose cotangent XLA rounds itself.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: chunks of dx's contraction (the padded vocabulary of each part), each
#: a GEMM of one batch, summed in f32
HEAD_CHUNKS = 4

#: launches of the Triton kernel of ``split_parts`` in this process
SPLIT_LAUNCHES = 0
_SPLIT_KERNEL = None


def padded_vocab(v: int) -> int:
    """v rounded up to a multiple of 8 x ``HEAD_CHUNKS``: rows and each
    chunk of a row start on 16 bytes in bf16."""
    m = 8 * HEAD_CHUNKS
    return -(-v // m) * m


def pad_rows(w, rows: int):
    """w (V, E) with zero rows appended up to ``rows``."""
    return w if rows == w.shape[0] else F.pad(w, (0, 0, 0, rows - w.shape[0]))


def mm_f32(a, b):
    """a @ b of bf16 matrices with f32 sums and an f32 result: a bf16
    tensor-core GEMM on the card (``aten::mm.dtype``); on the CPU an f32
    GEMM of the up-cast operands, whose products are the same (exact)."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def bmm_f32(a, b):
    """``mm_f32`` over a batch: (c, m, k) @ (c, k, n) -> (c, m, n) f32."""
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def split_parts_plain(g, vp: int):
    """The plain version of ``split_parts``."""
    n, v = g.shape
    parts = g.new_zeros((n, 2, vp), dtype=torch.bfloat16)
    hi = g.to(torch.bfloat16)
    parts[:, 0, :v] = hi
    parts[:, 1, :v] = g - hi.float()  # exact in f32; the copy rounds it
    return parts.view(n, 2 * vp)


def _split_kernel():
    """The Triton kernel of ``split_parts``, built at its first launch:
    row r of g (f32, row stride ``stride_g``) to row r of the parts,
    ``BLOCK`` columns a program."""
    global _SPLIT_KERNEL
    if _SPLIT_KERNEL is None:
        import triton
        import triton.language as tl

        @triton.jit
        def split(g_ptr, p_ptr, V, VP, stride_g, BLOCK: tl.constexpr):
            row = tl.program_id(0).to(tl.int64)
            col = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
            d = tl.load(g_ptr + row * stride_g + col, mask=col < V,
                        other=0.0)
            hi = d.to(tl.bfloat16)  # round to nearest even, as torch's
            lo = (d - hi.to(tl.float32)).to(tl.bfloat16)
            out = p_ptr + row * (2 * VP) + col
            tl.store(out, hi, mask=col < VP)
            tl.store(out + VP, lo, mask=col < VP)

        _SPLIT_KERNEL = split
    return _SPLIT_KERNEL


def split_parts(g, vp: int):
    """g (N, V) f32 as (N, 2 vp) bf16 parts, each row [hi | lo] with
    hi = bf16(g), lo = bf16(g - hi) and zeros past V in each half:
    |g - hi - lo| <= 2^-16 |g|.  On the card one Triton pass, which reads
    4 and writes 4 bytes an element, so the bandwidth bounds it; on the
    CPU the plain version."""
    global SPLIT_LAUNCHES
    if not g.is_cuda:
        return split_parts_plain(g, vp)
    if g.stride(1) != 1:
        g = g.contiguous()
    n, v = g.shape
    parts = torch.empty((n, 2 * vp), device=g.device, dtype=torch.bfloat16)
    block = 2048
    _split_kernel()[(n, -(-vp // block))](g, parts, v, vp, g.stride(0),
                                          BLOCK=block, num_warps=8)
    SPLIT_LAUNCHES += 1
    return parts


def head_grads(g, x, wp, chunks: int = HEAD_CHUNKS):
    """The f32 gradients (dx (N, E), dwp (vp, E)) of logits = x wp^T from
    the f32 cotangent g (N, V) of its first V columns; x (N, E) and wp
    (vp, E) bf16, wp's rows past V zero.  Each part's dx contracts the
    padded vocabulary in ``chunks`` chunks (a divisor of vp), one batched
    bf16 GEMM with f32 sums; dwp contracts each part's N rows in one GEMM.
    All are summed in f32.  dwp's rows past V are 0."""
    n, (vp, e) = g.shape[0], wp.shape
    hi, lo = split_parts(g, vp).view(n, 2, vp).unbind(1)  # row stride 2 vp
    wc = wp.view(chunks, vp // chunks, e)
    dx = bmm_f32(hi.view(n, chunks, -1).transpose(0, 1), wc).sum(0)
    dx += bmm_f32(lo.view(n, chunks, -1).transpose(0, 1), wc).sum(0)
    dw = mm_f32(hi.T, x)
    dw += mm_f32(lo.T, x)
    return dx, dw


class TiedHead(torch.autograd.Function):
    """logits (..., v) f32 = x wp^T over wp's first v rows, for bf16 x
    (..., E) and wp (vp, E) whose rows past v are zero (``tied_head``).
    The forward is ``mm_f32`` over the padded rows; the backward is
    ``head_grads``, rounded once to bf16 (the dtype autograd gave the
    gradients of the f32 product of the up-cast operands)."""

    @staticmethod
    def forward(ctx, x, wp, v):
        ctx.save_for_backward(x, wp)
        logits = mm_f32(x.reshape(-1, x.shape[-1]), wp.T)
        return logits[:, :v].view(*x.shape[:-1], v)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, wp = ctx.saved_tensors
        dx, dw = head_grads(g.reshape(-1, g.shape[-1]),
                            x.reshape(-1, x.shape[-1]), wp)
        return dx.to(x.dtype).view(x.shape), dw.to(wp.dtype), None


def tied_head(x, wte, v: int):
    """The f32 logits (..., v) of bf16 x (..., E) against the first v rows
    of bf16 wte, whose rows past v (if any: ``pad_rows`` to
    ``padded_vocab(v)``, done once by a caller that calls this often) are
    zero."""
    return TiedHead.apply(x, pad_rows(wte, padded_vocab(v)), v)
