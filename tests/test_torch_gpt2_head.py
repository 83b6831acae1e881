"""The tied lm head of ray_tpu_torch.models.gpt2 (``_lm_head``, through
``ray_tpu_torch.ops.lm_head``) on the CPU: bf16 operands against the f32
product of the up-cast operands, which the head computed for them before.

The forward's products of two bf16 values are exact in f32, so its logits
equal the f32 path's; on the CPU both are the same f32 GEMM, bit for bit.
The backward carries the f32 cotangent g as two bf16 parts, hi = bf16(g)
and lo = bf16(g - hi), |g - hi - lo| <= 2^-16 |g|: each gradient element
then differs from the f32 path's by at most 2^-16 of the sum of its terms'
magnitudes (sum_n |g| |x| for dwte), before both round to bf16; the
contractions cut into chunks change only the order of the f32 sums.  The
Triton kernel of the split runs on the card only (``chip_smoke.py``'s
phase 2 holds it against the plain version there, bit for bit)."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import gpt2
from ray_tpu_torch.ops import lm_head

# the split's error, relative to each element
SPLIT_REL = 2.0 ** -16
# the gradients' relative norm gap before their bf16 rounding: the split
# gives at most 2^-16 of the terms' magnitudes; 2^-14 leaves 4x for f32
# sums in another order and for cancellation
GRAD_NORM_REL = 2.0 ** -14
# after the bf16 rounding, elements equal to the f32 path's
BIT_EQUAL_SHARE = 0.98


def _draw(shape, seed, decades=False):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape)
    if decades:  # magnitudes from 1e-30 to 1e10, some exact zeros
        a *= 10.0 ** rng.uniform(-30, 10, shape)
        a[rng.random(shape) < 0.01] = 0.0
    return torch.from_numpy(a.astype(np.float32))


@pytest.mark.parametrize("v", [1001, 1024], ids=["odd", "multiple-of-8"])
def test_split_parts_hold_f32_within_2_pow_16(v):
    g = _draw((37, v), 0, decades=True)
    vp = lm_head.padded_vocab(v)
    parts = lm_head.split_parts(g, vp)
    assert parts.shape == (37, 2 * vp) and parts.dtype == torch.bfloat16
    p = parts.view(37, 2, vp).float()
    hi, lo = p[:, 0, :v], p[:, 1, :v]
    assert torch.equal(hi, g.bfloat16().float())
    err = (g - hi - lo).abs()
    assert (err <= SPLIT_REL * g.abs()).all()
    assert (p[:, :, v:] == 0).all()  # the pad the GEMMs contract over


def _operands(n, e, v, seed):
    x = _draw((n, e), seed).bfloat16()
    wte = (0.02 * _draw((v, e), seed + 1)).bfloat16()
    g = 1e-3 * _draw((n, v), seed + 2)
    return x, wte, g


def _head_grads(g, x, wte, chunks=lm_head.HEAD_CHUNKS):
    """``lm_head.head_grads`` on wte padded as ``tied_head`` pads it: (dx,
    dwte), dwte without the pad's rows, which must be 0."""
    v = wte.shape[0]
    wp = lm_head.pad_rows(wte, lm_head.padded_vocab(v))
    dx, dw = lm_head.head_grads(g, x, wp, chunks)
    assert (dw[v:] == 0).all()
    return dx, dw[:v]


@pytest.mark.parametrize("n,e,v", [(256, 64, 1001), (200, 48, 512),
                                   (201, 40, 999)])
def test_head_grads_against_the_f32_path(n, e, v):
    """dx and dwte from the parts against the f32 products of the up-cast
    operands: by norm before the bf16 cast; after it, most elements equal
    and the rest within one bf16 ulp of the f32 path's value, or within
    the split's bound where the element's terms cancel."""
    x, wte, g = _operands(n, e, v, 1)
    dx, dw = _head_grads(g, x, wte)
    dx0, dw0 = g @ wte.float(), g.T @ x.float()
    bounds = (g.abs() @ wte.float().abs(), g.T.abs() @ x.float().abs())
    for got, want, terms in zip((dx, dw), (dx0, dw0), bounds):
        assert got.shape == want.shape and got.dtype == torch.float32
        gap = ((got - want).norm() / want.norm()).item()
        assert gap <= GRAD_NORM_REL, gap
        a, b = got.bfloat16().float(), want.bfloat16().float()
        assert (a == b).float().mean().item() >= BIT_EQUAL_SHARE
        ulp = torch.finfo(torch.bfloat16).eps * b.abs()
        assert ((a - b).abs() <= torch.maximum(
            ulp, 2 * SPLIT_REL * terms)).all()


@pytest.mark.parametrize("chunks", [1, 2])
def test_head_grads_in_fewer_chunks(chunks):
    """Fewer chunks of dx's contraction change only the order of the f32
    sums: within the f32 path's bound, and near the default chunks'."""
    x, wte, g = _operands(256, 64, 1001, 7)
    got = _head_grads(g, x, wte, chunks)
    default = _head_grads(g, x, wte)
    for a, b, want in zip(got, default, (g @ wte.float(),
                                         g.T @ x.float())):
        assert ((a - want).norm() / want.norm()).item() <= GRAD_NORM_REL
        assert ((a - b).norm() / b.norm()).item() <= 2.0 ** -20


@pytest.mark.parametrize("v", [1, 50257, 50272])
def test_padded_vocab_aligns_each_chunk(v):
    """Rows padded to a multiple of 8 per chunk: each chunk of a bf16 row
    starts on 16 bytes; no more than one such multiple is added."""
    vp = lm_head.padded_vocab(v)
    step = 8 * lm_head.HEAD_CHUNKS
    assert vp >= v and vp % step == 0 and vp - v < step
    assert (vp // lm_head.HEAD_CHUNKS * 2) % 16 == 0


@pytest.mark.parametrize("v", [1001, 512])
def test_forward_equals_the_f32_path_bit_for_bit(v):
    x = _draw((3, 50, 64), 3).bfloat16()
    wte = _draw((v, 64), 4).bfloat16()
    logits = gpt2._lm_head(x, wte)
    assert logits.shape == (3, 50, v) and logits.dtype == torch.float32
    assert torch.equal(logits, torch.matmul(x.float(), wte.float().T))


@pytest.mark.parametrize("sliced", [False, True],
                         ids=["contiguous", "vocab-block-of-cotangent"])
def test_autograd_gives_the_head_grads_in_bf16(sliced):
    """The backward through autograd returns ``head_grads`` cast to the
    operands' bf16, for a 3-d x and for a cotangent that is a block of a
    wider one's columns (a tp rank's block of ``_GatherWhole``'s)."""
    x, wte, g = _operands(120, 32, 1001, 5)
    xs = x.view(4, 30, 32).requires_grad_()
    ws = wte.clone().requires_grad_()
    if sliced:
        g = torch.cat([g, _draw((120, 77), 6)], 1)[:, :1001]
    dx, dw = torch.autograd.grad(gpt2._lm_head(xs, ws), (xs, ws),
                                 g.view(4, 30, 1001))
    want_dx, want_dw = _head_grads(g, x, wte)
    assert dx.dtype == dw.dtype == torch.bfloat16
    assert torch.equal(dx, want_dx.bfloat16().view(4, 30, 32))
    assert torch.equal(dw, want_dw.bfloat16())


@pytest.mark.parametrize("xent_chunks", [0, 4], ids=["dense", "chunked"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_head_path_counts(dtype, xent_chunks):
    """bf16 operands take the parts path and f32 operands the f32 one, in
    the dense and the chunked loss (whose checkpointed chunks run the head
    again in the backward) and in ``forward``."""
    cfg = replace(gpt2.GPT2_TINY, compute_dtype=dtype, vocab_size=509)
    params = gpt2.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    for leaf in gpt2.param_leaves(params):
        leaf.requires_grad_(True)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 33)))
    path, other = (("bf16_parts", "f32") if dtype == torch.bfloat16
                   else ("f32", "bf16_parts"))
    gpt2.head_path_counts(reset=True)
    loss = gpt2.loss_fn(gpt2._cast_weights(params, dtype),
                        {"tokens": tokens}, cfg, xent_chunks=xent_chunks)
    loss.backward()
    calls = 2 * xent_chunks if xent_chunks else 1
    assert gpt2.head_path_counts(reset=True) == {path: calls, other: 0}
    assert all(torch.isfinite(p.grad).all()
               for p in gpt2.param_leaves(params))
    with torch.no_grad():
        logits = gpt2.forward(params, tokens, cfg)
    assert logits.shape == (2, 33, 509)
    assert gpt2.head_path_counts() == {path: 1, other: 0}
