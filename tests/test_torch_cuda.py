"""The CUDA flash-attention kernels on the card, against their plain
versions, and a GPT-2 train step through them.

Marked ``cuda``: every test skips where there is no CUDA device.  On a
machine with one (no JAX needed, hence ``--noconftest``):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import ctypes
import math
from dataclasses import replace

import pytest
import torch

from chip_smoke import G_PTOL, G_RTOL, bwd_magnitudes
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

# o, as in chip_smoke.py: both round o to bf16 (<= 2^-8 |o| apart), and the
# kernel rounds p to bf16 before p@v (<= 2^-9 P@|v|, which can exceed |o|
# where the terms of a row cancel); each held with 2x room
O_RTOL, O_PTOL = 1e-2, 2.0 ** -8
# lse: f32 on both sides from exact bf16 products; summation order only
LSE_TOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _plain(q, k, v, causal, layout):
    """The plain version's (o, lse) and its o tolerance per element."""
    tr = (lambda t: t.transpose(1, 2)) if layout == "bshd" else (lambda t: t)
    scale = q.shape[-1] ** -0.5
    o, lse = fa._reference_attention(tr(q), tr(k), tr(v), scale, causal)
    o_mag, _ = fa._reference_attention(tr(q), tr(k), tr(v).abs(), scale,
                                       causal)
    tol = O_RTOL * o.float().abs() + O_PTOL * o_mag.float()
    return tr(o), lse, tr(tol)


@pytest.fixture(params=[64, 128], ids=["rows64", "rows128"])
def plan_rows(request, monkeypatch):
    """Force the forward's and the dk/dv kernel's plans: 64-row blocks (a
    card of many SMs) or 128-row blocks, two consumer warpgroups (a card
    of one SM)."""
    sms = 10 ** 9 if request.param == 64 else 1
    monkeypatch.setattr(fa, "_sm_count", lambda device: sms)
    return request.param


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S", [1, 63, 65, 200, 1000])
def test_kernel_matches_plain(cuda, plan_rows, S, D, causal, layout):
    B, H = 2, 3
    assert fa._fwd_plan(B, H, S, D, fa._sm_count(None)).block_m == plan_rows
    shape = (B, S, H, D) if layout == "bshd" else (B, H, S, D)
    q, k, v = (torch.randn(shape, generator=cuda, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    fwd = fa._flash_fwd_bshd if layout == "bshd" else fa._flash_fwd
    before = fa.KERNEL_LAUNCHES
    o, (_, _, _, _, lse) = fwd(q, k, v, causal, None, None, None)
    torch.cuda.synchronize()
    assert fa.KERNEL_LAUNCHES == before + 1
    o_ref, lse_ref, o_tol = _plain(q, k, v, causal, layout)
    assert o.dtype == torch.bfloat16 and lse.shape == (B, H, S)
    assert ((o.float() - o_ref.float()).abs() <= o_tol).all()
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL


def test_strided_and_misaligned_inputs(cuda):
    base = torch.randn((1, 70, 4, 65), generator=cuda, device="cuda",
                       dtype=torch.bfloat16)
    q = base[..., 1:]  # rows not 16-byte aligned: the wrapper copies
    k, v = (torch.randn((1, 4, 70, 64), generator=cuda, device="cuda",
                        dtype=torch.bfloat16).transpose(1, 2)  # bhsd memory
            for _ in range(2))
    o = fa.flash_attention_bshd(q, k, v, True)
    ref = fa.flash_attention_bshd(q.contiguous(), k.contiguous(),
                                  v.contiguous(), True)
    torch.testing.assert_close(o, ref, atol=0, rtol=0)


def test_zero_stride_inputs(cuda, plan_rows):
    """k and v broadcast along the batch (stride 0), as an expand gives
    them, give what their contiguous copies give, bit for bit."""
    q = torch.randn((3, 130, 4, 64), generator=cuda, device="cuda",
                    dtype=torch.bfloat16)
    k, v = (torch.randn((1, 130, 4, 64), generator=cuda, device="cuda",
                        dtype=torch.bfloat16).expand(3, 130, 4, 64)
            for _ in range(2))
    assert k.stride(0) == 0
    for causal in (False, True):
        o, (*_, lse) = fa._flash_fwd_bshd(q, k, v, causal, None, None, None)
        o2, (*_, lse2) = fa._flash_fwd_bshd(q, k.contiguous(), v.contiguous(),
                                            causal, None, None, None)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_refused_launch_and_tensor_map_raise(cuda):
    """A launch the card refuses (a grid of 65536 batches in y) and a
    tensor map the encoder refuses (rows 8 bytes apart; TMA needs multiples
    of 16) each reach RuntimeError; nothing runs in their place."""
    x = torch.zeros((65536, 1, 1, 32), device="cuda", dtype=torch.bfloat16)
    before = fa.KERNEL_LAUNCHES
    with pytest.raises(RuntimeError, match="launch failed: CUDA error"):
        fa._flash_fwd_bshd(x, x, x, False, None, None, None)
    assert fa.KERNEL_LAUNCHES == before
    q = torch.zeros((1, 8, 1, 32), device="cuda", dtype=torch.bfloat16)
    lse = torch.empty((1, 1, 8), device="cuda")
    strides = (ctypes.c_int64 * 12)(*[256, 4, 32] * 4)
    with pytest.raises(RuntimeError, match="tensor map refused"):
        fa._launch("flash_fwd", "flash_fwd_bf16", q.device, q.data_ptr(),
                   q.data_ptr(), q.data_ptr(), q.data_ptr(), lse.data_ptr(),
                   1, 1, 8, 32, strides, 1.0, 0, 64, 3, 64)


def test_unsupported_inputs_raise(cuda):
    x = torch.zeros((1, 8, 2, 64), device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention_bshd(x, x, x)
    y = torch.zeros((1, 8, 2, 48), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 48"):
        fa.flash_attention_bshd(y, y, y)


def test_gpt2_tiny_flash_matches_dense(cuda):
    cfg = gpt2.GPT2_TINY
    params = gpt2.init_params(cuda, cfg, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 100), generator=cuda,
                           device="cuda")
    before = fa.KERNEL_LAUNCHES
    flash = gpt2.forward(params, tokens, cfg)
    assert fa.KERNEL_LAUNCHES == before + cfg.n_layer
    dense = gpt2.forward(params, tokens, replace(cfg, attention="dense"))
    # bf16 activations: ~1 ulp of attention output per layer (chip_smoke.py)
    assert (flash - dense).abs().max().item() <= 0.1


def _bwd_case(cuda, shape, causal, layout):
    q, k, v, do = (torch.randn(shape, generator=cuda, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    fwd = fa._flash_fwd_bshd if layout == "bshd" else fa._flash_fwd
    o, res = fwd(q, k, v, causal, None, None, None)
    return res, do


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S", [1, 63, 65, 200, 1000])
def test_bwd_kernels_match_plain(cuda, plan_rows, S, D, causal, layout):
    """dq, dk, dv of the two backward kernels within chip_smoke.py's
    per-element bound of the plain backward on the same (o, lse, do), at
    both dk/dv plans (64-row blocks only at D = 128); S = 1000 walks 16 q
    tiles, round the 4-slot ring four times, the last one ragged."""
    B, H = 2, 3
    rows = fa._bwd_plan(B, H, S, D, fa._sm_count(None)).block_n
    assert rows == (64 if D == 128 else plan_rows)
    shape = (B, S, H, D) if layout == "bshd" else (B, H, S, D)
    res, do = _bwd_case(cuda, shape, causal, layout)
    bwd = fa._flash_bwd_bshd if layout == "bshd" else fa._flash_bwd
    before = (fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)
    grads = bwd(causal, None, None, None, res, do)
    torch.cuda.synchronize()
    assert (fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES) == (before[0] + 1,
                                                         before[1] + 1)
    tr = (lambda t: t.transpose(1, 2)) if layout == "bshd" else (
        lambda t: t)
    q, k, v, o, lse = res
    qh, kh, vh, oh, doh = (tr(t) for t in (q, k, v, o, do))
    scale = D ** -0.5
    ref = fa._reference_attention_bwd(qh, kh, vh, oh, lse, doh, scale,
                                      causal)
    mags = bwd_magnitudes(qh, kh, vh, oh, lse, doh, scale, causal)
    for name, g, r, m in zip(("dq", "dk", "dv"), grads, ref, mags):
        assert g.dtype == torch.bfloat16 and g.shape == shape
        tol = G_RTOL * r.float().abs() + G_PTOL[name] * m
        assert ((tr(g).float() - r.float()).abs() <= tol).all(), name


def test_bwd_given_lse_and_delta_are_used(cuda):
    """Ring attention's contract on the card: a shifted lse and a given
    delta reach the kernels as they are."""
    res, do = _bwd_case(cuda, (1, 2, 130, 64), True, "bhsd")
    q, k, v, o, lse = res
    delta = torch.randn(lse.shape, generator=cuda, device="cuda")
    shifted = (q, k, v, o, lse + 0.25)
    grads = fa._flash_bwd(True, None, None, None, shifted, do, delta)
    ref = fa._reference_attention_bwd(q, k, v, o, lse + 0.25, do, 0.125,
                                      True, delta)
    for g, r in zip(grads, ref):
        err = (g.float() - r.float()).abs().max().item()
        assert err <= 0.05 * r.float().abs().max().item()


def test_bwd_strided_do_and_determinism(cuda):
    """A do expanded from o.sum() (zero strides) and a transposed do give
    the gradients of their contiguous copies, bit for bit; two runs agree
    bit for bit (no atomics)."""
    res, do = _bwd_case(cuda, (2, 70, 4, 64), True, "bshd")
    bwd = lambda d: fa._flash_bwd_bshd(True, None, None, None, res, d)  # noqa: E731
    ones = torch.ones((), device="cuda", dtype=torch.bfloat16).expand(
        do.shape)
    views = (ones, do.transpose(1, 2).contiguous().transpose(1, 2))
    for d in views:
        for a, b in zip(bwd(d), bwd(d.contiguous())):
            assert torch.equal(a, b)
    for a, b in zip(bwd(do), bwd(do)):
        assert torch.equal(a, b)


def test_bwd_unsupported_inputs_raise(cuda):
    res, do = _bwd_case(cuda, (1, 8, 2, 64), True, "bshd")
    q, k, v, o, lse = res
    with pytest.raises(TypeError, match="bfloat16"):
        fa._flash_bwd_bshd(True, None, None, None, res, do.half())
    with pytest.raises(TypeError, match="lse must be float32"):
        fa._flash_bwd_bshd(True, None, None, None,
                           (q, k, v, o, lse.double()), do)


def test_autograd_through_kernels(cuda):
    """requires_grad bf16 inputs on the card go through both backward
    kernels and get the plain backward's gradients."""
    q, k, v = (torch.randn((2, 100, 3, 64), generator=cuda, device="cuda",
                           dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    before = fa.BWD_DQ_LAUNCHES
    fa.flash_attention_bshd(q, k, v, True).float().square().sum().backward()
    assert fa.BWD_DQ_LAUNCHES == before + 1
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


def test_gpt2_tiny_train_step_on_card(cuda):
    """GPT2_TINY widths on the card: AdamW steps through the kernels, n_layer
    launches of each kernel per step, the loss falls."""
    cfg = gpt2.GPT2_TINY
    params = gpt2.init_params(cuda, cfg, device="cuda")
    for leaf in gpt2.param_leaves(params):
        leaf.requires_grad_(True)
    opt = torch.optim.AdamW(gpt2.param_leaves(params), lr=1e-3,
                            weight_decay=0.1)
    step = gpt2.make_train_step(cfg, opt)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 101),
                                     generator=cuda, device="cuda")}
    before = (fa.KERNEL_LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)
    losses = [step(params, batch)["loss"].item() for _ in range(5)]
    after = (fa.KERNEL_LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)
    assert [a - b for a, b in zip(after, before)] == [5 * cfg.n_layer] * 3
    assert all(map(math.isfinite, losses)) and losses[-1] < losses[0]
