"""The CUDA flash-attention kernels on the card, against their plain
versions, a GPT-2 train step through them, a small Llama whose
uncached forward runs the forward kernel, ring attention's steps and a
two-rank ring (gloo, both ranks on the card) through them, a two-stage
pipeline of both ranks on the card, a tp rank's heads as strided views of
its qkv buffer, a two-rank tensor-parallel GPT-2 forward, and the MoE over
two ranks: its experts on ep, and its routing with the global capacity
under dp; GPT-2 XL's attention shape on an fsdp = 2 rank and a two-rank
fsdp train step; the MoE at pp = 2 x dp = 2 on four ranks, each routing its
block of every global microbatch; one update of each RL learner (IMPALA
with the Nature-CNN on a short rollout, PPO, DQN, SAC, BC) and an MNIST
step against the port's CPU path; the runtime's serializer on card tensors,
alone and nested in a GPU task's result that a CPU task reads; a GPU
Serve deployment of GPT-2 at ``GPT2_TINY`` widths; a checkpoint of a
``state_dict`` on the card, batches staged onto the card by
``iter_torch_batches`` (and its default raising where the card is hidden),
a ``TorchTrainer`` training GPT-2 at ``GPT2_TINY`` widths on the card, a
``Cluster`` node given the card running a GPU task (and one that hides
it failing), a Tune sweep under ASHA whose trials train GPT-2 at
``GPT2_TINY`` widths (2 layers) on the card, and IMPALA's ``Algorithm`` in
a Tune trial with its learner on the card against the CPU learner; a
workflow whose GPU step's bf16 tensor is checkpointed on the host.

Marked ``cuda``: every test skips where there is no CUDA device.  On a
machine with one (no JAX needed, hence ``--noconftest``):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import ctypes
import math
from dataclasses import replace

import pytest
import torch

from chip_smoke import (G_PTOL, G_RTOL, LOGITS_TOL, MOE_GRAD_REL_TOL,
                        MOE_LOSS_TOL, RL_SIZES, TRAIN_GRAD_REL_TOL,
                        TRAIN_LOSS_TOL, bwd_magnitudes, global_routes,
                        grad_tree, moe_probe, pinned_routes, rl_hold,
                        set_precision, sp_attention_errors)
from ray_tpu_torch import collective
from ray_tpu_torch.models import gpt2, llama
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.parallel import ring_attention as ra
from ray_tpu_torch.parallel.launch import RankPool
from ray_tpu_torch.parallel.context import use_mesh
from ray_tpu_torch.parallel.sharding import (ShardingConfig, batch_shard,
                                             gather_params, seq_shard,
                                             shard_params)

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
    """Force the forward's, the dq kernel's and the dk/dv kernel's plans:
    64-row blocks (a card of many SMs) or 128-row blocks, two consumer
    warpgroups (a card of one SM)."""
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
    both plans of each (dq: 128-row blocks only at D = 128, dk/dv: only
    below it); S = 1000
    walks 16 tiles, round each 4-slot ring four times, the last one
    ragged."""
    B, H = 2, 3
    sms = fa._sm_count(None)
    assert fa._dq_plan(B, H, S, D, sms).block_m == (
        plan_rows if D == 128 else 64)
    rows = fa._bwd_plan(B, H, S, D, sms).block_n
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


@pytest.mark.parametrize("D", [64, 128])
def test_bwd_mask_past_s_with_overflowing_lse(cuda, plan_rows, D):
    """Scores near -100 (natural log) everywhere, so lse ~ -100 and
    2^(-lse log2 e) overflows f32: the k rows past S of the last tile
    (S % 64 != 0), read as zeros with s = 0, must be masked, or inf * 0
    turns dq into NaN.  Gradients finite and within their bound."""
    B, H, S = 2, 3, 100
    g = cuda
    q = (2.5 + 0.1 * torch.randn((B, S, H, D), generator=g, device="cuda"))
    k = (-5.0 + 0.1 * torch.randn((B, S, H, D), generator=g, device="cuda"))
    q, k = (x * (100.0 / 12.5 / D ** 0.5) ** 0.5 for x in (q, k))
    v, do = (torch.randn((B, S, H, D), generator=g, device="cuda")
             for _ in range(2))
    q, k, v, do = (x.to(torch.bfloat16) for x in (q, k, v, do))
    for causal in (False, True):
        o, res = fa._flash_fwd_bshd(q, k, v, causal, None, None, None)
        lse = res[4]
        assert lse.max().item() < -90
        grads = fa._flash_bwd_bshd(causal, None, None, None, res, do)
        qh, kh, vh, oh, doh = (t.transpose(1, 2) for t in (q, k, v, o, do))
        scale = D ** -0.5
        ref = fa._reference_attention_bwd(qh, kh, vh, oh, lse, doh, scale,
                                          causal)
        mags = bwd_magnitudes(qh, kh, vh, oh, lse, doh, scale, causal)
        for name, gr, r, m in zip(("dq", "dk", "dv"), grads, ref, mags):
            assert torch.isfinite(gr).all(), name
            tol = G_RTOL * r.float().abs() + G_PTOL[name] * m
            diff = (gr.transpose(1, 2).float() - r.float()).abs()
            assert (diff <= tol).all(), name


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


def test_llama_d128_gqa_kernel_matches_dense_branch(cuda):
    """A 2-layer Llama at D = 128 with 4 query heads on 2 kv heads: the
    uncached forward (the kernel, once a layer, on RoPE'd q and repeated
    k, v) against the dense cached branch of the same module, and no
    launch in the cached forward or in ``generate``.  Tolerance: GPT-2's
    kernel-vs-dense logits bound (bf16 layers; a CPU emulation of the
    kernel's bf16 p gave 0.018-0.020 on logits of max ~2)."""
    cfg = llama.LlamaConfig(vocab_size=512, n_layer=2, n_head=4,
                            n_kv_head=2, n_embd=512, intermediate=1024,
                            max_seq=256)
    params = llama.serving_params(llama.init_params(cuda, cfg), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 200), generator=cuda,
                           device="cuda")
    before = fa.KERNEL_LAUNCHES
    flash, _ = llama.forward(params, tokens, cfg)
    assert fa.KERNEL_LAUNCHES == before + cfg.n_layer
    dense, caches = llama.forward(params, tokens, cfg,
                                  llama.init_cache(cfg, 2), 0)
    assert flash.shape == (2, 200, cfg.vocab_size)
    assert torch.isfinite(flash).all() and torch.isfinite(dense).all()
    assert (flash - dense).abs().max().item() <= LOGITS_TOL
    out = llama.generate(params, tokens[:, :50], cfg, 8)
    assert fa.KERNEL_LAUNCHES == before + cfg.n_layer
    assert out.shape == (2, 58) and torch.equal(out[:, :50], tokens[:, :50])
    assert ((out >= 0) & (out < cfg.vocab_size)).all()


MOE_TINY = replace(gpt2.GPT2_TINY, moe_experts=4)


def _moe_inputs(gen, device, case="drawn"):
    """x (2, 100, 64) f32 and one MoE FFN's weights, drawn on the CPU from
    ``gen``; ``tied`` router kernels make experts 0 and 3 tie for every
    token, ``all_tied`` all four."""
    p = gpt2.init_params(gen, MOE_TINY, device="cpu")["h_0"]["moe"]
    x = torch.randn((2, 100, 64), generator=gen)
    w = p["router"]["kernel"]
    if case == "tied":
        w[:, 3] = w[:, 0]
    elif case == "all_tied":
        w[:] = w[:, :1]
    to = lambda t: t.to(device).requires_grad_(True)  # noqa: E731
    return to(x), {"router": {"kernel": to(w)}, "wi": to(p["wi"]),
                   "wo": to(p["wo"])}


@pytest.mark.parametrize("case", ["drawn", "tied", "all_tied"])
def test_moe_mlp_on_card_matches_cpu(cuda, case):
    """The MoE FFN in f32 (TF32 off) on CUDA tensors against the same on
    the CPU: routing equal, including the reference's order among forced
    ties (a stable sort; torch.topk promises none on CUDA), y and aux and
    the gradients of x and every weight within f32 summation-order noise
    (1e-5 of each one's largest element), at a capacity that drops
    choices."""
    cfg = replace(MOE_TINY, compute_dtype=torch.float32,
                  moe_capacity_factor=0.5)
    out = {}
    for device in ("cpu", "cuda"):
        x, p = _moe_inputs(torch.Generator().manual_seed(3), device, case)
        _, _, idx, pos, C = gpt2._moe_route(
            x.detach().reshape(200, 64), p["router"]["kernel"].detach(), cfg)
        y, aux = gpt2._moe_mlp(x, p, cfg)
        leaves = [x, p["router"]["kernel"], p["wi"], p["wo"]]
        grads = torch.autograd.grad((y.square().sum() + aux), leaves)
        out[device] = [t.cpu() for t in (idx, pos, y.detach(), aux.detach(),
                                         *grads)]
    (ci, cp, *cv), (gi, gp, *gv) = out["cpu"], out["cuda"]
    assert torch.equal(ci, gi) and torch.equal(cp, gp)
    assert (cp >= C).any()   # choices dropped at capacity
    if case == "all_tied":
        assert (gi == torch.tensor([0, 1])).all()
    if case == "tied":
        assert not ((gi[:, 0] == 3) & (gi[:, 1] == 0)).any()
    for a, b in zip(gv, cv):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


def test_moe_mlp_backward_is_deterministic_on_card(cuda):
    """Two backward passes of the bf16 MoE FFN on the card give the same
    gradients bit for bit: both directions of the dispatch and combine are
    gathers, with no atomics."""
    x, p = _moe_inputs(torch.Generator().manual_seed(4), "cuda")
    x = x.detach().to(torch.bfloat16).requires_grad_(True)
    leaves = [x, p["router"]["kernel"], p["wi"], p["wo"]]
    runs = []
    for _ in range(2):
        y, aux = gpt2._moe_mlp(x, p, MOE_TINY)
        runs.append(torch.autograd.grad(y.float().square().sum() + aux,
                                        leaves))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_gpt2_moe_train_step_on_card_matches_cpu(cuda):
    """3 AdamW steps of MOE_TINY (bf16, remat on and off, dense and chunked
    head) through the kernels on the card against the same steps on the
    CPU (the plain versions): n_layer launches of each kernel per step (2
    n_layer of the forward under remat), losses within 2e-3 (bf16
    activations and attention rounded otherwise on each side, and a route
    that this may flip), parameters within 2 lr a step (Adam's bound on
    two runs whatever their gradients)."""
    steps, lr = 3, 1e-3
    tokens = torch.randint(0, 512, (2, 101), generator=torch.Generator()
                           .manual_seed(5))
    for remat, chunks in ((False, 0), (True, 4)):
        cfg = replace(MOE_TINY, remat=remat)
        out = {}
        for device in ("cpu", "cuda"):
            params = gpt2.init_params(torch.Generator().manual_seed(6), cfg,
                                      device=device)
            leaves = gpt2.param_leaves(params)
            for leaf in leaves:
                leaf.requires_grad_(True)
            step = gpt2.make_train_step(cfg, torch.optim.AdamW(
                leaves, lr=lr, weight_decay=0.1), xent_chunks=chunks)
            before = (fa.KERNEL_LAUNCHES, fa.BWD_DQ_LAUNCHES,
                      fa.BWD_DKV_LAUNCHES)
            losses = [step(params, {"tokens": tokens.to(device)})["loss"]
                      .item() for _ in range(steps)]
            after = (fa.KERNEL_LAUNCHES, fa.BWD_DQ_LAUNCHES,
                     fa.BWD_DKV_LAUNCHES)
            if device == "cuda":
                per_step = [(a - b) / steps for a, b in zip(after, before)]
                n = cfg.n_layer
                assert per_step == [(2 if remat else 1) * n, n, n]
            out[device] = losses, [t.detach().cpu() for t in leaves]
        (cl, cp), (gl, gp) = out["cpu"], out["cuda"]
        assert all(map(math.isfinite, gl)) and gl[-1] < gl[0]
        assert gl == pytest.approx(cl, rel=2e-3)
        for a, b in zip(gp, cp):
            assert (a - b).abs().max().item() <= 2 * lr * steps


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", ["diagonal", "earlier"])
def test_ring_step_kernels_with_global_lse_and_delta(cuda, step):
    """A ring step's forward on the card against the plain version on the
    same chunks (the diagonal step causal, an earlier chunk full), and its
    backward with the whole attention's lse, o and delta (not the
    chunk's), held with phase 2b's tolerances."""
    q, k, v, do = (torch.randn((2, 3, 256, 64), generator=cuda, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    scale = 0.125
    o, lse = fa._reference_attention(q, k, v, scale, True)
    delta = (do.float() * o.float()).sum(-1)
    j, causal = (1, True) if step == "diagonal" else (0, False)
    qr, orr, dor, lser, dr = (t[:, :, 128:] for t in (q, o, do, lse, delta))
    ks, vs = k[:, :, 128 * j:128 * (j + 1)], v[:, :, 128 * j:128 * (j + 1)]
    before = (fa.KERNEL_LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)
    o_i, lse_i = ra._chunk_fwd(qr, ks, vs, scale, causal)
    grads = ra._chunk_bwd(qr, ks, vs, orr, lser, dor, scale, causal, dr)
    torch.cuda.synchronize()
    after = (fa.KERNEL_LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    o_ref, lse_ref, o_tol = _plain(qr, ks, vs, causal, "bhsd")
    assert o_i.dtype == torch.float32
    assert ((o_i - o_ref.float()).abs() <= o_tol).all()
    assert (lse_i - lse_ref).abs().max().item() <= LSE_TOL
    ref = fa._reference_attention_bwd(qr, ks, vs, orr, lser, dor, scale,
                                      causal, dr)
    mags = bwd_magnitudes(qr, ks, vs, orr, lser, dor, scale, causal)
    for name, g, r, m in zip(("dq", "dk", "dv"), grads, ref, mags):
        tol = G_RTOL * r.float().abs() + G_PTOL[name] * m
        assert ((g.float() - r.float()).abs() <= tol).all(), name


def test_ring_merge_guards_on_card(cuda):
    """The first partial enters the -inf state with weight 1; a skipped
    step (o = 0, lse = -inf) leaves the state as it was, bit for bit."""
    o0 = torch.randn((2, 3, 64, 64), generator=cuda, device="cuda")
    lse0 = torch.randn((2, 3, 64), generator=cuda, device="cuda")
    state = (torch.zeros_like(o0),
             torch.full((2, 3, 64, 1), ra._NEG_INF, device="cuda"),
             torch.zeros((2, 3, 64, 1), device="cuda"))
    num, m, den = ra._merge(*state, o0, lse0)
    assert torch.equal(num, o0) and torch.equal(m[..., 0], lse0)
    assert torch.equal(den, torch.ones_like(den))
    skipped = ra._merge(num, m, den, torch.zeros_like(o0),
                        torch.full_like(lse0, ra._NEG_INF))
    for a, b in zip(skipped, (num, m, den)):
        assert torch.equal(a, b)


def _ring_inputs():
    gen = torch.Generator(device="cuda").manual_seed(7)
    return [torch.randn((2, 4, 512, 64), generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(4)]


def _rank_ring(causal):
    """A rank's o, dq, dk, dv (on the host) of the ring on its chunks of
    ``_ring_inputs``, and its host-staged hops."""
    import torch.distributed as dist

    mesh = ShardingConfig(sp=dist.get_world_size()).build_mesh()
    q, k, v, do = (seq_shard(t, mesh, dim=2) for t in _ring_inputs())
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    staged = collective.HOST_STAGED_HOPS
    o = ra.ring_attention_sharded(q, k, v, mesh, causal)
    o.backward(do)
    torch.cuda.synchronize()
    return ([t.detach().cpu() for t in (o, q.grad, k.grad, v.grad)],
            collective.HOST_STAGED_HOPS - staged)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_two_rank_gloo_ring_on_one_card(cuda, tmp_path, causal):
    """Two ranks on cuda:0 in one gloo group (hops staged through the
    host): the gathered o, dq, dk, dv against the plain versions and the
    single-rank kernels with chip_smoke.py phase 8's gates."""
    with RankPool(2, f"file://{tmp_path}/rendezvous", backend="gloo",
                  device="cuda:0", timeout_s=120.0) as pool:
        res = pool.run(_rank_ring, causal)
    # each rank: a k/v hop in the forward, one in the backward, 2 dk/dv hops
    assert [hops for _, hops in res] == [4, 4]
    got = [torch.cat([r[0][i] for r in res], dim=2).cuda() for i in range(4)]
    vs_plain, vs_kernel, _ = sp_attention_errors(_ring_inputs(), causal, got)
    assert max(vs_plain + vs_kernel) <= 1, (vs_plain, vs_kernel)


def _bshd_causal_matches_plain(cuda, B, H, S=1024, D=64):
    """o and lse against the plain forward, dq, dk, dv against the plain
    backward on the same (o, lse, do), with chip_smoke.py's per-element
    bounds, at (B, S, H, D) bshd causal."""
    res, do = _bwd_case(cuda, (B, S, H, D), True, "bshd")
    q, k, v, o, lse = res
    qh, kh, vh, oh, doh = (t.transpose(1, 2) for t in (q, k, v, o, do))
    scale = D ** -0.5
    o_ref, lse_ref = fa._reference_attention(qh, kh, vh, scale, True)
    o_mag, _ = fa._reference_attention(qh, kh, vh.abs(), scale, True)
    tol = O_RTOL * o_ref.float().abs() + O_PTOL * o_mag.float()
    assert ((oh.float() - o_ref.float()).abs() <= tol).all()
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL
    grads = fa._flash_bwd_bshd(True, None, None, None, res, do)
    ref = fa._reference_attention_bwd(qh, kh, vh, oh, lse, doh, scale, True)
    mags = bwd_magnitudes(qh, kh, vh, oh, lse, doh, scale, True)
    for name, g, r, m in zip(("dq", "dk", "dv"), grads, ref, mags):
        bound = G_RTOL * r.float().abs() + G_PTOL[name] * m
        assert ((g.transpose(1, 2).float() - r.float()).abs()
                <= bound).all(), name


@pytest.mark.parametrize("B", [4, 2])
def test_pp_microbatch_shapes_match_plain(cuda, B):
    """The pipeline's microbatch shapes on GPT-2 124M (bshd, H = 12,
    S = 1024, D = 64, causal) against the plain forward and backward."""
    _bshd_causal_matches_plain(cuda, B, 12)


def test_xl_fsdp_rank_shape_matches_plain(cuda):
    """A GPT-2 XL fsdp = 2 rank's shape at B = 16 (its 8 rows of 25 heads,
    S = 1024, D = 64, bshd causal) against the plain forward and
    backward."""
    _bshd_causal_matches_plain(cuda, 8, 25)


@pytest.mark.parametrize("B", [2, 1])
def test_tp_rank_heads_as_strided_views_match_plain(cuda, B):
    """A tp = 2 rank of GPT-2 124M hands the kernels its 6 heads as strided
    views of its (B, S, 3 x 384) qkv buffer (a row stride of 1152
    elements): o and lse against the plain forward, dq, dk, dv against the
    plain backward, with chip_smoke.py's per-element bounds."""
    H, S, D = 6, 1024, 64
    qkv = torch.randn((B, S, 3 * H * D), generator=cuda, device="cuda",
                      dtype=torch.bfloat16)
    q, k, v = (t.reshape(B, S, H, D) for t in qkv.split(H * D, dim=-1))
    assert q.stride(1) == 1152
    o, res = fa._flash_fwd_bshd(q, k, v, True, None, None, None)
    lse = res[4]
    do = torch.randn(o.shape, generator=cuda, device="cuda",
                     dtype=torch.bfloat16)
    qh, kh, vh, oh, doh = (t.transpose(1, 2) for t in (q, k, v, o, do))
    scale = D ** -0.5
    o_ref, lse_ref = fa._reference_attention(qh, kh, vh, scale, True)
    o_mag, _ = fa._reference_attention(qh, kh, vh.abs(), scale, True)
    tol = O_RTOL * o_ref.float().abs() + O_PTOL * o_mag.float()
    assert ((oh.float() - o_ref.float()).abs() <= tol).all()
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL
    grads = fa._flash_bwd_bshd(True, None, None, None, res, do)
    ref = fa._reference_attention_bwd(qh, kh, vh, oh, lse, doh, scale, True)
    mags = bwd_magnitudes(qh, kh, vh, oh, lse, doh, scale, True)
    for name, g, r, m in zip(("dq", "dk", "dv"), grads, ref, mags):
        bound = G_RTOL * r.float().abs() + G_PTOL[name] * m
        assert ((g.transpose(1, 2).float() - r.float()).abs()
                <= bound).all(), name


TP_TINY = replace(gpt2.GPT2_TINY, n_head=4, n_embd=256)


def _rank_tp_forward():
    """A tp rank's logits (the whole vocabulary, on the host) of GPT-2 with
    4 heads of D = 64 on cuda:0, and its forward launches."""
    import torch.distributed as dist

    config = ShardingConfig(tp=dist.get_world_size())
    mesh = config.build_mesh()
    params = gpt2.init_params(torch.Generator(device="cuda").manual_seed(3),
                              TP_TINY)
    local = shard_params(params, config, mesh)
    tokens = torch.arange(2 * 100, device="cuda").view(2, 100) % 512
    before = fa.KERNEL_LAUNCHES
    with torch.no_grad(), use_mesh(mesh):
        logits = gpt2.forward(local, tokens, TP_TINY)
    torch.cuda.synchronize()
    return logits.cpu(), fa.KERNEL_LAUNCHES - before


def test_two_rank_tensor_parallel_forward_on_one_card(cuda, tmp_path):
    """GPT-2 (4 heads of D = 64) at tp = 2 on two ranks of cuda:0 (gloo):
    each rank's kernels run its 2 heads, and the logits on every rank
    match the single-rank kernels' within chip_smoke.py phase 3's gate."""
    with RankPool(2, f"file://{tmp_path}/rendezvous", backend="gloo",
                  device="cuda:0", timeout_s=120.0) as pool:
        res = pool.run(_rank_tp_forward)
    params = gpt2.init_params(torch.Generator(device="cuda").manual_seed(3),
                              TP_TINY)
    tokens = torch.arange(2 * 100, device="cuda").view(2, 100) % 512
    with torch.no_grad():
        ref = gpt2.forward(params, tokens, TP_TINY).cpu()
    for logits, launches in res:
        assert launches == TP_TINY.n_layer
        assert logits.shape == ref.shape
        assert (logits - ref).abs().max().item() <= LOGITS_TOL


def _tp_remat_loss_and_grads(params, cfg):
    """GPT-2's loss (chunked head) and every leaf's gradient on the card,
    on the host; under a tp mesh ``params`` are the rank's shards and the
    gradients come back whole."""
    tokens = torch.arange(2 * 101, device="cuda").view(2, 101) % 512
    loss = gpt2.loss_fn(gpt2._cast_weights(params, cfg.compute_dtype),
                        {"tokens": tokens}, cfg, xent_chunks=2)
    loss.backward()
    return loss.item(), params


def _rank_tp_remat():
    import torch.distributed as dist

    config = ShardingConfig(tp=dist.get_world_size())
    mesh = config.build_mesh()
    cfg = replace(TP_TINY, remat=True)
    params = gpt2.init_params(torch.Generator(device="cuda").manual_seed(3),
                              cfg)
    local = shard_params(params, config, mesh)
    for leaf in gpt2.param_leaves(local):
        leaf.requires_grad_(True)
    with use_mesh(mesh):
        loss, local = _tp_remat_loss_and_grads(local, cfg)
        gpt2._sum_grads(local, cfg)
        grads = gather_params(grad_tree(local), config, mesh)
    return loss, [g.cpu() for g in gpt2.param_leaves(grads)]


def test_two_rank_tensor_parallel_remat_backward_on_one_card(cuda, tmp_path):
    """tp = 2 with remat and the chunked head on two ranks of cuda:0: the
    recomputed blocks and chunks run their tp collectives again on
    autograd's device thread, which must find the mesh; the loss and every
    gradient (gathered) against one rank's with chip_smoke.py phase 4's
    tolerances."""
    with RankPool(2, f"file://{tmp_path}/rendezvous", backend="gloo",
                  device="cuda:0", timeout_s=120.0) as pool:
        res = pool.run(_rank_tp_remat)
    cfg = replace(TP_TINY, remat=True)
    params = gpt2.init_params(torch.Generator(device="cuda").manual_seed(3),
                              cfg)
    for leaf in gpt2.param_leaves(params):
        leaf.requires_grad_(True)
    loss, params = _tp_remat_loss_and_grads(params, cfg)
    ref = [t.grad.cpu() for t in gpt2.param_leaves(params)]
    for got_loss, grads in res:
        assert abs(got_loss - loss) <= TRAIN_LOSS_TOL
        for g, r in zip(grads, ref):
            assert ((g - r).norm() / r.norm()).item() <= TRAIN_GRAD_REL_TOL


def _toy_pipeline_inputs():
    gen = torch.Generator(device="cuda").manual_seed(11)
    w = torch.randn((4, 64, 64), generator=gen, device="cuda") / 8
    x = torch.randn((8, 16, 64), generator=gen, device="cuda")
    return w, x


def _toy_block(p, h):
    return torch.tanh(h @ p["w"]), p["w"][0, 0]


def _rank_toy_pipeline(M):
    """A rank's output rows, aux and gradients (its stage slice, x) of the
    toy pipeline on cuda:0, on the host, with its host-staged hops."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.pipeline import pipeline_apply

    n = dist.get_world_size()
    mesh = ShardingConfig(pp=n).build_mesh()
    w, x = _toy_pipeline_inputs()
    c = w.shape[0] // n
    r = mesh.get_local_rank("pp")
    local = {"w": w[r * c:(r + 1) * c].clone().requires_grad_(True)}
    x.requires_grad_(True)
    staged = collective.HOST_STAGED_HOPS
    out, aux = pipeline_apply(_toy_block, local, x, mesh, M)
    ((out ** 2).sum() / (1 if M % n == 0 else n) + aux).backward()
    torch.cuda.synchronize()
    return ([t.detach().cpu() for t in (out, aux, local["w"].grad)]
            + [None if x.grad is None else x.grad.cpu()],
            collective.HOST_STAGED_HOPS - staged)


@pytest.mark.parametrize("M", [4, 1])
def test_two_rank_gloo_pipeline_on_one_card(cuda, tmp_path, M):
    """Two ranks on cuda:0 in one gloo group, one stage each: the output
    (each rank's rows at M = 4, every row at M = 1), the aux and the
    gradients against the layers applied to each microbatch in turn on the
    card."""
    with RankPool(2, f"file://{tmp_path}/rendezvous", backend="gloo",
                  device="cuda:0", timeout_s=120.0) as pool:
        res = pool.run(_rank_toy_pipeline, M)
    # M activation hops each way: stage 0 sends and receives M, and so
    # does stage 1
    assert [hops for _, hops in res] == [2 * M, 2 * M]
    w, x = _toy_pipeline_inputs()
    w.requires_grad_(True)
    x.requires_grad_(True)
    outs, aux = [], 0.0
    for mb in x.chunk(M):
        h, a = mb, 0.0
        for i in range(w.shape[0]):
            h, ai = _toy_block({"w": w[i]}, h)
            a = a + ai
        outs.append(h)
        aux = aux + a
    out, aux = torch.cat(outs), aux / M
    ((out ** 2).sum() + aux).backward()
    for r, (got, _) in enumerate(res):
        rows = out.chunk(2)[r] if M % 2 == 0 else out
        torch.testing.assert_close(got[0], rows.detach().cpu())
        torch.testing.assert_close(got[1], aux.detach().cpu())
        torch.testing.assert_close(got[2], w.grad.chunk(2)[r].cpu())
    torch.testing.assert_close(res[0][0][3], x.grad.cpu())
    assert res[1][0][3] is None


#: the MoE of 4 experts at TP_TINY's widths, its capacity binding at B=4,
#: S=128 (chip_smoke.py phase 11 checks GPT-2 124M's 8 experts)
MOE_EP_TINY = replace(TP_TINY, moe_experts=4, moe_capacity_factor=0.75)


def _moe_tokens():
    return torch.arange(4 * 129, device="cuda").view(4, 129) * 7 % 512


def _rank_moe(axes):
    """A rank's logits (its rows), loss, every gradient (summed as the
    train step sums them, gathered over ep), the expert choices of the
    global batch in the forward and in the loss, and the forward's dropped
    choices per layer summed over dp, on the host, for MOE_EP_TINY on
    cuda:0."""
    config = ShardingConfig(**axes)
    mesh = config.build_mesh()
    params = gpt2.init_params(torch.Generator(device="cuda").manual_seed(5),
                              MOE_EP_TINY)
    local = shard_params(params, config, mesh)
    for leaf in gpt2.param_leaves(local):
        leaf.requires_grad_(True)
    batch = batch_shard(_moe_tokens(), mesh)
    with use_mesh(mesh):
        with torch.no_grad(), moe_probe() as rec:
            logits = gpt2.forward(local, batch[:, :-1], MOE_EP_TINY)
        dropped = torch.stack(rec["dropped"])
        if "dp" in axes:
            dropped = collective.c10d.allreduce(dropped, "dp")
        with moe_probe() as loss_rec:
            loss = gpt2.loss_fn(gpt2._cast_weights(
                local, MOE_EP_TINY.compute_dtype), {"tokens": batch},
                MOE_EP_TINY)
        # the forward's choices, then the loss's (of the cast weights)
        routes = global_routes(mesh, torch.stack(rec["idx"] + loss_rec[
            "idx"]), batch.shape[0])
        between = (collective.c10d.allgather(routes, "ep", tiled=False)
                   != routes).any().item() if "ep" in axes else False
        loss.backward()
        gpt2._sum_grads(local, MOE_EP_TINY)
        grads = gather_params(grad_tree(local), config, mesh)
    return (logits.cpu(), loss.item(), [g.cpu() for g in
                                        gpt2.param_leaves(grads)],
            routes.cpu(), dropped.tolist(), between)


def _moe_reference(routes):
    """The single-rank MoE on the card with ``routes`` (the forward's,
    then the loss's) replayed: logits, loss, every gradient and the
    forward's dropped choices per layer."""
    params = gpt2.init_params(torch.Generator(device="cuda").manual_seed(5),
                              MOE_EP_TINY)
    for leaf in gpt2.param_leaves(params):
        leaf.requires_grad_(True)
    tokens = _moe_tokens()
    with pinned_routes([r.cuda() for r in routes]), moe_probe() as rec:
        with torch.no_grad():
            logits = gpt2.forward(params, tokens[:, :-1], MOE_EP_TINY)
        loss = gpt2.loss_fn(gpt2._cast_weights(params,
                                               MOE_EP_TINY.compute_dtype),
                            {"tokens": tokens}, MOE_EP_TINY)
        loss.backward()
    return (logits.cpu(), loss.item(),
            [t.grad.cpu() for t in gpt2.param_leaves(params)],
            torch.stack(rec["dropped"][:MOE_EP_TINY.n_layer]).tolist())


@pytest.mark.parametrize("axes", [{"ep": 2}, {"dp": 2}], ids=["ep2", "dp2"])
def test_two_rank_moe_on_one_card(cuda, tmp_path, axes):
    """The MoE at ep = 2 (two experts a rank) and at dp = 2 (two rows a
    rank, routed with the capacity of the global batch) on two ranks of
    cuda:0 (gloo), against the single-rank kernels with the ranks' expert
    choices replayed, with chip_smoke.py phase 11's gates: the logits (each
    rank's rows), the loss and every gradient (gathered over ep); no choice
    differs between the ep ranks; the choices dropped in each layer, summed
    over the ranks, equal the single-rank run's."""
    with RankPool(2, f"file://{tmp_path}/rendezvous", backend="gloo",
                  device="cuda:0", timeout_s=120.0) as pool:
        res = pool.run(_rank_moe, axes)
    logits, loss, grads, dropped = _moe_reference(list(res[0][3]))
    assert sum(dropped) > 0
    for r, (got, got_loss, got_grads, routes, got_dropped, between) in \
            enumerate(res):
        rows = logits.chunk(2)[r] if "dp" in axes else logits
        assert not between and torch.equal(routes, res[0][3])
        assert got.shape == rows.shape
        assert (got - rows).abs().max().item() <= LOGITS_TOL
        assert got_dropped == dropped
        assert abs(got_loss - loss) <= MOE_LOSS_TOL
        for g, ref in zip(got_grads, grads):
            assert ((g - ref).norm() / ref.norm()).item() <= MOE_GRAD_REL_TOL


FSDP_TINY = replace(TP_TINY, remat=True)
#: AdamW's lr in the fsdp step test: one step moves an element by at most
#: about lr (1 + weight decay) on either side, so the two sides' parameters
#: after it part by at most 2 lr wherever their gradients' signs part
FSDP_LR = 1e-3


def _fsdp_tokens():
    return torch.arange(4 * 101, device="cuda").view(4, 101) * 5 % 512


def _fsdp_step(params, batch, mesh=None):
    """The loss (chunked head) and every leaf's gradient of FSDP_TINY, then
    one AdamW step (``make_train_step``) on the same batch."""
    loss = gpt2.loss_fn(gpt2._cast_weights(params, FSDP_TINY.compute_dtype),
                        batch, FSDP_TINY, xent_chunks=2)
    loss.backward()
    gpt2._sum_grads(params, FSDP_TINY)
    grads = grad_tree(params)
    for leaf in gpt2.param_leaves(params):
        leaf.grad = None
    opt = torch.optim.AdamW(gpt2.param_leaves(params), lr=FSDP_LR)
    gpt2.make_train_step(FSDP_TINY, opt, xent_chunks=2)(params, batch)
    return loss.item(), grads


def _rank_fsdp_step():
    """An fsdp rank's loss, gradients and parameters after one step, each
    leaf put back whole by ``gather_params``, on the host."""
    import torch.distributed as dist

    config = ShardingConfig(fsdp=dist.get_world_size())
    mesh = config.build_mesh()
    params = gpt2.init_params(torch.Generator(device="cuda").manual_seed(3),
                              FSDP_TINY)
    local = shard_params(params, config, mesh)
    for leaf in gpt2.param_leaves(local):
        leaf.requires_grad_(True)
    batch = {"tokens": batch_shard(_fsdp_tokens(), mesh)}
    with use_mesh(mesh):
        loss, grads = _fsdp_step(local, batch)
        whole = [gather_params(t, config, mesh) for t in (grads, local)]
    return loss, [[t.detach().cpu() for t in gpt2.param_leaves(w)]
                  for w in whole]


def test_two_rank_fsdp_step_on_one_card(cuda, tmp_path):
    """fsdp = 2 with remat and the chunked head on two ranks of cuda:0
    (gloo), each rank its rows and its block of every leaf's embed dim:
    the gathers run again in the recomputed blocks on autograd's device
    thread, which must find the mesh.  The loss and every gradient
    (gathered) against one rank's on the whole batch with chip_smoke.py
    phase 4's tolerances, and the parameters after one AdamW step within
    2 lr of one rank's step."""
    with RankPool(2, f"file://{tmp_path}/rendezvous", backend="gloo",
                  device="cuda:0", timeout_s=120.0) as pool:
        res = pool.run(_rank_fsdp_step)
    params = gpt2.init_params(torch.Generator(device="cuda").manual_seed(3),
                              FSDP_TINY)
    for leaf in gpt2.param_leaves(params):
        leaf.requires_grad_(True)
    loss, grads = _fsdp_step(params, {"tokens": _fsdp_tokens()})
    ref_grads = [g.cpu() for g in gpt2.param_leaves(grads)]
    ref_params = [t.detach().cpu() for t in gpt2.param_leaves(params)]
    for got_loss, (got_grads, got_params) in res:
        assert abs(got_loss - loss) <= TRAIN_LOSS_TOL
        for g, r in zip(got_grads, ref_grads):
            assert ((g - r).norm() / r.norm()).item() <= TRAIN_GRAD_REL_TOL
        for p, r in zip(got_params, ref_params):
            assert (p - r).abs().max().item() <= 2 * FSDP_LR
    assert all(torch.equal(a, b) for a, b in zip(res[0][1][1], res[1][1][1]))


#: the MoE of MOE_EP_TINY at 4 layers, two a stage at pp = 2
MOE_PP_TINY = replace(MOE_EP_TINY, n_layer=4)
MOE_PP_M = 2
#: AdamW's lr in the pipelined MoE step test (as FSDP_LR)
MOE_PP_LR = 1e-3


def _moe_pp_tokens():
    return torch.arange(8 * 129, device="cuda").view(8, 129) * 7 % 512


def _rank_moe_pp_step():
    """A pp = 2 x dp = 2 rank's loss, the expert choices of each global
    microbatch and its dropped choices (the loss's forward, gathered over
    dp and pp), its stage's gradients (summed as the train step sums
    them) and its stage's leaves after one AdamW step, on the host, for
    MOE_PP_TINY on cuda:0."""
    import torch.distributed as dist

    cfg, M = MOE_PP_TINY, MOE_PP_M
    config = ShardingConfig(dp=2, pp=2)
    mesh = config.build_mesh()
    params = gpt2.init_params(torch.Generator(device="cuda").manual_seed(5),
                              cfg)
    local = shard_params(gpt2.to_pipeline_params(params, cfg), config, mesh)
    for leaf in gpt2.param_leaves(local):
        leaf.requires_grad_(True)
    batch = {"tokens": batch_shard(_moe_pp_tokens(), mesh)}
    c = cfg.n_layer // 2
    with use_mesh(mesh):
        with moe_probe() as rec:
            loss = gpt2.loss_fn(gpt2._cast_weights(local, cfg.compute_dtype),
                                batch, cfg, M)
        mine = torch.stack(rec["idx"]).view(M, c, -1, cfg.moe_top_k)
        dropped = collective.c10d.allreduce(
            torch.stack(rec["dropped"]).view(M, c), "dp")
        routes = collective.c10d.allgather(
            collective.c10d.allgather(mine, "dp", axis=2), "pp", axis=1)
        dropped = collective.c10d.allgather(dropped, "pp", axis=1)
        loss.backward()
        gpt2._sum_grads(local, cfg)
        grads = [t.grad.cpu() for t in gpt2.param_leaves(local)]
        for leaf in gpt2.param_leaves(local):
            leaf.grad = None
        opt = torch.optim.AdamW(gpt2.param_leaves(local), lr=MOE_PP_LR)
        gpt2.make_train_step(cfg, opt, M)(local, batch)
    return (loss.item(), routes.cpu(), dropped.tolist(), grads,
            [t.detach().cpu() for t in gpt2.param_leaves(local)],
            mesh.get_local_rank("pp"), dist.get_rank())


def test_four_rank_moe_pp_dp_step_on_one_card(cuda, tmp_path):
    """The MoE at pp = 2 x dp = 2 (M = 2) on four ranks of cuda:0 (gloo),
    each rank its block of every global microbatch, against the
    single-rank kernels run on each global microbatch alone with the
    ranks' choices replayed (the reference's pipelined function), with
    chip_smoke.py phase 6's gates: the loss and every gradient (each
    stage's layers against theirs), the choices dropped in each
    (microbatch, layer) summed over the ranks, and the stage's leaves
    after one AdamW step within 2 lr of the single-rank step's."""
    cfg, M = MOE_PP_TINY, MOE_PP_M
    with RankPool(4, f"file://{tmp_path}/rendezvous", backend="gloo",
                  device="cuda:0", timeout_s=120.0) as pool:
        res = pool.run(_rank_moe_pp_step)
    routes = res[0][1]
    params = gpt2.init_params(torch.Generator(device="cuda").manual_seed(5),
                              cfg)
    leaves = gpt2.param_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    chunks = _moe_pp_tokens().chunk(M)
    with pinned_routes([r.cuda() for r in routes.flatten(0, 1)]), \
            moe_probe() as rec:
        cast = gpt2._cast_weights(params, cfg.compute_dtype)
        loss = sum(gpt2.loss_fn(cast, {"tokens": t}, cfg)
                   for t in chunks) / M
    loss.backward()
    dropped = torch.stack(rec["dropped"]).view(M, cfg.n_layer).tolist()
    assert sum(map(sum, dropped)) > 0
    opt = torch.optim.AdamW(leaves, lr=MOE_PP_LR)
    with torch.no_grad():
        grads = gpt2.to_pipeline_params(grad_tree(params), cfg)
        opt.step()
    stacked = gpt2.to_pipeline_params(params, cfg)
    c = cfg.n_layer // 2
    for got_loss, got_routes, got_dropped, got_grads, got_params, stage, _ \
            in res:
        assert torch.equal(got_routes, routes)
        assert got_dropped == dropped
        assert abs(got_loss - loss.item()) <= MOE_LOSS_TOL
        for (name, ref), (_, p), g, q in zip(
                gpt2.named_leaves(grads), gpt2.named_leaves(stacked),
                got_grads, got_params):
            if name.startswith("blocks/"):
                ref, p = (t[stage * c:(stage + 1) * c] for t in (ref, p))
            ref = ref.cpu()
            assert ((g - ref).norm() / ref.norm()).item() <= \
                MOE_GRAD_REL_TOL, name
            assert (q - p.detach().cpu()).abs().max().item() <= \
                2 * MOE_PP_LR, name


@pytest.mark.parametrize("name", ["impala", "ppo", "dqn", "sac", "bc",
                                  "mnist"])
def test_rl_update_on_card_matches_cpu(cuda, name):
    """One update on the card against the port's CPU path on the same
    state, batch and noise, with phase 14's tolerances (IMPALA at a
    rollout of T = 8 x B = 4 frames of 84x84x4)."""
    set_precision()
    m_err, leaf_err, *_ = rl_hold(name, 0, {**RL_SIZES, "impala": (8, 4)})
    assert m_err <= 1 and leaf_err <= 1


def test_runtime_serialization_takes_card_tensors_to_host(cuda):
    """The runtime's serializer takes a tensor on the card to the host: a
    CPU tensor of its dtype and shape, bit for bit (bf16, a strided f32
    view, an empty one), its bytes one out-of-band buffer."""
    from ray_tpu_torch.core import serialization

    x = torch.randn(1024, 768, device="cuda", generator=cuda)
    for t in (x.to(torch.bfloat16), x.t()[::2], x[:0]):
        ser = serialization.serialize(t)
        assert [b.nbytes for b in ser.buffers] == [t.numel() * t.element_size()]
        back = serialization.loads(ser.to_bytes())
        assert back.device.type == "cpu" and back.dtype == t.dtype
        assert back.shape == t.shape
        assert torch.equal(back, t.cpu())


NESTED_ON_CARD = """
import json, sys
import torch
import ray_tpu_torch as rt


def draw():
    g = torch.Generator(device="cuda").manual_seed(7)
    w = torch.randn(512, 256, device="cuda", generator=g)
    return {"loss": w.mean(), "grads": {"w": w.to(torch.bfloat16),
                                        "b": w[0]}, "step": 3}


def on_host(value):
    return {"cuda": torch.cuda.is_available(),
            "devices": sorted({t.device.type for t in (
                value["loss"], *value["grads"].values())}),
            "sums": [float(t.cpu().double().sum()) for t in (
                value["loss"], *value["grads"].values())]}


rt.init(num_cpus=2)
ref = rt.remote(num_gpus=1)(draw).remote()
seen = rt.get(rt.remote(on_host).remote(ref), timeout=120)
back = rt.get(ref, timeout=120)
want = draw()
same = (back["step"] == 3 and back["loss"].device.type == "cpu"
        and all(torch.equal(back["grads"][k], want["grads"][k].cpu())
                for k in want["grads"])
        and torch.equal(back["loss"], want["loss"].cpu())
        and back["grads"]["w"].dtype == torch.bfloat16)
rt.shutdown()
print("RESULT " + json.dumps({"seen": seen, "want": on_host(want),
                              "same": same}))
"""


def test_runtime_nested_card_tensors_load_in_a_cpu_worker(cuda, tmp_path):
    """A GPU task returns a dict of tensors on the card; a CPU task, whose
    worker cannot see the card, reads it as CPU tensors, and the driver gets
    them back bit-equal to the same draw made on the card."""
    import json
    import os
    import sys

    from test_torch_runtime_parity import ROOT, run_driver

    main = tmp_path / "main.py"
    main.write_text(NESTED_ON_CARD)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc, stdout, stderr = run_driver([sys.executable, str(main)],
                                      str(tmp_path), env, timeout=300)
    assert proc.returncode == 0, stderr
    line = [l for l in stdout.splitlines() if l.startswith("RESULT ")]
    out = json.loads(line[-1][len("RESULT "):])
    assert out["same"]
    assert out["seen"]["cuda"] is False and out["seen"]["devices"] == ["cpu"]
    assert out["seen"]["sums"] == out["want"]["sums"]


SERVE_ON_CARD = """
import json
import torch
import chip_smoke
import ray_tpu_torch as rt
from ray_tpu_torch import serve

PROMPT = [5, 17, 301, 42, 7]
rt.init(num_cpus=2)
serve.start()
dep = serve.deployment(name="gpt2_tiny", ray_actor_options={"num_tpus": 1})(
    chip_smoke.Generator)
h = serve.run(dep.bind("tiny", "cuda", 0), route_prefix="/gpt2")
before = rt.get(h.method.launches.remote(True), timeout=300)
served = rt.get(h.remote({"prompt": PROMPT, "max_tokens": 6}), timeout=300)
launches, forwards = rt.get(h.method.launches.remote(False), timeout=60)
local = chip_smoke.Generator("tiny", "cuda", 0)(
    {"prompt": PROMPT, "max_tokens": 6})
serve.shutdown()
rt.shutdown()
print("RESULT " + json.dumps({
    "served": served["tokens"], "local": local["tokens"],
    "before": list(before), "launches": launches, "forwards": forwards,
    "n_layer": chip_smoke.gpt2.GPT2_TINY.n_layer}))
"""


def test_serve_gpu_deployment_of_gpt2_tiny(cuda, tmp_path):
    """``chip_smoke.Generator`` at ``GPT2_TINY`` widths deployed by
    reference through ``serve.run`` with ``num_gpus=1``: the replica's
    greedy tokens equal the driver's own on the card, and the replica's
    process launched the forward kernel once per layer per forward."""
    import json
    import os
    import sys

    from test_torch_runtime_parity import ROOT, run_driver

    main = tmp_path / "main.py"
    main.write_text(SERVE_ON_CARD)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc, stdout, stderr = run_driver([sys.executable, str(main)],
                                      str(tmp_path), env, timeout=300)
    assert proc.returncode == 0, stderr
    line = [l for l in stdout.splitlines() if l.startswith("RESULT ")]
    out = json.loads(line[-1][len("RESULT "):])
    assert out["served"] == out["local"]
    assert out["forwards"] - out["before"][1] == 6
    assert out["launches"] == out["n_layer"] * 6 > 0


def _run_card_driver(tmp_path, program, args=(), env=None, timeout=300):
    """Run ``program`` as a driver under a session root of its own; its
    ``RESULT`` line's JSON."""
    import json
    import os
    import sys

    from test_torch_runtime_parity import ROOT, run_driver

    main = tmp_path / "main.py"
    main.write_text(program)
    env = dict(os.environ if env is None else env, PYTHONPATH=ROOT)
    proc, stdout, stderr = run_driver([sys.executable, str(main), *args],
                                      str(tmp_path), env, timeout=timeout)
    assert proc.returncode == 0, stderr
    line = [l for l in stdout.splitlines() if l.startswith("RESULT ")]
    assert line, stdout + stderr
    return json.loads(line[-1][len("RESULT "):])


def test_air_checkpoint_takes_a_card_state_dict_to_host(cuda, tmp_path):
    """(j): ``Checkpoint.from_dict`` of a ``state_dict`` on the card holds
    CPU tensors of the same dtype (bf16 kept) and values; once the module
    goes, the checkpoint keeps nothing on the card; the directory form
    loads back into a CPU module."""
    from ray_tpu_torch.air.checkpoint import Checkpoint

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    model = torch.nn.Linear(64, 32).to("cuda", torch.bfloat16)
    sd = model.state_dict()
    want = {k: v.cpu() for k, v in sd.items()}
    ckpt = Checkpoint.from_dict({"model": sd, "step": 3,
                                 "extra": [torch.ones(4, device="cuda")]})
    state = ckpt.to_dict()
    for k, v in state["model"].items():
        assert v.device.type == "cpu" and v.dtype == torch.bfloat16
        assert torch.equal(v.view(torch.int16), want[k].view(torch.int16))
    assert state["extra"][0].device.type == "cpu" and state["step"] == 3
    del model, sd
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
    back = Checkpoint.from_directory(ckpt.to_directory(str(tmp_path / "c")))
    cpu = torch.nn.Linear(64, 32).to(torch.bfloat16)
    cpu.load_state_dict(back.to_dict()["model"])
    assert torch.equal(cpu.weight, want["weight"])


DATA_ON_CARD = """
import json
import numpy as np
import torch
import ray_tpu_torch as rt
from ray_tpu_torch import data
from ray_tpu_torch.data import DataIterator

rt.init(num_cpus=2)
values = np.arange(40, dtype=np.float32).reshape(10, 4)
ds = data.from_numpy(values, parallelism=2)
it = list(DataIterator(ds).iter_torch_batches(batch_size=4, drop_last=False))
default = list(ds.iter_torch_batches(batch_size=4))
rt.shutdown()
print("RESULT " + json.dumps({
    "iterator": [str(b["value"].device) for b in it],
    "dataset": [str(b["value"].device) for b in default],
    "same": torch.equal(torch.cat([b["value"] for b in it]).cpu(),
                        torch.from_numpy(values))
    and torch.equal(torch.cat([b["value"] for b in default]).cpu(),
                    torch.from_numpy(values))}))
"""

HIDDEN_CARD = """
import json
from ray_tpu_torch.data import DataIterator, Dataset

errors = []
for gen in (DataIterator(None).iter_torch_batches(),
            Dataset.iter_torch_batches(None)):
    try:
        next(gen)
        errors.append(None)
    except RuntimeError as e:
        errors.append(str(e))
print("RESULT " + json.dumps(errors))
"""


def test_data_iter_torch_batches_on_card(cuda, tmp_path):
    """(k): ``DataIterator.iter_torch_batches`` and
    ``Dataset.iter_torch_batches`` stage batches onto the card by default,
    with the dataset's values; where the card is hidden
    (``CUDA_VISIBLE_DEVICES=""``) both defaults raise rather than fall back
    to the CPU."""
    import os

    out = _run_card_driver(tmp_path, DATA_ON_CARD)
    assert out["iterator"] == ["cuda:0"] * 3
    assert out["dataset"] == ["cuda:0"] * 3
    assert out["same"]
    hidden = tmp_path / "hidden"
    hidden.mkdir()
    errors = _run_card_driver(hidden, HIDDEN_CARD, env=dict(
        os.environ, CUDA_VISIBLE_DEVICES=""))
    assert len(errors) == 2
    assert all(e and "no CUDA device" in e for e in errors), errors


TRAIN_ON_CARD = """
import json
import sys
import torch  # init() counts the cards once torch is loaded
import ray_tpu_torch as rt
from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer


def steps(n):
    from dataclasses import replace

    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.train.torch import get_device

    torch.backends.cuda.matmul.allow_tf32 = False
    device = get_device() if rt.is_initialized() else torch.device("cuda")
    cfg = gpt2.GPT2_TINY
    params = gpt2.init_params(torch.Generator(device="cuda").manual_seed(0),
                              cfg, device=device)
    for leaf in gpt2.param_leaves(params):
        leaf.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (4, 129),
                           generator=torch.Generator().manual_seed(1))
    step = gpt2.make_train_step(cfg, torch.optim.AdamW(
        gpt2.param_leaves(params), lr=1e-3))
    fa.KERNEL_LAUNCHES = fa.BWD_DQ_LAUNCHES = fa.BWD_DKV_LAUNCHES = 0
    losses = [step(params, {"tokens": tokens.to(device)})["loss"].item()
              for _ in range(n)]
    return {"device": str(device), "losses": losses,
            "launches": [fa.KERNEL_LAUNCHES, fa.BWD_DQ_LAUNCHES,
                         fa.BWD_DKV_LAUNCHES]}


def loop(config):
    from ray_tpu_torch.train import session

    session.report(steps(config["steps"]))


rt.init(num_cpus=2)
result = TorchTrainer(
    loop, train_loop_config={"steps": 3},
    scaling_config=ScalingConfig(num_workers=1, use_tpu=True),
    run_config=RunConfig(name="card", storage_path=sys.argv[1])).fit()
rt.shutdown()
print("RESULT " + json.dumps({"worker": result.metrics, "driver": steps(3)}))
"""


def test_train_torch_trainer_gpt2_tiny_on_card(cuda, tmp_path):
    """A one-worker ``TorchTrainer`` with ``use_tpu=True`` trains GPT-2 at
    ``GPT2_TINY`` widths on the card (``get_device()``: the worker's card)
    through the kernels, once per layer a step of each, and its losses
    equal the driver's own run of the same steps on the card."""
    out = _run_card_driver(tmp_path, TRAIN_ON_CARD,
                           [str(tmp_path / "results")])
    worker, driver = out["worker"], out["driver"]
    assert worker["device"] == "cuda:0"
    assert worker["launches"] == [2 * 3] * 3  # n_layer x steps
    assert all(math.isfinite(x) for x in worker["losses"])
    assert worker["losses"] == driver["losses"]


CLUSTER_ON_CARD = """
import json
import os
import ray_tpu_torch as rt
from ray_tpu_torch.cluster_utils import Cluster


def on_card():
    import torch

    x = torch.arange(1 << 20, device="cuda", dtype=torch.float32)
    return [torch.cuda.get_device_name(0), float(x.sum()),
            os.environ.get("CUDA_VISIBLE_DEVICES")]


out = {}
for label, env in (("named", {"CUDA_VISIBLE_DEVICES": "0"}), ("hidden", {})):
    c = Cluster(initialize_head=True, head_resources={"num_cpus": 1},
                env=env)
    try:
        c.add_node(num_cpus=1, num_tpus=1)
        c.wait_for_nodes(2)
        c.connect()
        try:
            out[label] = rt.get(rt.remote(num_gpus=1)(on_card).remote(),
                                timeout=120)
        except Exception as e:  # noqa: BLE001
            out[label] = ["raised", type(e).__name__, str(e)[:300]]
        out[label + "_resources"] = rt.cluster_resources().get("TPU")
    finally:
        c.shutdown()
print("RESULT " + json.dumps(out))
"""


def test_cluster_node_with_the_card_runs_a_gpu_task(cuda, tmp_path):
    """A ``Cluster`` node added with ``num_tpus=1`` runs a GPU task on the
    card where the cluster's ``env`` names it; where it does not, the
    cluster's processes keep ``CUDA_VISIBLE_DEVICES=""`` (hunk (e)) and the
    same task fails loudly instead of running on the CPU."""
    out = _run_card_driver(tmp_path, CLUSTER_ON_CARD)
    name, total, visible = out["named"]
    assert name == torch.cuda.get_device_name(0) and visible == "0"
    assert total == float(sum(range(1 << 20)))
    assert out["named_resources"] == out["hidden_resources"] == 1.0
    assert out["hidden"][0] == "raised", out["hidden"]



TUNE_ON_CARD = """
import json
import sys
import torch  # init() counts the cards once torch is loaded
import ray_tpu_torch as rt
from ray_tpu_torch import tune

LRS, MAX_T = (1e-3, 1e-7), 4


def steps(lr, n, report=None):
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = gpt2.GPT2_TINY
    params = gpt2.init_params(torch.Generator(device="cuda").manual_seed(0),
                              cfg, device="cuda")
    for leaf in gpt2.param_leaves(params):
        leaf.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (4, 129),
                           generator=torch.Generator().manual_seed(1))
    step = gpt2.make_train_step(cfg, torch.optim.AdamW(
        gpt2.param_leaves(params), lr=lr))
    fa.KERNEL_LAUNCHES = fa.BWD_DQ_LAUNCHES = fa.BWD_DKV_LAUNCHES = 0
    losses = []
    for _ in range(n):
        losses.append(step(params, {"tokens": tokens.to("cuda")})[
            "loss"].item())
        out = {"loss": losses[-1], "losses": list(losses),
               "device": str(tokens.to("cuda").device),
               "launches": [fa.KERNEL_LAUNCHES, fa.BWD_DQ_LAUNCHES,
                            fa.BWD_DKV_LAUNCHES]}
        if report is not None:
            report(out)
    return losses


def trial(config):
    steps(config["lr"], MAX_T, tune.report)


rt.init(num_cpus=2)
grid = tune.Tuner(
    trial, param_space={"lr": tune.grid_search(list(LRS))},
    tune_config=tune.TuneConfig(
        metric="loss", mode="min", resources_per_trial={"CPU": 1, "TPU": 1},
        scheduler=tune.ASHAScheduler(metric="loss", mode="min", max_t=MAX_T,
                                     grace_period=2, reduction_factor=2)),
    run_config=tune.RunConfig(name="card", storage_path=sys.argv[1])).fit()
out = {"trials": [[r.config["lr"], r.metrics] for r in grid],
       "errors": [str(e) for e in grid.errors],
       "best": grid.get_best_result().config["lr"]}
rt.shutdown()
out["driver"] = steps(LRS[0], MAX_T)
print("RESULT " + json.dumps(out))
"""


def test_tune_asha_gpt2_tiny_trials_on_card(cuda, tmp_path):
    """Phase 19 (a) at ``GPT2_TINY`` (2 layers): a ``Tuner`` under ASHA
    (max_t 4, one rung at 2) runs two trials one at a time, each in an
    actor holding the card (``{"CPU": 1, "TPU": 1}``); each trial launches
    ``n_layer`` x its steps of each kernel, the trial at lr 1e-7 stops at
    the rung, and the other's losses equal the driver's own run on the
    card bit for bit."""
    out = _run_card_driver(tmp_path, TUNE_ON_CARD,
                           [str(tmp_path / "results")])
    assert out["errors"] == []
    trials = dict((lr, m) for lr, m in out["trials"])
    for lr, m in trials.items():
        n = len(m["losses"])
        assert m["device"] == "cuda:0"
        assert m["launches"] == [2 * n] * 3, (lr, m["launches"])
    assert len(trials[1e-7]["losses"]) == 2
    assert trials[1e-3]["losses"] == out["driver"]
    assert out["best"] == 1e-3


RLLIB_ON_CARD = """
import json
import sys
import numpy as np
import torch  # init() counts the cards once torch is loaded
import ray_tpu_torch as rt
from ray_tpu_torch import tune
from ray_tpu_torch.rllib import impala, optim
from ray_tpu_torch.rllib.algorithm import to_learner
from ray_tpu_torch.rllib.models import params_to_numpy

import chip_smoke as cs

T, B, ITERS, SEED = 8, 4, 3, 0
rt.init(num_cpus=3)
grid = tune.Tuner(
    cs.SmokeImpala,
    param_space={"env_creator": cs.SmokeAtariEnv, "cnn": True,
                 "num_env_runners": 1, "num_envs_per_runner": B,
                 "rollout_length": T, "seed": SEED},
    tune_config=tune.TuneConfig(resources_per_trial={"CPU": 1, "TPU": 1},
                                stop={"training_iteration": ITERS}),
    run_config=tune.RunConfig(name="impala", storage_path=sys.argv[1])).fit()
m = grid[0].metrics
weights = grid[0].checkpoint.to_dict()["weights"]
rt.shutdown()

cfg = impala.ImpalaConfig()
cfg.cnn, cfg.seed = True, SEED
params, _ = impala._init_params_and_opt(cfg, cs.ATARI_OBS, cs.ATARI_ACTIONS,
                                        device="cuda")
params = cs.to_device(params, "cpu")
p0 = params_to_numpy(params)
update = impala._make_update_fn(cfg, impala.make_optimizer(cfg, params))
for i in range(ITERS):
    update(params, to_learner(impala.time_major(
        cs.smoke_rollout(SEED, i, T, B)), "cpu"))
cpu = params_to_numpy(params)
worst = 0.0
for a, b, w0 in zip(optim.tree_leaves(weights), optim.tree_leaves(cpu),
                    optim.tree_leaves(p0)):
    tol = cs.RL_MOVE_RTOL * np.linalg.norm(b - w0) + cs.RL_ULP * \
        np.linalg.norm(b)
    worst = max(worst, float(np.linalg.norm(a - b) / tol))
print("RESULT " + json.dumps({
    "errors": [str(e) for e in grid.errors], "device": m["device"],
    "steps": m["num_env_steps_sampled"], "launches": m["launches"],
    "finite": all(np.isfinite(v) for v in m.values()
                  if isinstance(v, float)),
    "worst": worst}))
"""


def test_rllib_impala_algorithm_in_tune_trial_on_card(cuda, tmp_path):
    """Phase 20 at a short rollout (T=8 x B=4 frames): ``chip_smoke``'s
    ``SmokeImpala`` (the port's ``Impala`` with a stub runner) in a Tune
    trial holding the card trains its Nature-CNN learner on the card for 3
    iterations; its final weights hold against the CPU learner replayed
    from the same initial weights over the same rollouts at phase 14's
    tolerances, and no flash kernel launches."""
    out = _run_card_driver(tmp_path, RLLIB_ON_CARD,
                           [str(tmp_path / "results")])
    assert out["errors"] == []
    assert out["device"] == "cuda:0"
    assert out["steps"] == 3 * 8 * 4
    assert out["finite"]
    assert out["launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0,
                               "flash_bwd_dkv": 0}
    assert out["worst"] <= 1.0


WORKFLOW_ON_CARD = """
import json, os, pickle, sys
import torch
import ray_tpu_torch as rt
from ray_tpu_torch import workflow


def draw():
    g = torch.Generator(device="cuda").manual_seed(11)
    return torch.randn(256, 128, device="cuda", generator=g).to(
        torch.bfloat16)


def rows(t, flag):
    if not os.path.exists(flag):
        open(flag, "w").close()
        raise RuntimeError("fails once")
    return [t.shape[0], torch.cuda.is_available()]


rt.init(num_cpus=2)
workflow.init_storage(os.path.join(sys.argv[1], "wf"))
flag = os.path.join(sys.argv[1], "flag")
dag = rt.remote(max_retries=0)(rows).bind(
    rt.remote(num_gpus=1)(draw).bind(), flag)
try:
    workflow.run(dag, workflow_id="w")
except Exception:
    pass
with open(os.path.join(sys.argv[1], "wf", "w", "000_draw.pkl"), "rb") as f:
    ckpt = pickle.load(f)
resumed = workflow.resume("w")
want = draw().cpu()
rt.shutdown()
print("RESULT " + json.dumps({
    "device": ckpt.device.type, "dtype": str(ckpt.dtype),
    "same": torch.equal(ckpt.view(torch.int16), want.view(torch.int16)),
    "resumed": resumed}))
"""


def test_workflow_gpu_step_checkpoints_bf16_on_the_host(cuda, tmp_path):
    """A workflow step run as a GPU task returns a bf16 tensor on the card;
    its checkpoint holds a bf16 CPU tensor bit-equal to the same draw, and
    the CPU step that failed once runs on resume without the card."""
    out = _run_card_driver(tmp_path, WORKFLOW_ON_CARD, [str(tmp_path)])
    assert out == {"device": "cpu", "dtype": "torch.bfloat16", "same": True,
                   "resumed": [256, False]}
