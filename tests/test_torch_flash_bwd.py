"""Backward of ray_tpu_torch.ops.flash_attention against the JAX package's
Pallas backward kernels.

The same numpy inputs (fixed seed) go through the JAX backward — its Pallas
kernels in interpret mode, as tests/test_parallel.py runs them on the CPU —
and through the port's ``_flash_bwd``/``_flash_bwd_bshd``, whose CPU path
is the plain version of the CUDA kernels (``_reference_attention_bwd``).
Both sides get the same (o, lse) from the JAX forward, so the comparison
is of the backward alone.  The CUDA kernels themselves run only on the
card (chip_smoke.py and tests/test_torch_cuda.py hold them against the
plain version there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jfa
from ray_tpu_torch.ops import flash_attention as tfa

# f32: both sides are f32 arithmetic in another order, exp2 against exp;
# measured <= 3.1e-6 on gradients up to ~4.
F32_TOL = 1e-4
# bf16: the JAX kernels round q * sm_scale * log2(e), the base-2 exponent
# s - lse, p, dp - delta and ds to bf16; the exponent alone (up to ~10,
# 2^-8 relative) moves p by up to ~3%.  The port's plain version rounds
# only its outputs.  Measured <= 2.2% of the largest |gradient|; held to
# 5% of it, per gradient.
BF16_REL = 0.05

# route -> (shape, layout): the Pallas kernel each one reaches
ROUTES = {
    # _bwd_fused_kernel, whole-S block (rows 2 of the kernel table)
    "fused128": ((1, 2, 128, 32), "bhsd"),
    "fused100": ((1, 2, 100, 32), "bhsd"),
    # _bwd_dq_kernel + _bwd_dkv_kernel, 2 x 2 blocks of 128 (rows 3, 4)
    "split": ((1, 2, 256, 32), "bhsd"),
    # _bwd_fused_kernel_lanes, two 64-dim heads per lane block (row 6)
    "lanes": ((1, 256, 2, 64), "bshd"),
}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _arrays(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _jax_fwd_bwd(route, qkvd, causal, delta=None, lse_shift=0.0):
    """(o, lse, (dq, dk, dv)) of the JAX route, Pallas in interpret mode;
    the backward uses lse + lse_shift and the given delta."""
    q, k, v, do = qkvd
    shape, layout = ROUTES[route]
    if route == "split":
        scale = shape[-1] ** -0.5
        o, lse = jfa._pallas_forward(q, k, v, scale, causal, 128, 128,
                                     interpret=True)
        grads = jfa._pallas_backward(q, k, v, o, lse + lse_shift, do, scale,
                                     causal, 128, 128, interpret=True,
                                     delta=delta)
        return o, lse, grads
    S = q.shape[2] if layout == "bhsd" else q.shape[1]
    # the Pallas kernel, not the XLA reference, must be what JAX runs here
    assert jfa._use_pallas(q, S, S, S) is False  # interpret mode
    if layout == "bshd":
        assert jfa._bshd_lanes_bwd_ok(q, S)
        assert delta is None and lse_shift == 0.0  # no such arguments
        o, res = jfa._flash_fwd_bshd(q, k, v, causal, None, None, None)
        return o, res[4], jfa._flash_bwd_bshd(causal, None, None, None, res,
                                              do)
    o, res = jfa._flash_fwd(q, k, v, causal, None, None, None)
    lse = res[4]
    res = (q, k, v, o, lse + lse_shift)
    return o, lse, jfa._flash_bwd(causal, None, None, None, res, do, delta)


def _port_bwd(route, qkvd, o, lse, causal, delta=None, lse_shift=0.0):
    layout = ROUTES[route][1]
    res = (*qkvd[:3], o, lse + lse_shift)
    bwd = tfa._flash_bwd if layout == "bhsd" else tfa._flash_bwd_bshd
    return bwd(causal, None, None, None, res, qkvd[3], delta)


def _to_torch(x, dtype):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _assert_grads_close(port, jax_grads, dtype_name):
    for name, a, b in zip(("dq", "dk", "dv"), port, jax_grads):
        b = np.asarray(b, np.float32)
        atol = F32_TOL if dtype_name == "f32" else BF16_REL * np.abs(b).max()
        np.testing.assert_allclose(a.float().numpy(), b, atol=atol, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("route", list(ROUTES))
def test_backward_matches_pallas(route, dtype, causal):
    jdt, tdt = DTYPES[dtype]
    arrays = _arrays(ROUTES[route][0])
    o, lse, jg = _jax_fwd_bwd(route, [jnp.asarray(x, jdt) for x in arrays],
                              causal)
    qkvd = [_to_torch(x, tdt) for x in arrays]
    port = _port_bwd(route, qkvd, _to_torch(o, tdt),
                     _to_torch(lse, torch.float32), causal)
    assert all(g.dtype == tdt for g in port)
    _assert_grads_close(port, jg, dtype)


@pytest.mark.parametrize("route", ["fused100", "split"])
def test_given_lse_and_delta_are_used_as_given(route):
    """Ring attention's contract: a global lse and a precomputed delta that
    differ from the chunk's own are used, not recomputed."""
    arrays = _arrays(ROUTES[route][0], seed=3)
    jq = [jnp.asarray(x) for x in arrays]
    B, H, S, _ = arrays[0].shape
    delta = np.random.default_rng(4).standard_normal((B, H, S)).astype(
        np.float32)
    o, lse, jg = _jax_fwd_bwd(route, jq, True, jnp.asarray(delta), 0.25)
    qkvd = [_to_torch(x, torch.float32) for x in arrays]
    o_t, lse_t = _to_torch(o, torch.float32), _to_torch(lse, torch.float32)
    port = _port_bwd(route, qkvd, o_t, lse_t, True, torch.from_numpy(delta),
                     0.25)
    _assert_grads_close(port, jg, "f32")
    own = _port_bwd(route, qkvd, o_t, lse_t, True)
    assert all((a - b).abs().max() > 1e-2 for a, b in zip(port, own))


def test_mixed_dtypes_give_each_input_its_dtype():
    """f32 q (so f32 o and do) with bf16 k, v: dq comes back f32, dk and dv
    bf16, as the JAX kernels return them."""
    q, k, v, do = _arrays(ROUTES["fused128"][0], seed=5)
    jdt = (jnp.float32, jnp.bfloat16, jnp.bfloat16, jnp.float32)
    o, lse, jg = _jax_fwd_bwd(
        "fused128", [jnp.asarray(x, d) for x, d in zip((q, k, v, do), jdt)],
        True)
    assert [g.dtype for g in jg] == [jnp.float32, jnp.bfloat16, jnp.bfloat16]
    tdt = (torch.float32, torch.bfloat16, torch.bfloat16, torch.float32)
    qkvd = [_to_torch(x, d) for x, d in zip((q, k, v, do), tdt)]
    port = _port_bwd("fused128", qkvd, _to_torch(o, torch.float32),
                     _to_torch(lse, torch.float32), True)
    assert [g.dtype for g in port] == list(tdt[:3])
    _assert_grads_close(port, jg, "bf16")


@pytest.mark.parametrize("route", ["fused100", "lanes"])
def test_noncontiguous_do(route):
    """A do that is a transposed view (another layout's memory) gives the
    same gradients as its contiguous copy, and JAX's."""
    arrays = _arrays(ROUTES[route][0], seed=6)
    o, lse, jg = _jax_fwd_bwd(route, [jnp.asarray(x) for x in arrays], False)
    qkvd = [_to_torch(x, torch.float32) for x in arrays]
    do_t = qkvd[3].transpose(1, 2).contiguous().transpose(1, 2)
    assert not do_t.is_contiguous() and torch.equal(do_t, qkvd[3])
    o_t, lse_t = _to_torch(o, torch.float32), _to_torch(lse, torch.float32)
    port = _port_bwd(route, [*qkvd[:3], do_t], o_t, lse_t, False)
    _assert_grads_close(port, jg, "f32")
    for a, b in zip(port, _port_bwd(route, qkvd, o_t, lse_t, False)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_plain_backward_is_the_true_gradient(layout, causal):
    """gradcheck in float64: the plain backward against finite differences
    of the plain forward, through the public autograd entry points."""
    g = torch.Generator().manual_seed(7)
    shape = (1, 2, 6, 4) if layout == "bhsd" else (1, 6, 2, 4)
    fn = tfa.flash_attention if layout == "bhsd" \
        else tfa.flash_attention_bshd
    qkv = [torch.randn(shape, generator=g, dtype=torch.float64,
                       requires_grad=True) for _ in range(3)]
    assert torch.autograd.gradcheck(lambda q, k, v: fn(q, k, v, causal), qkv)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_second_order_gradient_raises(layout):
    """The backward is once-differentiable: a gradient taken with
    create_graph=True cannot be differentiated again, on the CPU as on the
    card, whose kernels return gradients with no graph behind them."""
    g = torch.Generator().manual_seed(10)
    fn = tfa.flash_attention if layout == "bhsd" \
        else tfa.flash_attention_bshd
    q, k, v = (torch.randn((1, 2, 6, 4), generator=g, requires_grad=True)
               for _ in range(3))
    dq, = torch.autograd.grad((fn(q, k, v, True) ** 2).sum(), q,
                              create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dq.sum().backward()


def test_block_hints_do_not_change_gradients():
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in _arrays((1, 37, 3, 32), seed=8)[:3])
    grads = []
    for bq, bk in ((None, None), (16, 8)):
        o = tfa.flash_attention_bshd(q, k, v, True, None, bq, bk)
        grads.append(torch.autograd.grad((o * o).sum(), (q, k, v)))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_jax_grad_through_public_api_matches():
    """jax.grad through jfa.flash_attention (custom_vjp -> the fused Pallas
    backward) against torch autograd through tfa.flash_attention."""
    q, k, v, _ = _arrays(ROUTES["fused100"][0], seed=9)
    jg = jax.grad(lambda q, k, v: jnp.sum(jfa.flash_attention(q, k, v, True)
                                          ** 2), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    (tfa.flash_attention(tq, tk, tv, True) ** 2).sum().backward()
    _assert_grads_close((tq.grad, tk.grad, tv.grad), jg, "f32")


# (B, H, S, SMs): the training shape and its gradient check (B=4),
# chip_smoke.py's phase-2b shapes, tests/test_torch_cuda.py's (ragged S,
# one tile, a ring wrapped many times), and cards of fewer SMs
BWD_PLAN_SHAPES = [
    (16, 12, 1024, 132), (4, 12, 1024, 132), (1, 12, 1000, 132),
    (1, 32, 2048, 132), (1, 4, 100, 132), (2, 3, 1, 132), (2, 3, 63, 132),
    (2, 3, 65, 132), (2, 3, 200, 132), (2, 3, 1000, 132),
    (1, 12, 1024, 96), (1, 12, 1000, 66), (16, 12, 1024, 1)]


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("B,H,S,sms", BWD_PLAN_SHAPES)
def test_bwd_plan(B, H, S, sms, D):
    """The dk/dv kernel's plan: shared memory within Hopper's 227 KB a
    block; two consumer warpgroups (128 k rows) only where B·H·⌈S/128⌉
    blocks still give each SM one, and not at D = 128 (their accumulators
    do not fit in 168 registers); k blocks that cover S and no more; four
    ring slots; the swizzle that keeps a box row within 128 bytes; the
    layout of csrc/flash_bwd.cu's DkvSmem."""
    plan = tfa._bwd_plan(B, H, S, D, sms)
    assert plan.smem_bytes <= tfa.SMEM_PER_BLOCK == 227 * 1024
    two = D < 128 and B * H * -(-S // 128) >= sms
    assert plan.block_n == (128 if two else 64)
    assert (plan.k_blocks - 1) * plan.block_n < S <= \
        plan.k_blocks * plan.block_n
    assert plan.stages == 4 and plan.swizzle == min(D * 2, 128)
    tile = 64 * D * 2
    k_and_v = 2 * plan.block_n // 64 * tile
    ring = plan.stages * (2 * tile + 2 * 64 * 4)
    assert plan.smem_bytes == (k_and_v + ring + 8 * (1 + 2 * plan.stages)
                               + 1024)
    if sms == tfa.H100_SMS:
        assert tfa._bwd_plan(B, H, S, D) == plan


def test_bwd_plan_at_the_training_shape():
    """Training (B=16, S=1024) takes 128-row blocks, 1536 of them; one
    sequence of 12 heads (96 blocks of 128 rows on 132 SMs) takes 64, as
    does D = 128 everywhere."""
    train = tfa._bwd_plan(16, 12, 1024, 64)
    assert (train.block_n, train.k_blocks) == (128, 8)
    assert tfa._bwd_plan(16, 12, 1024, 128).block_n == 64
    assert tfa._bwd_plan(1, 12, 1024, 64).block_n == 64
    assert tfa._bwd_plan(1, 12, 1024, 64, sms=96).block_n == 128


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("B,H,S,sms", BWD_PLAN_SHAPES)
def test_dq_plan(B, H, S, sms, D):
    """The dq kernel's plan: shared memory within Hopper's 227 KB a block;
    two consumer warpgroups (128 q rows) only at D = 128 and where
    B·H·⌈S/128⌉ blocks still give each SM one; q blocks that cover S and
    no more; four ring slots; the swizzle that keeps a box row within 128
    bytes; the layout of csrc/flash_bwd.cu's DqSmem (the block's q and do tiles, the ring's
    k and v tiles, the barriers, 1024 bytes of alignment slack)."""
    plan = tfa._dq_plan(B, H, S, D, sms)
    assert plan.smem_bytes <= tfa.SMEM_PER_BLOCK == 227 * 1024
    two = D == 128 and B * H * -(-S // 128) >= sms
    assert plan.block_m == (128 if two else 64)
    assert (plan.q_blocks - 1) * plan.block_m < S <= \
        plan.q_blocks * plan.block_m
    assert plan.stages == 4 and plan.swizzle == min(D * 2, 128)
    tile = 64 * D * 2
    q_and_do = 2 * plan.block_m // 64 * tile
    ring = plan.stages * 2 * tile
    assert plan.smem_bytes == (q_and_do + ring + 8 * (1 + 2 * plan.stages)
                               + 1024)
    if sms == tfa.H100_SMS:
        assert tfa._dq_plan(B, H, S, D) == plan


def test_dq_plan_at_the_training_shape():
    """Training (B=16, S=1024, D=64) takes 64-row blocks, 16 q blocks a
    (batch, head): two blocks share an SM.  At D = 128 one sequence of 32
    heads takes 128-row blocks (512 of them), and one of 8 heads (64 on
    132 SMs) 64-row ones, 128 again on a card of 64 SMs."""
    train = tfa._dq_plan(16, 12, 1024, 64)
    assert (train.block_m, train.q_blocks) == (64, 16)
    assert tfa._dq_plan(1, 12, 1024, 64, sms=1).block_m == 64
    assert tfa._dq_plan(1, 32, 2048, 128).block_m == 128
    assert tfa._dq_plan(1, 8, 1024, 128).block_m == 64
    assert tfa._dq_plan(1, 8, 1024, 128, sms=64).block_m == 128


@pytest.mark.parametrize("name", ["base", "pipeline", "dp_with_s",
                                  "dp_first", "offset", "stages3",
                                  "stages5", "grid_hbn", "grid_n_fast"])
def test_flash_bwd_ab_patches_match_the_kernel(name):
    """flash_bwd_ab.py's variants are text patches of csrc/flash_bwd.cu:
    each applies exactly once (the phase counters to the kernel as it is,
    and with every patch but "pipeline", which moves their last anchor),
    so the A/B numbers in PERF.md can be remade from the kernel as it
    is."""
    import flash_bwd_ab

    phases = name != "pipeline"
    src = flash_bwd_ab.variant_source(name, phases)
    assert src.count("TICK(p") == 7 * phases
    if name != "base":
        assert src != flash_bwd_ab.variant_source("base", phases)


@pytest.mark.parametrize("name", ["base", "mask_select", "dp_with_s",
                                  "stages3", "stages5", "grid_m_fast",
                                  "grid_hbm"])
def test_flash_bwd_ab_dq_patches_match_the_kernel(name):
    """flash_bwd_ab.py's dq variants apply to csrc/flash_bwd.cu exactly
    once, with and without the dq phase counters."""
    import flash_bwd_ab

    for phases in (False, True):
        src = flash_bwd_ab.variant_source(name, phases, "dq")
        assert src.count("TICK(p") == 7 * phases
        if name != "base":
            assert src != flash_bwd_ab.variant_source("base", phases, "dq")
