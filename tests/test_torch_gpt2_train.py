"""The training half of ray_tpu_torch.models.gpt2 against ray_tpu.models.gpt2
at GPT2_TINY: loss, gradients of every leaf, AdamW steps and the FLOP
count; remat (with the dense FFN and with MoE) and the chunked
cross-entropy (``xent_chunks``).

Parameters come from the JAX ``init_params`` and cross as numpy arrays
(``params_from_numpy``); tokens come from numpy with a fixed seed.  S = 100
is not a multiple of 128, so the JAX side's attention runs the bhsd Pallas
kernels in interpret mode, whole-S blocks: the fused backward
(``_bwd_fused_kernel``).  The port's CPU path runs the plain versions of
its CUDA kernels."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import gpt2 as jg
from ray_tpu_torch.models import gpt2 as tg

JCFG = jg.GPT2_TINY
B, S = 2, 100

# loss, f32 compute: the same f32 arithmetic in another order (measured
# 1e-6 relative).  bf16: each side rounds activations at slightly other
# places (measured 4e-5 on a loss of 6.27).
LOSS_TOL = {"f32": 1e-5, "bf16": 1e-3}
# gradients, |g - g_jax| <= REL * max |g_jax| per leaf.  f32: measured
# 7.8e-7; bf16: the JAX kernels round p, ds and the softmax exponent to
# bf16 (tests/test_torch_flash_bwd.py), measured 1.8e-2.
GRAD_REL = {"f32": 1e-5, "bf16": 5e-2}
# parameters after 3 AdamW steps (lr 1e-3).  Adam divides each gradient
# element by its own running scale, so an element whose gradient is near
# the rounding noise of its sum moves by up to lr per step in either run
# whatever its size.  f32: gradients agree to ~1e-6; measured 5.3e-6 per
# element, held to 5e-5, and each leaf to 1e-4 of its norm.  bf16:
# gradients agree to ~2% of their largest element, so small elements can
# move the other way: the bound is 2 * lr per step, 6e-3 after 3 steps
# (measured 5.3e-3); the losses of the steps carry the comparison there.
STEPS, LR = 3, 1e-3
PARAM_ATOL = {"f32": 5e-5, "bf16": 2 * LR * STEPS}
PARAM_NORM_REL_F32 = 1e-4
# gradients of the MoE model in bf16, per leaf by norm: a few tokens route
# to other experts on the two sides (tests/test_torch_gpt2_moe.py, which
# states the measurement)
GRAD_NORM_REL_MOE_BF16 = 0.15


@pytest.fixture(scope="module")
def jax_params():
    return jg.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, JCFG.vocab_size, (B, S + 1))


def _cfgs(dtype, **kw):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jc = jg.GPT2Config(**{**JCFG.__dict__, "compute_dtype": jdt, **kw})
    return jc, replace(tg.GPT2_TINY, compute_dtype=tdt, **kw)


def _master(jax_params, tc):
    params = tg.params_from_numpy(jax.tree.map(np.asarray, jax_params), tc,
                                  device="cpu")
    for leaf in tg.param_leaves(params):
        leaf.requires_grad_(True)
    return params


def _port_loss_and_grads(params, tokens, tc, xent_chunks=0):
    loss = tg.loss_fn(tg._cast_weights(params, tc.compute_dtype),
                      {"tokens": torch.from_numpy(tokens)}, tc,
                      xent_chunks=xent_chunks)
    loss.backward()
    return loss.item(), [p.grad for p in tg.param_leaves(params)]


def _jax_loss_and_grads(jax_params, tokens, jc, xent_chunks=0):
    batch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    loss, grads = jax.value_and_grad(lambda p: jg.loss_fn(
        jg._cast_weights(p, jc.compute_dtype), batch, jc,
        xent_chunks=xent_chunks))(jax_params)
    return float(loss), [np.asarray(g, np.float32)
                         for g in jax.tree.leaves(grads)]


def _assert_grads_close(names, grads, refs, dtype, moe=False):
    for name, g, ref in zip(names, grads, refs):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        if dtype == "bf16" and moe:
            assert (np.linalg.norm(g - ref)
                    <= GRAD_NORM_REL_MOE_BF16 * np.linalg.norm(ref)), name
        else:
            np.testing.assert_allclose(
                g, ref, rtol=0, atol=GRAD_REL[dtype] * np.abs(ref).max(),
                err_msg=name)


def test_param_leaves_follow_jax_tree_order(jax_params):
    params = _master(jax_params, tg.GPT2_TINY)
    names = [n for n, _ in tg.named_leaves(params)]
    paths = [jax.tree_util.keystr(p, simple=True, separator="/")
             for p, _ in jax.tree_util.tree_leaves_with_path(jax_params)]
    assert names == paths
    for leaf, ref in zip(tg.param_leaves(params), jax.tree.leaves(jax_params)):
        assert tuple(leaf.shape) == ref.shape


def test_cast_weights_casts_matrices_and_tables_only(jax_params):
    cast = tg._cast_weights(_master(jax_params, tg.GPT2_TINY), torch.bfloat16)
    for name, leaf in tg.named_leaves(cast):
        want = torch.bfloat16 if leaf.dim() >= 2 else torch.float32
        assert leaf.dtype == want, name
    assert cast["wte"]["embedding"].dtype == torch.bfloat16
    assert cast["wpe"]["embedding"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_loss_and_grads_match_jax(jax_params, tokens, dtype):
    """loss_fn through _cast_weights and every leaf's f32 gradient, against
    jax.value_and_grad of the same closure the JAX train step uses."""
    jc, tc = _cfgs(dtype)
    batch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    jl, jgrads = jax.value_and_grad(lambda p: jg.loss_fn(
        jg._cast_weights(p, jc.compute_dtype), batch, jc))(jax_params)
    params = _master(jax_params, tc)
    loss, grads = _port_loss_and_grads(params, tokens, tc)
    assert loss == pytest.approx(float(jl), rel=LOSS_TOL[dtype])
    for (name, _), g, ref in zip(tg.named_leaves(params), grads,
                                 jax.tree.leaves(jgrads)):
        assert g.dtype == torch.float32, name
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(
            g.numpy(), ref, rtol=0,
            atol=GRAD_REL[dtype] * np.abs(ref).max(), err_msg=name)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_adamw_steps_match_optax(jax_params, tokens, dtype):
    """3 steps of make_train_step with torch.optim.AdamW against 3 of the
    JAX make_train_step with optax.adamw(1e-3): the same update rule
    (bias-corrected moments, decay of the pre-update parameter), optax's
    defaults spelled out for torch (weight_decay 1e-4, eps 1e-8)."""
    _adamw_steps_match_optax(jax_params, tokens, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_remat_chunked_adamw_steps_match_optax(jax_params, tokens, dtype):
    """The same 3 steps with remat=True and xent_chunks=4 on both sides:
    make_train_step passes xent_chunks to loss_fn."""
    _adamw_steps_match_optax(jax_params, tokens, dtype, xent_chunks=4,
                             remat=True)


def _adamw_steps_match_optax(jax_params, tokens, dtype, xent_chunks=0,
                             **kw):
    jc, tc = _cfgs(dtype, **kw)
    opt = optax.adamw(LR)
    jstep = jax.jit(jg.make_train_step(jc, opt, xent_chunks=xent_chunks))
    batch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    jp, state, jlosses = jax_params, opt.init(jax_params), []
    for _ in range(STEPS):
        jp, state, m = jstep(jp, state, batch)
        jlosses.append(float(m["loss"]))

    params = _master(jax_params, tc)
    topt = torch.optim.AdamW(tg.param_leaves(params), lr=LR,
                             betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    step = tg.make_train_step(tc, topt, xent_chunks=xent_chunks)
    tbatch = {"tokens": torch.from_numpy(tokens)}
    losses = [step(params, tbatch)["loss"].item() for _ in range(STEPS)]
    assert losses == pytest.approx(jlosses, rel=LOSS_TOL[dtype])
    assert losses[-1] < losses[0]
    E = JCFG.n_embd
    for (name, leaf), ref in zip(tg.named_leaves(params),
                                 jax.tree.leaves(jp)):
        assert leaf.grad is None, name  # zero_grad(set_to_none=True)
        a, b = leaf.detach().numpy(), np.asarray(ref)
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL[dtype],
                                   err_msg=name)
        if dtype != "f32":
            continue
        if name.endswith("c_attn/bias"):
            # the key bias adds q . b_k to every score of a row, which the
            # softmax cancels: its true gradient is 0, and Adam turns the
            # rounding noise in its place into steps of up to lr; it is
            # held elementwise only
            a, b = np.delete(a, np.s_[E:2 * E]), np.delete(b, np.s_[E:2 * E])
        assert (np.linalg.norm(a - b) <= PARAM_NORM_REL_F32
                * np.linalg.norm(b)), name


@pytest.mark.parametrize("moe", [0, 4], ids=["mlp", "moe"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_remat_matches_jax_and_no_remat(dtype, moe, tokens):
    """remat=True (each block under torch.utils.checkpoint) against the JAX
    model with remat=True (jax.checkpoint), loss and every leaf's gradient
    held as without remat; and against the port without remat, equal bit
    for bit: the backward recomputes each block by the same arithmetic on
    the same inputs."""
    jax_params = jg.init_params(jax.random.PRNGKey(0),
                                replace(JCFG, moe_experts=moe))
    jc, tc = _cfgs(dtype, moe_experts=moe, remat=True)
    jl, jgrads = _jax_loss_and_grads(jax_params, tokens, jc)
    params = _master(jax_params, tc)
    loss, grads = _port_loss_and_grads(params, tokens, tc)
    assert loss == pytest.approx(jl, rel=LOSS_TOL[dtype])
    names = [n for n, _ in tg.named_leaves(params)]
    _assert_grads_close(names, grads, jgrads, dtype, moe > 0)

    plain = _master(jax_params, tc)
    loss0, grads0 = _port_loss_and_grads(plain, tokens,
                                         replace(tc, remat=False))
    assert loss == loss0
    for name, g, g0 in zip(names, grads, grads0):
        assert torch.equal(g, g0), name


@pytest.mark.parametrize("chunks", [1, 4, 7])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_chunked_xent_matches_jax(jax_params, tokens, dtype, chunks):
    """loss_fn(xent_chunks=) and every leaf's gradient against JAX's
    loss_fn(xent_chunks=), and against the port's dense head, with the
    tolerances of the dense head.  N = B * S = 200: 7 chunks fall to 5."""
    jc, tc = _cfgs(dtype)
    jl, jgrads = _jax_loss_and_grads(jax_params, tokens, jc, chunks)
    params = _master(jax_params, tc)
    loss, grads = _port_loss_and_grads(params, tokens, tc, chunks)
    assert loss == pytest.approx(jl, rel=LOSS_TOL[dtype])
    names = [n for n, _ in tg.named_leaves(params)]
    _assert_grads_close(names, grads, jgrads, dtype)
    dense_loss, dense = _port_loss_and_grads(_master(jax_params, tc),
                                             tokens, tc)
    assert loss == pytest.approx(dense_loss, rel=LOSS_TOL[dtype])
    _assert_grads_close(names, grads, [g.numpy() for g in dense], dtype)


def test_chunked_xent_falls_to_a_divisor(monkeypatch):
    """7 chunks of N = 200 rows fall to 5 of 40, each under checkpoint, and
    the summed loss is the dense one's."""
    rows = []
    real = tg.checkpoint

    def spy(fn, x, *args, **kw):
        rows.append(x.shape[0])
        return real(fn, x, *args, **kw)

    monkeypatch.setattr(tg, "checkpoint", spy)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((200, 16), generator=g, requires_grad=True)
    wte = torch.randn((32, 16), generator=g, requires_grad=True)
    t = torch.randint(0, 32, (200,), generator=g)
    total = tg._chunked_xent(x, wte, t, 7)
    assert rows == [40] * 5
    logits = x @ wte.T
    dense = (torch.logsumexp(logits, -1) - logits[torch.arange(200), t]).sum()
    assert total.item() == pytest.approx(dense.item(), rel=1e-6)
    # gradients: f32 sums over the rows of five chunks in place of one
    # (measured 4e-7 of the largest element of wte's, ~24)
    for got, want in zip(torch.autograd.grad(total, (x, wte)),
                         torch.autograd.grad(dense, (x, wte))):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-6 * want.abs().max().item())


def test_count_flops_per_token_matches_jax():
    for name in ("SMALL", "MEDIUM", "XL"):
        for seq in (128, 1024):
            assert tg.count_flops_per_token(getattr(tg, f"GPT2_{name}"),
                                            seq) == \
                jg.count_flops_per_token(getattr(jg, f"GPT2_{name}"), seq)
