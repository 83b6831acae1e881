"""The training half of ray_tpu_torch.models.gpt2 against ray_tpu.models.gpt2
at GPT2_TINY: loss, gradients of every leaf, AdamW steps and the FLOP
count.

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


@pytest.fixture(scope="module")
def jax_params():
    return jg.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, JCFG.vocab_size, (B, S + 1))


def _cfgs(dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jc = jg.GPT2Config(**{**JCFG.__dict__, "compute_dtype": jdt})
    return jc, replace(tg.GPT2_TINY, compute_dtype=tdt)


def _master(jax_params, tc):
    params = tg.params_from_numpy(jax.tree.map(np.asarray, jax_params), tc,
                                  device="cpu")
    for leaf in tg.param_leaves(params):
        leaf.requires_grad_(True)
    return params


def _port_loss_and_grads(params, tokens, tc):
    loss = tg.loss_fn(tg._cast_weights(params, tc.compute_dtype),
                      {"tokens": torch.from_numpy(tokens)}, tc)
    loss.backward()
    return loss.item(), [p.grad for p in tg.param_leaves(params)]


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


def test_remat_raises_not_implemented(jax_params, tokens):
    """remat is not ported: a train step that asks for it raises before it
    touches the parameters or the optimizer."""
    tc = replace(tg.GPT2_TINY, compute_dtype=torch.float32, remat=True)
    params = _master(jax_params, replace(tc, remat=False))
    opt = torch.optim.AdamW(tg.param_leaves(params), lr=LR)
    before = [t.detach().clone() for t in tg.param_leaves(params)]
    with pytest.raises(NotImplementedError, match="remat"):
        tg.make_train_step(tc, opt)(params,
                                    {"tokens": torch.from_numpy(tokens)})
    assert all(torch.equal(a, b)
               for a, b in zip(before, tg.param_leaves(params)))
    assert not opt.state


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_adamw_steps_match_optax(jax_params, tokens, dtype):
    """3 steps of make_train_step with torch.optim.AdamW against 3 of the
    JAX make_train_step with optax.adamw(1e-3): the same update rule
    (bias-corrected moments, decay of the pre-update parameter), optax's
    defaults spelled out for torch (weight_decay 1e-4, eps 1e-8)."""
    jc, tc = _cfgs(dtype)
    opt = optax.adamw(LR)
    jstep = jax.jit(jg.make_train_step(jc, opt))
    batch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    jp, state, jlosses = jax_params, opt.init(jax_params), []
    for _ in range(STEPS):
        jp, state, m = jstep(jp, state, batch)
        jlosses.append(float(m["loss"]))

    params = _master(jax_params, tc)
    topt = torch.optim.AdamW(tg.param_leaves(params), lr=LR,
                             betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    step = tg.make_train_step(tc, topt)
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


def test_count_flops_per_token_matches_jax():
    for name in ("SMALL", "MEDIUM", "XL"):
        for seq in (128, 1024):
            assert tg.count_flops_per_token(getattr(tg, f"GPT2_{name}"),
                                            seq) == \
                jg.count_flops_per_token(getattr(jg, f"GPT2_{name}"), seq)
