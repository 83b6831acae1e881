"""The mixture-of-experts GPT-2 of ray_tpu_torch.models.gpt2 against
ray_tpu.models.gpt2 at GPT2_TINY with 4 experts (top-2, capacity factor
1.5 unless a case changes it): routing with drops and ties, the FFN's
output and aux loss, logits, the loss with its aux term, every leaf's
gradient and AdamW steps.

Parameters come from the JAX ``init_params`` and cross as numpy arrays
(``params_from_numpy``); inputs come from numpy with a fixed seed.  S = 100
is not a multiple of 128, so the JAX side's attention runs the bhsd Pallas
kernels in interpret mode; the port's CPU path runs the plain versions of
its CUDA kernels."""

import contextlib
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import gpt2 as jg
from ray_tpu_torch.models import gpt2 as tg

N_EXP = 4
JCFG = jg.GPT2Config(**{**jg.GPT2_TINY.__dict__, "moe_experts": N_EXP})
B, S = 2, 100
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}

# _moe_mlp on the same input.  f32: the same arithmetic in another order
# (measured 7e-9 on |y| <= 0.04).  bf16: both sides route alike (the
# router's logits are one bf16 product on the same operands); the expert
# products round h and their outputs to bf16 after sums in another order,
# ~2 ulp (measured 2.4e-4 on |y| <= 0.043): held to 2e-2 of max |y|.
Y_TOL = {"f32": 1e-6, "bf16": 2e-2}
AUX_REL = {"f32": 1e-6, "bf16": 1e-5}
# logits of the whole model: as tests/test_torch_gpt2.py holds the dense
# FFN (measured 3e-7 f32; 3.9e-3 bf16, where a few routes differ, below).
LOGITS_TOL = {"f32": 1e-4, "bf16": 2e-2}
# loss, as tests/test_torch_gpt2_train.py holds the dense FFN (measured
# 0 f32, 8.5e-5 relative bf16).
LOSS_TOL = {"f32": 1e-5, "bf16": 1e-3}
# gradients, per leaf |g - g_jax| <= REL * max |g_jax|, with JAX taking the
# port's expert choices (``_pinned_jax_routes``): f32 measured 8.8e-7;
# bf16 measured 1.8e-2, held as tests/test_torch_gpt2_train.py holds the
# dense FFN.
GRAD_REL = {"f32": 1e-5, "bf16": 5e-2}
# bf16 with each side's own choices: the two round activations at slightly
# other places, so a token whose top-2 router probabilities lie within
# that rounding of each other routes to another expert on one side (1 of
# 200 tokens in layer 0 and 3 in layer 1 here; ROUTE_AGREE holds how
# few); its gradient goes to other expert weights, and the residual
# stream carries the difference on.  Measured per leaf ||g - g_jax|| /
# ||g_jax|| <= 9.3e-2 (largest element 0.22 of max |g_jax|, in an
# expert's wi): held per leaf by norm to 0.15.
GRAD_NORM_REL_BF16 = 0.15
ROUTE_AGREE = 0.95
# AdamW steps: as tests/test_torch_gpt2_train.py (Adam moves an element by
# at most lr a step, so 2 lr a step bounds two runs whatever their
# gradients; f32 measured 5.3e-6 there).
STEPS, LR = 3, 1e-3
PARAM_ATOL = {"f32": 5e-5, "bf16": 2 * LR * STEPS}


@pytest.fixture(scope="module")
def jax_params():
    return jg.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, JCFG.vocab_size, (B, S + 1))


def _cfgs(dtype, **kw):
    jdt, tdt = DTYPES[dtype]
    jc = jg.GPT2Config(**{**JCFG.__dict__, "compute_dtype": jdt, **kw})
    tc = replace(tg.GPT2_TINY, moe_experts=N_EXP, compute_dtype=tdt, **kw)
    return jc, tc


def _port(jax_params, tc, grad=False):
    params = tg.params_from_numpy(jax.tree.map(np.asarray, jax_params), tc,
                                  device="cpu")
    for leaf in tg.param_leaves(params):
        leaf.requires_grad_(grad)
    return params


def test_config_defaults_match_jax():
    j, t = jg.GPT2Config(), tg.GPT2Config()
    for f in ("moe_experts", "moe_top_k", "moe_capacity_factor",
              "moe_aux_weight", "remat"):
        assert getattr(j, f) == getattr(t, f), f


def test_num_params_and_leaf_order_match_jax(jax_params):
    params = _port(jax_params, tg.GPT2_TINY)
    assert tg.num_params(params) == jg.num_params(jax_params)
    names = [n for n, _ in tg.named_leaves(params)]
    paths = [jax.tree_util.keystr(p, simple=True, separator="/")
             for p, _ in jax.tree_util.tree_leaves_with_path(jax_params)]
    assert names == paths
    assert "h_0/moe/router/kernel" in names and not any("mlp" in n
                                                        for n in names)
    _, tc = _cfgs("f32")
    fresh = tg.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    assert [n for n, _ in tg.named_leaves(fresh)] == paths
    for (name, leaf), ref in zip(tg.named_leaves(fresh),
                                 jax.tree.leaves(jax_params)):
        assert tuple(leaf.shape) == ref.shape, name
    moe = fresh["h_0"]["moe"]
    E, proj_std = tc.n_embd, 0.02 / np.sqrt(2 * tc.n_layer)
    assert moe["wi"].shape == (N_EXP, E, 4 * E)
    # std of 65,536 normal draws: within 2% of the JAX initialiser's
    for leaf, std in ((moe["wi"], 0.02), (moe["wo"], proj_std)):
        assert leaf.std().item() == pytest.approx(std, rel=2e-2)


def _router_case(p, case):
    """Router kernel of a case: as drawn, or with forced ties."""
    w = np.array(p["router"]["kernel"])
    if case == "tied_columns":
        w[:, 3] = w[:, 0]      # experts 0 and 3 tie for every token
    elif case == "all_tied":
        w[:] = w[:, :1]        # all four tie: every token routes to 0, 1
    return {**p, "router": {"kernel": w}}


CASES = {"default": 1.5, "drops": 0.3, "tied_columns": 0.5, "all_tied": 1.5}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_mlp_matches_jax(jax_params, dtype, case):
    """y and aux of one MoE FFN on the same input, and the routing: each
    token's experts in the reference's order (``jax.lax.top_k``: ties to
    the lower index), which decides capacity and the aux loss."""
    jc, tc = _cfgs(dtype, moe_capacity_factor=CASES[case])
    p = _router_case(jax.tree.map(np.array, jax_params["h_0"]["moe"]), case)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, S, JCFG.n_embd)).astype(np.float32)).to(tc.compute_dtype)
    xj = jnp.asarray(x.float().numpy()).astype(jc.compute_dtype)
    jy, jaux = jg._moe_mlp(xj, jax.tree.map(jnp.asarray, p), jc)
    tp = {"router": {"kernel": torch.from_numpy(p["router"]["kernel"])},
          "wi": torch.from_numpy(p["wi"]), "wo": torch.from_numpy(p["wo"])}
    y, aux = tg._moe_mlp(x, tp, tc)
    assert y.dtype == tc.compute_dtype and y.shape == (B, S, JCFG.n_embd)
    jy = np.asarray(jy.astype(jnp.float32))
    np.testing.assert_allclose(y.float().numpy(), jy, rtol=0,
                               atol=Y_TOL[dtype] * np.abs(jy).max())
    assert aux.item() == pytest.approx(float(jaux), rel=AUX_REL[dtype])

    xt = x.reshape(-1, JCFG.n_embd)
    probs, gate, idx, pos, C = tg._moe_route(xt, tp["router"]["kernel"], tc)
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), jc.moe_top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    T = B * S
    assert C == max(2, int(CASES[case] * T * 2 / N_EXP))
    dropped = (pos >= C).all(-1)
    if case == "drops":
        assert dropped.any()
        assert (y.reshape(T, -1)[dropped] == 0).all()
    if case == "all_tied":
        assert (idx == torch.tensor([0, 1])).all()
        # choice 0 of every token fills expert 0 first; choice 1 expert 1
        assert (pos == torch.arange(T)[:, None]).all()
    if case == "tied_columns":
        tied = (idx[:, 0] == 0) & (idx[:, 1] == 3)
        assert tied.sum() > 10
        assert not ((idx[:, 0] == 3) & (idx[:, 1] == 0)).any()


@contextlib.contextmanager
def _pinned_jax_routes(monkeypatch, choices):
    """JAX's ``lax.top_k`` returns the next of ``choices`` (the port's
    (T, k) expert indices, one per MoE call) with their probabilities:
    the JAX model with the port's expert choices."""
    replay = iter(choices)

    def top_k(probs, k):
        idx = jnp.asarray(next(replay).numpy())
        return jnp.take_along_axis(probs, idx, axis=-1), idx

    with monkeypatch.context() as m:
        m.setattr(jax.lax, "top_k", top_k)
        yield


def _routes(jax_params, params, tokens, jc, tc):
    """Each layer's (T, k) expert choices in a JAX and a port forward."""
    got = {"jax": [], "port": []}
    jmoe, tmoe = jg._moe_mlp, tg._moe_mlp

    def jspy(x, p, cfg):
        xt = x.reshape(-1, x.shape[-1])
        logits = (xt @ p["router"]["kernel"].astype(x.dtype)).astype(
            jnp.float32)
        got["jax"].append(np.asarray(jax.lax.top_k(
            jax.nn.softmax(logits, -1), cfg.moe_top_k)[1]))
        return jmoe(x, p, cfg)

    def tspy(x, p, cfg):
        got["port"].append(tg._moe_route(x.reshape(-1, x.shape[-1]),
                                         p["router"]["kernel"], cfg)[2])
        return tmoe(x, p, cfg)

    jg._moe_mlp, tg._moe_mlp = jspy, tspy
    try:
        jg.forward(jg._cast_weights(jax_params, jc.compute_dtype),
                   jnp.asarray(tokens[:, :-1]), jc)
        with torch.no_grad():
            tg.forward(tg._cast_weights(params, tc.compute_dtype),
                       torch.from_numpy(tokens[:, :-1]), tc)
    finally:
        jg._moe_mlp, tg._moe_mlp = jmoe, tmoe
    return got


@pytest.mark.parametrize("attention", ["flash", "dense"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_logits_match_jax(jax_params, tokens, dtype, attention):
    jc, tc = _cfgs(dtype, attention=attention)
    jl = np.asarray(jg.forward(jax_params, jnp.asarray(tokens), jc))
    aux_acc = []
    tl = tg.forward(_port(jax_params, tc), torch.from_numpy(tokens), tc,
                    aux_acc)
    assert tl.dtype == torch.float32 and tl.shape == (B, S + 1, 512)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=LOGITS_TOL[dtype])
    assert len(aux_acc) == JCFG.n_layer


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_loss_and_grads_match_jax(jax_params, tokens, dtype,
                                      monkeypatch):
    """loss_fn (cross-entropy + moe_aux_weight x mean aux) through
    _cast_weights and every leaf's gradient, router included, against
    jax.value_and_grad of the same closure the JAX train step uses: with
    JAX taking the port's expert choices, within the dense FFN's
    tolerances; with its own, in bf16, within GRAD_NORM_REL_BF16 and with
    the choices agreeing at ROUTE_AGREE of the tokens."""
    jc, tc = _cfgs(dtype)
    batch = {"tokens": jnp.asarray(tokens, jnp.int32)}

    def jax_loss_and_grads():
        return jax.value_and_grad(lambda p: jg.loss_fn(
            jg._cast_weights(p, jc.compute_dtype), batch, jc))(jax_params)

    params = _port(jax_params, tc, grad=True)
    choices, top_k = [], tg._top_k
    monkeypatch.setattr(tg, "_top_k", lambda probs, k: choices.append(
        top_k(probs, k)) or choices[-1])
    loss = tg.loss_fn(tg._cast_weights(params, tc.compute_dtype),
                      {"tokens": torch.from_numpy(tokens)}, tc)
    loss.backward()
    names = [n for n, _ in tg.named_leaves(params)]
    grads = [leaf.grad.numpy() for leaf in tg.param_leaves(params)]
    assert all(leaf.grad.dtype == torch.float32
               for leaf in tg.param_leaves(params))

    jl, jgrads = jax_loss_and_grads()
    assert loss.item() == pytest.approx(float(jl), rel=LOSS_TOL[dtype])
    if dtype == "bf16":
        for name, g, ref in zip(names, grads, jax.tree.leaves(jgrads)):
            ref = np.asarray(ref, np.float32)
            assert (np.linalg.norm(g - ref)
                    <= GRAD_NORM_REL_BF16 * np.linalg.norm(ref)), name
    with _pinned_jax_routes(monkeypatch, choices):
        jl, jgrads = jax_loss_and_grads()
    assert loss.item() == pytest.approx(float(jl), rel=LOSS_TOL[dtype])
    for name, g, ref in zip(names, grads, jax.tree.leaves(jgrads)):
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(
            g, ref, rtol=0, atol=GRAD_REL[dtype] * np.abs(ref).max(),
            err_msg=name)
    routes = _routes(jax_params, params, tokens, jc, tc)
    for a, b in zip(routes["jax"], routes["port"]):
        agree = (a == b.numpy()).all(-1).mean()
        assert agree == 1.0 if dtype == "f32" else agree >= ROUTE_AGREE


def test_moe_aux_loss_term(jax_params, tokens):
    """The aux term alone: the loss with moe_aux_weight = 0 and 1, whose
    difference is the mean of the blocks' aux losses, against JAX's."""
    out = {}
    for w in (0.0, 1.0):
        jc, tc = _cfgs("f32", moe_aux_weight=w)
        jl = jg.loss_fn(jax_params, {"tokens": jnp.asarray(tokens)}, jc)
        tl = tg.loss_fn(_port(jax_params, tc),
                        {"tokens": torch.from_numpy(tokens)}, tc)
        out[w] = float(jl), tl.item()
    j_aux, t_aux = (out[1.0][i] - out[0.0][i] for i in (0, 1))
    assert t_aux == pytest.approx(j_aux, rel=1e-4)
    assert 0.9 < t_aux < 2.0   # n * sum(frac * importance): ~1 when balanced


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_adamw_steps_match_optax(jax_params, tokens, dtype):
    """3 MoE steps of make_train_step with torch.optim.AdamW against the
    JAX make_train_step with optax.adamw(1e-3), optax's defaults spelled
    out for torch (weight_decay 1e-4, eps 1e-8)."""
    jc, tc = _cfgs(dtype)
    opt = optax.adamw(LR)
    jstep = jax.jit(jg.make_train_step(jc, opt))
    batch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    jp, state, jlosses = jax_params, opt.init(jax_params), []
    for _ in range(STEPS):
        jp, state, m = jstep(jp, state, batch)
        jlosses.append(float(m["loss"]))

    params = _port(jax_params, tc, grad=True)
    topt = torch.optim.AdamW(tg.param_leaves(params), lr=LR,
                             betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    step = tg.make_train_step(tc, topt)
    tbatch = {"tokens": torch.from_numpy(tokens)}
    losses = [step(params, tbatch)["loss"].item() for _ in range(STEPS)]
    assert losses == pytest.approx(jlosses, rel=LOSS_TOL[dtype])
    assert losses[-1] < losses[0]
    for (name, leaf), ref in zip(tg.named_leaves(params),
                                 jax.tree.leaves(jp)):
        np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(ref),
                                   rtol=0, atol=PARAM_ATOL[dtype],
                                   err_msg=name)
