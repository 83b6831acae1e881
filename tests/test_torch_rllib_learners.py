"""ray_tpu_torch.rllib's learners against ray_tpu.rllib's.

The same numpy inputs from a seed go through the JAX function on the CPU
and the port's CPU path; JAX's parameters cross through
``params_from_numpy``.  PPO's and IMPALA's update factories are
module-level in JAX; DQN's, SAC's and BC's updates are closures that
``build_learner`` makes, reached here by calling it on a stand-in object
(``types.SimpleNamespace``) whose ``env_creator`` returns an env stub with
gymnasium's spaces.  Randomness crosses as values: PPO's minibatch
permutation and SAC's two normal draws are JAX's, drawn from the key its
update takes and passed to the port.

Tolerances (f32 on both sides, the same arithmetic in another order):
losses and metrics 1e-5 relative (measured ~1e-6).  An Adam step moves
an element by ~lr whatever its gradient's size, so where a gradient
element lies at the rounding floor the two sides' steps for it differ by
up to 2 lr (measured: one element of SAC's actor 1.4e-5 apart after one
step of lr 3e-4).  So each updated leaf is held by its distance from
JAX's against the distance JAX moved it, ||p - p_jax|| <= 1e-3 ||p_jax -
p_0|| (measured <= 1.9e-4), and no element lies more than 2 lr a step
from JAX's.
"""

import types

import gymnasium
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rllib import bc as jbc
from ray_tpu.rllib import dqn as jdqn
from ray_tpu.rllib import impala as jimp
from ray_tpu.rllib import models as jmodels
from ray_tpu.rllib import ppo as jppo
from ray_tpu.rllib import sac as jsac
from ray_tpu.rllib.sample_batch import (ACTIONS, ADVANTAGES, DONES, LOGPS,
                                        NEXT_OBS, OBS, REWARDS, TARGETS,
                                        VALUES)
from ray_tpu_torch.rllib import bc as tbc
from ray_tpu_torch.rllib import dqn as tdqn
from ray_tpu_torch.rllib import impala as timp
from ray_tpu_torch.rllib import optim as topt
from ray_tpu_torch.rllib import ppo as tppo
from ray_tpu_torch.rllib import sac as tsac
from ray_tpu_torch.rllib.models import (init_mlp_policy, mlp_forward,
                                        params_from_numpy)

# metrics and losses after the same parameters' forward: f32 reordering
METRIC_RTOL, METRIC_ATOL = 1e-5, 1e-6
# leaves after the update(s), per leaf: ||p - p_jax|| / ||p_jax - p_0||
# (the distance between the two against the distance JAX moved), and no
# element further from JAX's than 2 lr a step (see the module docstring)
MOVE_RTOL = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return jax.tree.map(lambda x: torch.tensor(np.asarray(x)), tree)


def _port(tree):
    return params_from_numpy(_np(tree), device="cpu")


def _jax_layout(t):
    t = t.detach()
    return (t.permute(2, 3, 1, 0) if t.ndim == 4 else t).numpy()


def _hold_tree(port, ref, rtol, atol, path=""):
    """Every leaf of the port's tree against JAX's (conv weights back to
    HWIO)."""
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref), path
        for k in ref:
            _hold_tree(port[k], ref[k], rtol, atol, f"{path}/{k}")
        return
    np.testing.assert_allclose(_jax_layout(port), np.asarray(ref),
                               rtol=rtol, atol=atol, err_msg=path)


def _hold_moved(port, ref, before, lr, steps, path=""):
    """The port's leaves after ``steps`` optimizer steps against JAX's,
    both from ``before`` (JAX's layout)."""
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref), path
        for k in ref:
            _hold_moved(port[k], ref[k], before[k], lr, steps, f"{path}/{k}")
        return
    got, ref, before = (_jax_layout(port), np.asarray(ref),
                        np.asarray(before))
    moved = np.linalg.norm(ref - before)
    apart = np.linalg.norm(got - ref)
    assert apart <= MOVE_RTOL * moved, (path, apart, moved)
    assert np.abs(got - ref).max() <= 2 * lr * steps, path


def _hold_metrics(port, ref):
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(port[k].detach().numpy(),
                                   np.asarray(ref[k]), rtol=METRIC_RTOL,
                                   atol=METRIC_ATOL, err_msg=k)


def _stand_in(cfg, obs_space, act_space):
    """What ``build_learner`` reads of an Algorithm: ``algo_config`` with
    an ``env_creator``."""
    env = types.SimpleNamespace(observation_space=obs_space,
                                action_space=act_space, close=lambda: None)
    cfg.env_creator = lambda: env
    return types.SimpleNamespace(algo_config=cfg)


# ---------------------------------------------------------------------------
# GAE and V-trace
# ---------------------------------------------------------------------------

def test_compute_gae_matches_jax_with_a_done_mid_rollout():
    rng = np.random.default_rng(0)
    T, B = 16, 3
    rewards = rng.standard_normal((T, B)).astype(np.float32)
    values = rng.standard_normal((T, B)).astype(np.float32)
    dones = np.zeros((T, B), np.float32)
    dones[5, 0] = dones[11, 2] = 1.0
    last = rng.standard_normal(B).astype(np.float32)
    adv, targets = tppo.compute_gae(rewards, values, dones, last, 0.99, 0.95)
    jadv, jtargets = jppo.compute_gae(rewards, values, dones, last, 0.99,
                                      0.95)
    np.testing.assert_array_equal(adv, jadv)
    np.testing.assert_array_equal(targets, jtargets)
    # the done at t = 5 cuts env 0's advantage from what follows it
    d5 = rewards[5, 0] - values[5, 0]
    assert np.isclose(adv[5, 0], d5)


def _vtrace_inputs(off_policy):
    rng = np.random.default_rng(1)
    T, B = 12, 4
    target = np.log(rng.uniform(0.1, 0.9, (T, B))).astype(np.float32)
    behavior = (target + rng.normal(0, 0.5, (T, B)).astype(np.float32)
                if off_policy else target)
    dones = (rng.random((T, B)) < 0.1).astype(np.float32)
    return (target, behavior.astype(np.float32),
            rng.standard_normal((T, B)).astype(np.float32), dones,
            rng.standard_normal((T, B)).astype(np.float32),
            rng.standard_normal(B).astype(np.float32))


@pytest.mark.parametrize("off_policy", [False, True],
                         ids=["on_policy", "off_policy"])
def test_vtrace_matches_jax(off_policy):
    """rho clipped at 1.0 and c at 0.9: off-policy, ratios fall on both
    sides of each bar."""
    inputs = _vtrace_inputs(off_policy)
    args = (0.99, 1.0, 0.9)
    jvs, jadv = jimp.make_vtrace_fn()(*map(jnp.asarray, inputs), *args)
    vs, adv = timp.make_vtrace_fn()(*map(torch.tensor, inputs), *args)
    np.testing.assert_allclose(vs.numpy(), jvs, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(adv.numpy(), jadv, rtol=1e-5, atol=1e-5)
    target, behavior, rewards, dones, values, bootstrap = inputs
    rho = np.exp(target - behavior)
    if off_policy:
        assert (rho > 1.0).any() and (rho < 0.9).any()
        return
    # on-policy with c_bar < 1: vs_t = V_t + delta_t + g_t * 0.9 * (vs_{t+1}
    # - V_{t+1}), the recurrence written out by hand
    ref = np.zeros_like(values)
    nxt_vs, nxt_v = bootstrap, bootstrap
    for t in range(values.shape[0] - 1, -1, -1):
        g = 0.99 * (1.0 - dones[t])
        ref[t] = (values[t] + rewards[t] + g * nxt_v - values[t]
                  + g * 0.9 * (nxt_vs - nxt_v))
        nxt_vs, nxt_v = ref[t], values[t]
    np.testing.assert_allclose(vs.numpy(), ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _opt_case(seed, scale):
    rng = np.random.default_rng(seed)
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    grads = [jax.tree.map(
        lambda p: (rng.standard_normal(p.shape) * scale).astype(np.float32),
        params) for _ in range(3)]
    return params, grads


def _optax_steps(opt, params, grads):
    p = jax.tree.map(jnp.asarray, params)
    out, state = [], opt.init(p)
    for g in grads:
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state, p)
        p = optax.apply_updates(p, upd)
        out.append(_np(p))
    return out


def _torch_steps(make, params, grads):
    tp = params_from_numpy(params, device="cpu")
    opt, out = make(tp), []
    for g in grads:
        topt.apply_gradients(opt, tp, _t(g))
        out.append(topt.tree_map(lambda x: x.detach().clone(), tp))
    return out


def test_rmsprop_matches_optax_where_eps_decides():
    """optax.rmsprop(lr, decay=0.99, eps=0.1) for 3 steps; gradients of
    ~0.3 make nu ~1e-3, so eps = 0.1 sets the step: torch.optim.RMSprop
    (eps outside the root) moves ~3x as far."""
    params, grads = _opt_case(2, 0.3)
    ref = _optax_steps(optax.rmsprop(1e-2, decay=0.99, eps=0.1), params,
                       grads)
    got = _torch_steps(
        lambda tp: topt.RMSprop(topt.tree_leaves(tp), 1e-2, decay=0.99,
                                eps=0.1), params, grads)
    for r, g in zip(ref, got):
        _hold_tree(g, r, 1e-6, 1e-7)
    torch_rms = _torch_steps(
        lambda tp: torch.optim.RMSprop(topt.tree_leaves(tp), lr=1e-2,
                                       alpha=0.99, eps=0.1), params, grads)
    moved = np.abs(torch_rms[0]["a"].numpy() - params["a"])
    moved_optax = np.abs(ref[0]["a"] - params["a"])
    assert np.median(moved / moved_optax) > 2.0


@pytest.mark.parametrize("scale", [1.0, 1e-8], ids=["unit", "near_eps"])
def test_adam_matches_optax(scale):
    """optax.adam(lr) for 3 steps, at unit gradients and at gradients of
    eps's size (eps outside the root of the bias-corrected nu)."""
    params, grads = _opt_case(3, scale)
    ref = _optax_steps(optax.adam(1e-3), params, grads)
    got = _torch_steps(lambda tp: topt.adam(tp, 1e-3), params, grads)
    for r, g in zip(ref, got):
        _hold_tree(g, r, 1e-6, 1e-7)


@pytest.mark.parametrize("norm,clip", [(5.0, 0.5), (0.1, 0.5),
                                       (2e-6, 1e-6)],
                         ids=["clipped", "unclipped", "tiny"])
def test_clip_by_global_norm_matches_jax(norm, clip):
    """JAX's clip (ppo.py:103-107): scale = min(1, clip / (||g|| + 1e-8));
    at ||g|| = 2e-6 its 1e-8 and clip_grad_norm_'s 1e-6 part."""
    params, grads = _opt_case(4, 1.0)
    g = grads[0]
    total = np.sqrt(sum(np.sum(x.astype(np.float64) ** 2)
                        for x in jax.tree.leaves(g)))
    g = jax.tree.map(lambda x: (x * (norm / total)).astype(np.float32), g)
    gnorm = jnp.sqrt(sum(jnp.sum(jnp.square(x)) for x in jax.tree.leaves(g)))
    scale = jnp.minimum(1.0, clip / (gnorm + 1e-8))
    ref = jax.tree.map(lambda x: x * scale, g)
    got = topt.clip_by_global_norm(_t(g), clip)
    _hold_tree(got, _np(ref), 1e-6, 0)
    if norm == 2e-6:
        leaves = [x.clone() for x in topt.tree_leaves(_t(g))]
        torch.nn.utils.clip_grad_norm_(leaves, clip)
        assert abs(float(leaves[0][0, 0] / got["a"][0, 0]) - 1) > 0.2


# ---------------------------------------------------------------------------
# PPO
# ---------------------------------------------------------------------------

def _ppo_batch(rng, params, n):
    obs = rng.standard_normal((n, 4)).astype(np.float32)
    acts = rng.integers(0, 3, n).astype(np.int32)
    logits, _ = jmodels.mlp_forward(params, obs)
    logp = np.asarray(jax.nn.log_softmax(logits))[np.arange(n), acts]
    values = rng.standard_normal(n).astype(np.float32)
    adv = rng.standard_normal(n).astype(np.float32)
    return {OBS: obs, ACTIONS: acts,
            LOGPS: (logp + rng.normal(0, 0.1, n)).astype(np.float32),
            VALUES: values, ADVANTAGES: adv,
            TARGETS: (values + adv).astype(np.float32)}


def _jax_minibatch_idx(rng, n, cfg):
    """The rows JAX's update takes (ppo.py:116-125), from its key."""
    num_mb = max(n // cfg.minibatch_size, 1)
    mb = n // num_mb
    keys = jax.random.split(rng, cfg.num_epochs)
    idx = jnp.concatenate([jax.random.permutation(k, n)[:num_mb * mb]
                           for k in keys])
    return np.asarray(idx.reshape(cfg.num_epochs * num_mb, mb))


@pytest.mark.parametrize("updates", [1, 3])
def test_ppo_update_matches_jax(updates):
    """2 epochs of minibatch 32 over 100 rows: 3 minibatches of 33 rows an
    epoch (the 100th row cut), grad clip 0.5, Adam; JAX's permutation
    passed in.  The clip binds: without it the port lands elsewhere."""
    cfg = jppo.PPOConfig()
    cfg.minibatch_size, cfg.num_epochs = 32, 2
    tcfg = tppo.PPOConfig()
    tcfg.minibatch_size, tcfg.num_epochs = 32, 2
    jp = jmodels.init_mlp_policy(jax.random.PRNGKey(0), 4, 3, (16, 16))
    jopt = optax.adam(cfg.lr)
    jstate, jupdate = jopt.init(jp), jppo._make_update_fn(cfg, jopt)
    tp = _port(jp)
    tupdate = tppo._make_update_fn(tcfg, topt.adam(tp, tcfg.lr))
    unclipped = tppo.PPOConfig()
    unclipped.minibatch_size, unclipped.num_epochs = 32, 2
    unclipped.grad_clip = 0.0
    free = _port(jp)
    free_update = tppo._make_update_fn(unclipped, topt.adam(free, cfg.lr))
    rng, before = np.random.default_rng(5), _np(jp)
    for u in range(updates):
        batch = _ppo_batch(rng, jp, 100)
        key = jax.random.PRNGKey(100 + u)
        idx = _jax_minibatch_idx(key, 100, cfg)
        assert idx.shape == (6, 33)
        jp, jstate, jm = jupdate(jp, jstate, batch, key)
        tm = tupdate(tp, _t(batch), idx=torch.tensor(idx))
        _hold_metrics(tm, jm)
        free_update(free, _t(batch), idx=torch.tensor(idx))
    _hold_moved(tp, _np(jp), before, cfg.lr, 6 * updates)
    with pytest.raises(AssertionError):
        _hold_moved(free, _np(jp), before, cfg.lr, 6 * updates)


def test_ppo_minibatch_indices():
    cfg = tppo.PPOConfig()
    cfg.minibatch_size, cfg.num_epochs = 32, 3
    idx = tppo.minibatch_indices(100, cfg, torch.Generator().manual_seed(0))
    assert idx.shape == (9, 33)
    for e in range(3):
        rows = idx[3 * e:3 * e + 3].flatten()
        assert len(set(rows.tolist())) == 99 and rows.max() < 100
    cfg.minibatch_size = 512  # fewer rows than a minibatch: one of all
    assert tppo.minibatch_indices(100, cfg,
                                  torch.Generator()).shape == (3, 100)


# ---------------------------------------------------------------------------
# IMPALA
# ---------------------------------------------------------------------------

IMPALA_T, IMPALA_B, IMPALA_A = 8, 3, 6
IMPALA_OBS = {False: (4,), True: (84, 84, 4)}


def _impala_batch(rng, cnn):
    T, B, shape = IMPALA_T, IMPALA_B, IMPALA_OBS[cnn]
    obs = (rng.integers(0, 256, (T, B) + shape).astype(np.uint8) if cnn
           else rng.standard_normal((T, B) + shape).astype(np.float32))
    return {OBS: obs,
            ACTIONS: rng.integers(0, IMPALA_A, (T, B)).astype(np.int32),
            LOGPS: np.log(rng.uniform(0.05, 0.4, (T, B))).astype(np.float32),
            REWARDS: rng.standard_normal((T, B)).astype(np.float32),
            DONES: (rng.random((T, B)) < 0.1).astype(np.float32),
            "bootstrap": rng.standard_normal(B).astype(np.float32)}


@pytest.mark.parametrize("updates", [1, 3])
@pytest.mark.parametrize("cnn", [False, True], ids=["mlp", "cnn"])
def test_impala_update_matches_jax(cnn, updates):
    """The V-trace update with optax's RMSprop (eps 0.1) on time-major
    (8, 3) rollouts: the MLP on float observations, the Nature-CNN at its
    widths on 84x84x4 uint8 frames; the gradients of the first update
    (``_make_grad_apply``'s half before the all-reduce) as well."""
    cfg, tcfg = jimp.ImpalaConfig(), timp.ImpalaConfig()
    cfg.cnn = tcfg.cnn = cnn
    jp, jopt, jstate = jimp._init_params_and_opt(cfg, IMPALA_OBS[cnn],
                                                 IMPALA_A)
    jgrad, _ = jimp._make_grad_apply(cfg, jopt)
    jupdate = jimp._make_update_fn(cfg, jopt)
    tp = _port(jp)
    tgrad, _ = timp._make_grad_apply(tcfg, timp.make_optimizer(tcfg, tp))
    tupdate = timp._make_update_fn(tcfg, timp.make_optimizer(tcfg, tp))
    rng, before = np.random.default_rng(6), _np(jp)
    for u in range(updates):
        batch = _impala_batch(rng, cnn)
        if u == 0:
            jg, _ = jgrad(jp, batch)
            tg, _ = tgrad(tp, _t(batch))
            scale = max(float(np.abs(x).max()) for x in jax.tree.leaves(jg))
            _hold_tree(tg, _np(jg), 1e-4, 1e-5 * scale)
        jp, jstate, jm = jupdate(jp, jstate, batch)
        _hold_metrics(tupdate(tp, _t(batch)), jm)
    _hold_moved(tp, _np(jp), before, cfg.lr, updates)


def test_impala_init_and_optimizer():
    """``_init_params_and_opt`` builds the policy the config names on the
    device asked for, with optax's RMSprop."""
    cfg = timp.ImpalaConfig()
    cfg.cnn = True
    params, opt = timp._init_params_and_opt(cfg, (84, 84, 4), 6,
                                            device="cpu")
    assert params["conv_0"]["w"].shape == (32, 4, 8, 8)
    assert isinstance(opt, topt.RMSprop)
    assert opt.defaults == {"lr": cfg.lr, "decay": 0.99, "eps": 0.1}
    assert len(opt.param_groups[0]["params"]) == 12
    # build() reaches Algorithm.setup, which wants an environment, as JAX's
    with pytest.raises(AssertionError, match="environment"):
        cfg.build()


# ---------------------------------------------------------------------------
# DQN, SAC, BC: JAX's closures through a stand-in
# ---------------------------------------------------------------------------

def _dqn_batch(rng, n=32):
    return {OBS: rng.standard_normal((n, 4)).astype(np.float32),
            ACTIONS: rng.integers(0, 3, n).astype(np.int32),
            REWARDS: rng.standard_normal(n).astype(np.float32),
            NEXT_OBS: rng.standard_normal((n, 4)).astype(np.float32),
            DONES: (rng.random(n) < 0.2).astype(np.float32),
            "weights": rng.uniform(0.2, 1.0, n).astype(np.float32)}


@pytest.mark.parametrize("updates", [1, 3])
@pytest.mark.parametrize("double_q", [True, False],
                         ids=["double_q", "max_q"])
def test_dqn_update_matches_jax(double_q, updates):
    cfg = jdqn.DQNConfig()
    cfg.double_q = double_q
    algo = _stand_in(cfg, gymnasium.spaces.Box(-1, 1, (4,)),
                     gymnasium.spaces.Discrete(3))
    jdqn.DQN.build_learner(algo)
    # the target net apart from the online one, as after a few syncs
    target = jax.tree.map(lambda x: x * 0.9, algo.params)
    tcfg = tdqn.DQNConfig()
    tcfg.double_q = double_q
    tp, tt = _port(algo.params), _port(target)
    opt = topt.adam(tp, tcfg.lr)
    jp, jstate, before = algo.params, algo.opt_state, _np(algo.params)
    rng = np.random.default_rng(7)
    for _ in range(updates):
        batch = _dqn_batch(rng)
        jp, jstate, jloss, jtd = algo._update(jp, target, jstate, batch)
        loss, td = tdqn.dqn_update(tcfg, tp, tt, opt, _t(batch))
        _hold_metrics({"loss": loss, "td": td}, {"loss": jloss, "td": jtd})
    _hold_moved(tp, _np(jp), before, cfg.lr, updates)


def test_dqn_double_q_takes_the_online_argmax():
    """On a batch where the online and target nets pick other next
    actions, the two targets differ (the case the double-Q test needs)."""
    cfg = tdqn.DQNConfig()
    gen = torch.Generator().manual_seed(8)
    tp = init_mlp_policy(gen, 4, 3, device="cpu")
    tt = init_mlp_policy(gen, 4, 3, device="cpu")
    batch = _t(_dqn_batch(np.random.default_rng(9)))
    nxt = batch[NEXT_OBS]
    assert (mlp_forward(tp, nxt)[0].argmax(-1)
            != mlp_forward(tt, nxt)[0].argmax(-1)).any()
    losses = []
    for double_q in (True, False):
        cfg.double_q = double_q
        p = topt.tree_map(lambda x: x.detach().clone().requires_grad_(), tp)
        losses.append(float(tdqn.dqn_update(
            cfg, p, tt, torch.optim.SGD(topt.tree_leaves(p), lr=0.0),
            batch)[0]))
    assert losses[0] != losses[1]


def _sac_stand_in():
    cfg = jsac.SACConfig()
    algo = _stand_in(cfg, gymnasium.spaces.Box(-np.inf, np.inf, (5,)),
                     gymnasium.spaces.Box(np.array([-1.0, -2.0], np.float32),
                                          np.array([1.0, 3.0], np.float32)))
    jsac.SAC.build_learner(algo)
    return algo


def _sac_batch(rng, n=32):
    return {OBS: rng.standard_normal((n, 5)).astype(np.float32),
            ACTIONS: np.stack([rng.uniform(-1, 1, n), rng.uniform(-2, 3, n)],
                              -1).astype(np.float32),
            REWARDS: rng.standard_normal(n).astype(np.float32),
            NEXT_OBS: rng.standard_normal((n, 5)).astype(np.float32),
            DONES: (rng.random(n) < 0.2).astype(np.float32)}


@pytest.mark.parametrize("updates", [1, 3])
def test_sac_update_matches_jax(updates):
    """Twin critics, the reparameterized actor, the temperature and the
    polyak targets, at SAC's widths (256, 256) with a 2-d action range of
    [-1, 1] x [-2, 3]; JAX's two normal draws passed in."""
    algo = _sac_stand_in()
    tcfg = tsac.SACConfig()
    tp, tt = _port(algo.params), _port(algo.target_params)
    log_alpha = torch.zeros((), requires_grad=True)
    opt = topt.adam(tp, tcfg.lr)
    alpha_opt = topt.adam(log_alpha, tcfg.alpha_lr)
    low, high = torch.tensor(algo._act_low), torch.tensor(algo._act_high)
    state = (algo.params, algo.target_params, algo.log_alpha,
             algo.opt_state, algo.alpha_opt_state)
    rng, before = np.random.default_rng(10), _np((state[0], state[2]))
    for u in range(updates):
        batch = _sac_batch(rng)
        key = jax.random.PRNGKey(200 + u)
        k1, k2 = jax.random.split(key)
        noise = (np.asarray(jax.random.normal(k1, (32, 2))),
                 np.asarray(jax.random.normal(k2, (32, 2))))
        *state, jm = algo._update(*state, batch, key)
        tm = tsac.sac_update(tcfg, tp, tt, log_alpha, opt, alpha_opt,
                             _t(batch), _t(noise), low, high)
        _hold_metrics(tm, jm)
    lr = algo.algo_config.lr
    _hold_moved(tp, _np(state[0]), before[0], lr, updates)
    # the polyak targets move tau = 0.005 of the way a step: held by
    # element, as the metrics (measured <= 3.6e-7 apart)
    _hold_tree(tt, _np(state[1]), METRIC_RTOL, METRIC_ATOL)
    _hold_moved(log_alpha, state[2], before[1], lr, updates)
    assert log_alpha.item() != 0.0


@pytest.mark.parametrize("updates", [1, 3])
def test_bc_update_matches_jax(updates):
    rng = np.random.default_rng(11)
    cfg = jbc.BCConfig()
    cfg.offline_data({OBS: rng.standard_normal((64, 4)).astype(np.float32),
                      ACTIONS: rng.integers(0, 3, 64)})
    algo = _stand_in(cfg, gymnasium.spaces.Box(-1, 1, (4,)),
                     gymnasium.spaces.Discrete(3))
    jbc.BC.build_learner(algo)
    tp = _port(algo.params)
    opt = topt.adam(tp, tbc.BCConfig().lr)
    jp, jstate, before = algo.params, algo.opt_state, _np(algo.params)
    for _ in range(updates):
        idx = rng.integers(0, 64, 32)
        obs, act = algo._obs[idx], algo._acts[idx]
        jp, jstate, jloss = algo._update(jp, jstate, obs, act)
        loss = tbc.bc_update(tp, opt, torch.tensor(obs), torch.tensor(act))
        _hold_metrics({"loss": loss}, {"loss": jloss})
    _hold_moved(tp, _np(jp), before, cfg.lr, updates)


@pytest.mark.parametrize("cfg", ["PPOConfig", "ImpalaConfig", "DQNConfig",
                                 "SACConfig", "BCConfig"])
def test_configs_match_jax_and_build_raises(cfg, monkeypatch):
    """Each config's fields and defaults are JAX's, and the port's one more,
    ``learner_device`` (the card by default); ``build()`` gives the
    algorithm JAX's ``build()`` gives, an ``Algorithm`` (its ``setup``, which
    starts the runners, is stubbed out on both sides here), and without
    an environment both raise in ``setup``."""
    import ray_tpu.rllib as jr
    import ray_tpu_torch.rllib as tr

    jc, tc = getattr(jr, cfg)(), getattr(tr, cfg)()
    ours = tc.to_dict()
    assert ours.pop("learner_device") == "cuda"
    assert ours == jc.to_dict()
    with pytest.raises(AssertionError, match="environment"):
        tc.build()
    monkeypatch.setattr(jr.Algorithm, "setup", lambda self, config: None)
    monkeypatch.setattr(tr.Algorithm, "setup", lambda self, config: None)
    jalgo, talgo = jc.build(), tc.build()
    assert type(talgo).__name__ == type(jalgo).__name__
    assert isinstance(talgo, tr.Algorithm)
    assert talgo._algo_config is tc


def test_sac_temperature_takes_logp_before_the_step():
    """With SGD on log_alpha (Adam's step hides the gradient's size), the
    step is -lr x d/d log_alpha of -mean(alpha (logp + target_entropy)),
    logp the actor's under the parameters before the update, on the
    actor's noise (the second draw)."""
    cfg = tsac.SACConfig()
    gen = torch.Generator().manual_seed(12)
    params = tsac.init_sac_nets(gen, 5, 2, hidden=(32, 32), device="cpu")
    target = topt.tree_map(lambda p: p.detach().clone(),
                           {"q1": params["q1"], "q2": params["q2"]})
    log_alpha = torch.tensor(0.3, requires_grad=True)
    batch = _t(_sac_batch(np.random.default_rng(13)))
    batch[ACTIONS] = batch[ACTIONS].clamp(-1, 1)
    noise = tsac.sac_noise(32, 2, torch.Generator().manual_seed(14))
    with torch.no_grad():
        _, logp = tsac.sample_squashed(params["actor"], batch[OBS],
                                       noise=noise[1])
    grad = -float(torch.exp(torch.tensor(0.3)) * (logp - 2.0).mean())
    m = tsac.sac_update(cfg, params, target, log_alpha,
                        topt.adam(params, cfg.lr),
                        torch.optim.SGD([log_alpha], lr=0.1), batch, noise,
                        -torch.ones(2), torch.ones(2))
    assert float(m["alpha"]) == pytest.approx(np.exp(0.3), rel=1e-6)
    assert log_alpha.item() == pytest.approx(0.3 - 0.1 * grad, rel=1e-5)
