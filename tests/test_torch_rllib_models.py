"""ray_tpu_torch.rllib's policy nets and samplers against ray_tpu.rllib's.

JAX's parameters cross as numpy arrays (``params_from_numpy``: conv
weights HWIO -> OIHW); observations come from numpy with a fixed seed.
The samplers are held on JAX's own noise, drawn from the key JAX's
function takes and passed to the port (each test first shows that JAX's
function computes what that noise gives), and the port's own draws by
distribution; never by key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib import dqn as jdqn
from ray_tpu.rllib import models as jm
from ray_tpu.rllib import sac as jsac
from ray_tpu_torch.rllib import dqn as tdqn
from ray_tpu_torch.rllib import models as tm
from ray_tpu_torch.rllib import sac as tsac

# f32 forwards: the same arithmetic in another order (measured <= 6e-7
# relative on these nets)
F32_RTOL, F32_ATOL = 1e-5, 1e-5
# chi-square critical value at p = 1e-3 for 5 degrees of freedom (6 actions)
CHI2_5_P001 = 20.515
# a small CNN whose last conv output is 2 x 3 (not 1 x 1: the flatten
# order matters) and whose input channels differ
CNN_OBS = (44, 52, 4)
CNN_KW = {"channels": (8, 16, 16), "dense": 32}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(a, b, rtol=F32_RTOL, atol=F32_ATOL):
    np.testing.assert_allclose(np.asarray(a.detach()), np.asarray(b),
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def mlp():
    jp = jm.init_mlp_policy(jax.random.PRNGKey(0), 6, 6, (32, 32))
    return jp, tm.params_from_numpy(_np(jp), device="cpu")


@pytest.fixture(scope="module")
def cnn():
    jp = jm.init_cnn_policy(jax.random.PRNGKey(1), CNN_OBS, 6, **CNN_KW)
    return jp, tm.params_from_numpy(_np(jp), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_mlp_forward_matches_jax(mlp, dtype):
    jp, tp = mlp
    rng = np.random.default_rng(0)
    obs = (rng.integers(0, 5, (16, 2, 3)) if dtype == "uint8"
           else rng.standard_normal((16, 2, 3))).astype(dtype)
    jl, jv = jm.mlp_forward(jp, jnp.asarray(obs))
    tl, tv = tm.mlp_forward(tp, _t(obs))
    _close(tl, jl)
    _close(tv, jv)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_cnn_forward_matches_jax(cnn, dtype):
    jp, tp = cnn
    rng = np.random.default_rng(1)
    obs = (rng.integers(0, 256, (5,) + CNN_OBS) if dtype == "uint8"
           else rng.random((5,) + CNN_OBS)).astype(dtype)
    jl, jv = jm.cnn_forward(jp, jnp.asarray(obs))
    tl, tv = tm.policy_forward(tp, _t(obs))
    _close(tl, jl)
    _close(tv, jv)
    # the input is one that tells the flatten orders apart: fc.w's rows
    # taken in NCHW order give another value, far outside the tolerance
    h, w, c = 2, 3, CNN_KW["channels"][-1]
    rows = np.arange(h * w * c).reshape(h, w, c).transpose(2, 0, 1).ravel()
    wrong = {**tp, "fc": {"w": tp["fc"]["w"][rows], "b": tp["fc"]["b"]}}
    _, wv = tm.cnn_forward(wrong, _t(obs))
    assert np.abs(wv.detach().numpy() - np.asarray(jv)).max() > 100 * F32_ATOL


def test_params_from_numpy_carries_hwio_to_oihw(cnn):
    jp, tp = cnn
    for i in range(3):
        jw = np.asarray(jp[f"conv_{i}"]["w"])
        assert tp[f"conv_{i}"]["w"].shape == jw.shape[::-1][:2] + jw.shape[:2]
        np.testing.assert_array_equal(
            tp[f"conv_{i}"]["w"].detach().permute(2, 3, 1, 0).numpy(), jw)
    assert all(x.requires_grad and x.dtype == torch.float32
               for x in (tp["fc"]["w"], tp["pi"]["b"]))


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


@pytest.mark.parametrize("net", ["mlp", "cnn", "sac"])
def test_init_matches_jax_shapes_and_scales(net):
    """The port draws its own values from a generator, with JAX's
    structure, shapes and per-leaf scales (std within 15% where a leaf has
    >= 256 elements; biases zero)."""
    key, gen = jax.random.PRNGKey(2), torch.Generator().manual_seed(2)
    if net == "mlp":
        jp = jm.init_mlp_policy(key, 8, 3, (64, 64))
        tp = tm.init_mlp_policy(gen, 8, 3, (64, 64), device="cpu")
    elif net == "cnn":
        jp = jm.init_cnn_policy(key, (84, 84, 4), 6)
        tp = tm.init_cnn_policy(gen, (84, 84, 4), 6, device="cpu")
    else:
        jp = jsac.init_sac_nets(key, 17, 6)
        tp = tsac.init_sac_nets(gen, 17, 6, device="cpu")
    carried = tm.params_from_numpy(_np(jp), device="cpu")
    assert _shapes(tp) == _shapes(carried)

    def walk(a, b):
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k])
                continue
            x, y = a[k].detach(), b[k].detach()
            assert a[k].requires_grad
            if k == "b":
                assert not x.any()
            elif x.numel() >= 256:
                assert abs(x.std() / y.std() - 1) < 0.15, k

    walk(tp, carried)


def test_sample_action_on_jax_noise(mlp):
    jp, tp = mlp
    obs = np.random.default_rng(3).standard_normal((64, 6)).astype(
        np.float32)
    key = jax.random.PRNGKey(4)
    ja, jlp, jv = jm.sample_action(jp, jnp.asarray(obs), key)
    g = np.asarray(jax.random.gumbel(key, (64, 6)))
    logits, _ = jm.mlp_forward(jp, jnp.asarray(obs))
    np.testing.assert_array_equal(np.argmax(np.asarray(logits) + g, -1), ja)
    ta, tlp, tv = tm.sample_action(tp, _t(obs), noise=_t(g))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    _close(tlp, jlp)
    _close(tv, jv)


def test_sample_action_draws_follow_the_softmax(mlp):
    """The port's own Gumbel draws: frequencies of 6 actions over 60,000
    draws of one observation within the chi-square bound (p = 1e-3)."""
    _, tp = mlp
    with torch.no_grad():
        tp = {**tp, "pi": {"w": tp["pi"]["w"],
                           "b": torch.linspace(-1.0, 1.5, 6)}}
    obs = torch.ones(60_000, 6)
    a, logp, _ = tm.sample_action(tp, obs, torch.Generator().manual_seed(5))
    probs = torch.softmax(tm.mlp_forward(tp, obs[:1])[0][0], -1).detach()
    counts = torch.bincount(a, minlength=6).double()
    expected = 60_000 * probs.double()
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < CHI2_5_P001, (chi2, counts, expected)
    torch.testing.assert_close(logp, torch.log(probs)[a])


def test_dqn_action_fn_on_jax_noise(mlp):
    jp, tp = mlp
    obs = np.random.default_rng(6).standard_normal((64, 6)).astype(
        np.float32)
    key = jax.random.PRNGKey(7)
    ja, jz, _ = jdqn.dqn_action_fn({"params": jp, "epsilon": 0.5},
                                   jnp.asarray(obs), key)
    k1, k2 = jax.random.split(key)
    rand = np.asarray(jax.random.randint(k1, (64,), 0, 6))
    u = np.asarray(jax.random.uniform(k2, (64,)))
    greedy = np.argmax(np.asarray(jm.mlp_forward(jp, jnp.asarray(obs))[0]),
                       -1)
    np.testing.assert_array_equal(np.where(u < 0.5, rand, greedy), ja)
    assert 0 < (u < 0.5).sum() < 64 and (rand != greedy).any()
    ta, tz, tz2 = tdqn.dqn_action_fn({"params": tp, "epsilon": 0.5},
                                     _t(obs), noise=(_t(rand), _t(u)))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert not tz.any() and not tz2.any() and tz.dtype == torch.float32


def test_dqn_action_fn_draws():
    """The port's own draws: epsilon 0 is greedy, epsilon 1 uniform over
    the actions (chi-square, 6 actions, 60,000 draws)."""
    tp = tm.init_mlp_policy(torch.Generator().manual_seed(8), 6, 6,
                            device="cpu")
    obs = torch.randn(60_000, 6, generator=torch.Generator().manual_seed(9))
    gen = torch.Generator().manual_seed(10)
    greedy = torch.argmax(tm.mlp_forward(tp, obs)[0], -1)
    a0, _, _ = tdqn.dqn_action_fn({"params": tp, "epsilon": 0.0}, obs, gen)
    assert torch.equal(a0, greedy)
    a1, _, _ = tdqn.dqn_action_fn({"params": tp, "epsilon": 1.0}, obs, gen)
    counts = torch.bincount(a1, minlength=6).double()
    chi2 = float(((counts - 10_000) ** 2 / 10_000).sum())
    assert chi2 < CHI2_5_P001


@pytest.fixture(scope="module")
def sac_nets():
    jp = jsac.init_sac_nets(jax.random.PRNGKey(11), 17, 6)
    # the head's outputs spread wider than at init (|mean| up to 3.6,
    # log_std from -3.8 to the clip at 2), so the clip and the squash act
    jp["actor"]["out"]["w"] = jp["actor"]["out"]["w"] * 10.0
    return jp, tm.params_from_numpy(_np(jp), device="cpu")


def test_sample_squashed_on_jax_noise(sac_nets):
    jp, tp = sac_nets
    obs = np.random.default_rng(12).standard_normal((64, 17)).astype(
        np.float32)
    key = jax.random.PRNGKey(13)
    ja, jlp = jsac.sample_squashed(jp["actor"], jnp.asarray(obs), key)
    eps = np.asarray(jax.random.normal(key, (64, 6)))
    ta, tlp = tsac.sample_squashed(tp["actor"], _t(obs), noise=_t(eps))
    _close(ta, ja)
    _close(tlp, jlp, rtol=1e-5, atol=1e-4)
    low = np.array([-1, -2, -1, -0.5, -1, -3], np.float32)
    high = np.array([1, 2, 0.5, 0.5, 3, 3], np.float32)
    weights = {"params": jp, "act_low": low, "act_high": high}
    jact, jlp2, _ = jsac.sac_action_fn(weights, jnp.asarray(obs), key)
    tact, tlp2, tz = tsac.sac_action_fn({**weights, "params": tp}, _t(obs),
                                        noise=_t(eps))
    _close(tact, jact)
    _close(tlp2, jlp2, rtol=1e-5, atol=1e-4)
    assert not tz.any()


def test_sample_squashed_draws(sac_nets):
    """The port's own draws: actions in [-1, 1], logp the tanh-Gaussian
    density of the action recomputed in f64 from the draw, by another
    formula (log sech^2 z, not the port's softplus form)."""
    _, tp = sac_nets
    obs = torch.randn(4096, 17, generator=torch.Generator().manual_seed(14))
    noise = torch.randn(4096, 6, generator=torch.Generator().manual_seed(15))
    a, logp = tsac.sample_squashed(tp["actor"], obs, noise=noise)
    a2, logp2 = tsac.sample_squashed(
        tp["actor"], obs, torch.Generator().manual_seed(15))
    assert torch.equal(a, a2) and torch.equal(logp, logp2)
    assert a.abs().max() <= 1.0
    mean, log_std = (x.detach().double()
                     for x in tsac.actor_dist(tp["actor"], obs))
    z = mean + torch.exp(log_std) * noise.double()
    ref = (-0.5 * noise.double() ** 2 - log_std - 0.5 * np.log(2 * np.pi)
           + 2 * torch.log(torch.cosh(z))).sum(-1)  # 1 - tanh^2 = sech^2
    assert z.abs().max() > 10  # where 1 - tanh(z)^2 itself rounds to 0
    # f32 logp recomputes the draw as (z - mean) / std, which cancels: <=
    # ulp(3.6) / e^-3.8 = 2.2e-5 on a draw of |eps| <= 4, 2e-4 on its square
    # (reckoned); held with room for the 6 dims
    torch.testing.assert_close(logp.detach().double(), ref, rtol=1e-5,
                               atol=5e-4)

