"""ray_tpu_torch.models.mnist against ray_tpu.models.mnist.

JAX's parameters cross as numpy arrays (``params_from_numpy``: conv
kernels HWIO -> OIHW); the batch is JAX's ``synthetic_batch``.  The
forward, loss, accuracy, every leaf's gradient and 3 Adam steps (lr 1e-3,
as the Train layer's MNIST loop takes them) are held against JAX's.
Tolerances: f32 on both sides in another order, 1e-5 relative on the
logits, loss and gradients (measured ~1e-6); after the Adam steps each
leaf's distance from JAX's is held against the distance JAX moved it, as
``tests/test_torch_rllib_learners.py`` holds the learners.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import mnist as jmn
from ray_tpu_torch.models import mnist as tmn
from ray_tpu_torch.rllib import optim as topt

RTOL, ATOL = 1e-5, 1e-6
MOVE_RTOL = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_layout(t):
    t = t.detach()
    return (t.permute(2, 3, 1, 0) if t.ndim == 4 else t).numpy()


@pytest.fixture(scope="module")
def setup():
    jp = jmn.init_params(jax.random.PRNGKey(0))
    batch = _np(jmn.synthetic_batch(jax.random.PRNGKey(1), batch_size=32))
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    return jp, batch, tbatch


def test_forward_loss_and_accuracy_match_jax(setup):
    jp, batch, tbatch = setup
    tp = tmn.params_from_numpy(_np(jp), device="cpu")
    np.testing.assert_allclose(
        tmn.forward(tp, tbatch["image"]).detach().numpy(),
        jmn.forward(jp, batch["image"]), rtol=RTOL, atol=ATOL)
    jloss, jacc = jmn.loss_fn(jp, batch)
    loss, acc = tmn.loss_fn(tp, tbatch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    assert float(acc) == float(jacc)


def test_flatten_order_is_jax_nhwc(setup):
    """fc1's rows are JAX's (NHWC) order: the same kernel read in NCHW
    order gives logits far from JAX's on this batch."""
    jp, batch, tbatch = setup
    tp = tmn.params_from_numpy(_np(jp), device="cpu")
    rows = np.arange(7 * 7 * 64).reshape(7, 7, 64).transpose(2, 0, 1).ravel()
    wrong = {**tp, "fc1": {"kernel": tp["fc1"]["kernel"][rows],
                           "bias": tp["fc1"]["bias"]}}
    err = np.abs(tmn.forward(wrong, tbatch["image"]).detach().numpy()
                 - np.asarray(jmn.forward(jp, batch["image"]))).max()
    assert err > 1e3 * ATOL


def test_gradients_match_jax(setup):
    jp, batch, tbatch = setup
    tp = tmn.params_from_numpy(_np(jp), device="cpu")
    jg = jax.grad(lambda p: jmn.loss_fn(p, batch)[0])(jp)
    loss, _ = tmn.loss_fn(tp, tbatch)
    tg = topt.grads_of(loss, tp)
    for name in jg:
        for leaf in jg[name]:
            ref = np.asarray(jg[name][leaf])
            np.testing.assert_allclose(
                _jax_layout(tg[name][leaf]), ref, rtol=1e-4,
                atol=1e-5 * np.abs(ref).max(), err_msg=f"{name}/{leaf}")


def test_three_adam_steps_match_jax(setup):
    jp, batch, tbatch = setup
    before = _np(jp)
    tp = tmn.params_from_numpy(before, device="cpu")
    opt = optax.adam(1e-3)
    state = opt.init(jp)

    @jax.jit
    def jstep(p, s):
        (loss, acc), g = jax.value_and_grad(jmn.loss_fn, has_aux=True)(
            p, batch)
        upd, s = opt.update(g, s, p)
        return optax.apply_updates(p, upd), s, loss

    topt_adam = topt.adam(tp, 1e-3)
    losses = []
    for _ in range(3):
        jp, state, jloss = jstep(jp, state)
        loss, _ = tmn.loss_fn(tp, tbatch)
        topt.apply_gradients(topt_adam, tp, topt.grads_of(loss, tp))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
        losses.append(loss.item())
    assert losses[-1] < losses[0]
    for name in before:
        for leaf in before[name]:
            got = _jax_layout(tp[name][leaf])
            ref, p0 = np.asarray(jp[name][leaf]), before[name][leaf]
            assert (np.linalg.norm(got - ref)
                    <= MOVE_RTOL * np.linalg.norm(ref - p0)), (name, leaf)
            assert np.abs(got - ref).max() <= 2 * 1e-3 * 3


def test_init_params_shapes_and_scales():
    jp = tmn.params_from_numpy(_np(jmn.init_params(jax.random.PRNGKey(2))),
                               device="cpu")
    tp = tmn.init_params(torch.Generator().manual_seed(2), device="cpu")
    for name in jp:
        for leaf in jp[name]:
            a, b = tp[name][leaf], jp[name][leaf]
            assert a.shape == b.shape and a.requires_grad, (name, leaf)
            if leaf == "bias":
                assert not a.detach().any()
            else:
                assert abs(float(a.detach().std() / b.detach().std())
                           - 1) < 0.15, (name, leaf)


def test_synthetic_batch_construction():
    """JAX's construction (mnist.py:58-66) on the port's generator: labels
    in [0, 10) and images N(0, 0.1^2) around label / 10 times a 0-to-1
    ramp over the 784 pixels; class means as JAX's batch has them."""
    tb = tmn.synthetic_batch(torch.Generator().manual_seed(3), 4096,
                             device="cpu")
    jb = _np(jmn.synthetic_batch(jax.random.PRNGKey(3), 4096))
    assert tb["image"].shape == jb["image"].shape == (4096, 28, 28, 1)
    assert tb["image"].dtype == torch.float32
    labels = tb["label"]
    assert labels.min() >= 0 and labels.max() <= 9
    assert len(set(labels.tolist())) == 10
    ramp = np.linspace(0, 1, 784, dtype=np.float32).reshape(28, 28, 1)
    noise = tb["image"].numpy() - (labels.numpy()[:, None, None, None]
                                   / 10.0) * ramp
    assert abs(noise.std() - 0.1) < 2e-3 and abs(noise.mean()) < 2e-3
    for c in (0, 5, 9):  # ~410 images a class: a pixel's mean is +-0.005
        for images, lab in ((tb["image"].numpy(), labels.numpy()),
                            (jb["image"], jb["label"])):
            dev = images[lab == c].mean(0) - c / 10.0 * ramp
            assert np.abs(dev).mean() < 0.01, c
    loss, _ = tmn.loss_fn(tmn.init_params(torch.Generator().manual_seed(4),
                                          device="cpu"), tb)
    assert torch.isfinite(loss)
