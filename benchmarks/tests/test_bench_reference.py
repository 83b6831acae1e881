"""The reference against the program's plain path (``attention="dense"``,
float32 compute) on a small configuration on the CPU: the same weights
and tokens give the same logits, loss and gradients."""

import dataclasses

import pytest
import torch

from benchmarks.harness import data, port
from benchmarks.reference import gpt2 as ref

TINY = {"n_embd": 64, "n_head": 2, "n_layer": 2, "vocab_size": 512,
        "n_positions": 128,
        "assumed": {"compute_dtype": "bfloat16", "remat": False}}


def _program(seed):
    from ray_tpu_torch.models import gpt2

    cfg = dataclasses.replace(port.model_config(TINY), attention="dense",
                              compute_dtype=torch.float32)
    w = ref.init_weights(seed, TINY, "cpu")
    return gpt2, cfg, w, port.port_params(w, cfg.n_layer)


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 11])
def test_forward_and_gradients_match_the_program(seed):
    gpt2, cfg, w, params = _program(seed)
    tokens = torch.from_numpy(data.token_block(seed, 0, 3, 65, 512))
    with torch.no_grad():
        want = gpt2.forward(params, tokens[:, :-1], cfg)
        got = ref.forward(w, tokens[:, :-1], TINY)
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-5)

    named = gpt2.named_leaves(params)
    leaves = [t.detach().clone().requires_grad_(True) for _, t in named]
    tree = port.port_params(
        {port.leaf_names(cfg.n_layer)[n]: t for (n, _), t in
         zip(named, leaves)}, cfg.n_layer)
    loss = gpt2.loss_fn(tree, {"tokens": tokens}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    r_loss, r_grads = ref.loss_and_grads(w, tokens, TINY, rows=2)
    assert r_loss == pytest.approx(loss.item(), rel=1e-6)
    names = port.leaf_names(cfg.n_layer)
    for (n, _), g in zip(named, grads):
        assert torch.allclose(r_grads[names[n]], g, atol=1e-6, rtol=1e-4), n


def test_init_is_the_seeds():
    a = ref.init_weights(5, TINY, "cpu")
    b = ref.init_weights(5, TINY, "cpu")
    c = ref.init_weights(6, TINY, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["wte"], c["wte"])
    assert a["h0.attn.c_proj.w"].std().item() == pytest.approx(
        0.02 / 2, rel=0.1)
    assert a["wpe"].std().item() == pytest.approx(0.01, rel=0.1)
    assert torch.equal(a["h1.ln_2.g"], torch.ones(64))


def test_fp8_control_rounds_every_product():
    x = torch.randn(4, 8, 16, generator=torch.Generator().manual_seed(0))
    w = torch.randn(16, 32, generator=torch.Generator().manual_seed(1))
    exact = x @ w
    low = ref.fp8_matmul(x, w)
    err = ((low - exact).norm() / exact.norm()).item()
    assert 1e-3 < err < 0.2
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    gx, gw = torch.autograd.grad(ref.fp8_matmul(xs, ws).sum(), (xs, ws))
    assert gx.shape == x.shape and gw.shape == w.shape
