"""ray_tpu_torch.models.gpt2 against ray_tpu.models.gpt2 at GPT2_TINY.

Parameters come from the JAX ``init_params`` and cross as numpy arrays
(``params_from_numpy``); tokens come from numpy with a fixed seed.  The
JAX side's flash attention runs its Pallas kernel in interpret mode; the
port's CPU path runs the kernel's plain version."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jg
from ray_tpu_torch.models import gpt2 as tg

# f32 compute: both models are the same f32 arithmetic in another order
# (measured 3e-7 on logits of magnitude ~1.2).
F32_TOL = 1e-4
# bf16 compute: each side rounds activations to bf16 at slightly other
# places (bias adds, GELU, attention p); measured 4.5e-3 on logits of
# magnitude ~1.2, held to the suite's bf16 TOL.
BF16_TOL = 2e-2

JCFG = jg.GPT2_TINY
SEQ = 100  # not a multiple of 128: the JAX side takes the bhsd kernel


@pytest.fixture(scope="module")
def jax_params():
    return jg.init_params(jax.random.PRNGKey(0), JCFG)


def _cfgs(dtype, attention):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jc = jg.GPT2Config(**{**JCFG.__dict__, "compute_dtype": jdt,
                          "attention": attention})
    tc = replace(tg.GPT2_TINY, compute_dtype=tdt, attention=attention)
    return jc, tc


def _port_params(jax_params, tc):
    return tg.params_from_numpy(jax.tree.map(np.asarray, jax_params), tc,
                                device="cpu")


def test_presets_match_jax():
    for name in ("SMALL", "MEDIUM", "LARGE", "XL", "TINY"):
        j, t = getattr(jg, f"GPT2_{name}"), getattr(tg, f"GPT2_{name}")
        for f in ("vocab_size", "block_size", "n_layer", "n_head", "n_embd"):
            assert getattr(j, f) == getattr(t, f), (name, f)
        assert t.compute_dtype == torch.bfloat16


@pytest.mark.parametrize("attention", ["flash", "dense"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_logits_match_jax(jax_params, dtype, attention):
    jc, tc = _cfgs(dtype, attention)
    tokens = np.random.default_rng(0).integers(0, JCFG.vocab_size, (2, SEQ))
    jl = np.asarray(jg.forward(jax_params, jnp.asarray(tokens), jc))
    tl = tg.forward(_port_params(jax_params, tc), torch.from_numpy(tokens),
                    tc)
    assert tl.dtype == torch.float32
    assert tl.shape == (2, SEQ, JCFG.vocab_size)
    np.testing.assert_allclose(tl.numpy(), jl,
                               atol=F32_TOL if dtype == "f32" else BF16_TOL)


def test_greedy_generation_matches_jax(jax_params):
    """8 greedy tokens, token for token, against a JAX loop written like
    examples/serve_llm.py (a jitted full forward per token).  The JAX
    sequence is right-padded to one fixed length so the loop compiles
    once; causal attention makes logits[n - 1] blind to the padding."""
    jc, tc = _cfgs("f32", "flash")
    params = _port_params(jax_params, tc)
    fwd = jax.jit(lambda p, t: jg.forward(p, t, jc))
    prompt = np.random.default_rng(1).integers(
        0, JCFG.vocab_size, 12).tolist()
    jt, tt = list(prompt), list(prompt)
    for _ in range(8):
        padded = jnp.asarray([jt + [0] * (20 - len(jt))])
        jt.append(int(fwd(jax_params, padded)[0, len(jt) - 1].argmax()))
        tt.append(int(tg.forward(params, torch.tensor([tt]), tc)[0, -1]
                      .argmax()))
    assert tt == jt


def test_num_params_and_init(jax_params):
    tc = tg.GPT2_TINY
    ported = _port_params(jax_params, tc)
    assert tg.num_params(ported) == jg.num_params(jax_params)
    fresh = tg.init_params(torch.Generator().manual_seed(0), tc,
                           device="cpu")
    assert tg.num_params(fresh) == jg.num_params(jax_params)
    assert fresh["h_1"]["mlp"]["c_proj"]["kernel"].shape == (256, 64)
    logits = tg.forward(fresh, torch.tensor([[1, 2, 3]]), tc)
    assert torch.isfinite(logits).all()


def test_unported_features_and_limits_raise(jax_params):
    params = _port_params(jax_params, tg.GPT2_TINY)
    too_long = torch.zeros((1, tg.GPT2_TINY.block_size + 1),
                           dtype=torch.long)
    with pytest.raises(ValueError, match="block_size"):
        tg.forward(params, too_long, tg.GPT2_TINY)


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        tg.init_params(torch.Generator().manual_seed(0), tg.GPT2_TINY)
