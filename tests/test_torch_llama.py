"""ray_tpu_torch.models.llama against ray_tpu.models.llama.

Parameters come from the JAX ``init_params`` and cross as numpy arrays
(``params_from_numpy``); tokens and activations come from numpy with a
fixed seed.  Two configurations take the JAX side's two flash routes on
the CPU: ``LLAMA_TINY`` (H = 4, D = 16: no 128-lane tiling, so the bhsd
Pallas kernel ``_pallas_forward`` in interpret mode) and a D = 128 GQA
config (one head per lane block: the bshd lane kernel
``_pallas_forward_bshd``).  The port's CPU path runs the kernel's plain
version; its cached branch is plain PyTorch on every device."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.ops import flash_attention as jfa
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops import flash_attention as tfa

# f32 compute: the same f32 arithmetic in another order (measured 2.4e-7
# and 1.1e-6 on logits of max 0.67 and 1.31 at the two configs)
F32_TOL = 1e-4
# bf16 compute: the roundings of the two sides fall at the same places up
# to XLA's and torch's own bf16 kernels (measured 4.7e-3 and 1.0e-2); the
# bf16 tolerance of tests/test_torch_gpt2.py
BF16_TOL = 2e-2
# cached vs uncached attention, as tests/test_models.py holds the JAX model
CACHE_TOL = 5e-2

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}

# D = 128 with grouped-query attention (2 query heads share 1 kv head)
JAX_D128 = jl.LlamaConfig(vocab_size=256, n_layer=2, n_head=2, n_kv_head=1,
                          n_embd=256, intermediate=512, max_seq=256)
CONFIGS = {"tiny": (jl.LLAMA_TINY, 16), "d128": (JAX_D128, 128)}
# the Pallas forward each config's uncached attention takes on the CPU
ROUTES = {"tiny": "_pallas_forward", "d128": "_pallas_forward_bshd"}


def _port_cfg(jcfg, dtype="bf16"):
    return tl.LlamaConfig(**{**jcfg.__dict__,
                             "compute_dtype": DTYPES[dtype][1]})


def _jax_cfg(jcfg, dtype="bf16"):
    return replace(jcfg, compute_dtype=DTYPES[dtype][0])


@pytest.fixture(scope="module")
def jax_params():
    return {name: jl.init_params(jax.random.PRNGKey(0), cfg)
            for name, (cfg, _) in CONFIGS.items()}


def _port_params(jparams, cfg):
    return tl.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _randn(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _pair(a, dtype):
    """numpy f32 -> (jax array, torch tensor) of one dtype, rounded once."""
    jdt, tdt = DTYPES[dtype]
    t = torch.from_numpy(a).to(tdt)
    return jnp.asarray(a).astype(jdt), t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _tol(dtype):
    return F32_TOL if dtype == "f32" else BF16_TOL


@pytest.fixture
def route_calls(monkeypatch):
    """Calls of each JAX Pallas forward, counted through a spy."""
    calls = {}
    for name in ROUTES.values():
        real = getattr(jfa, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(jfa, name, spy)
    return calls


# ---------------------------------------------------------------------------
# configuration and parameters
# ---------------------------------------------------------------------------

def test_presets_match_jax():
    for name in ("LLAMA_7B", "LLAMA_TINY"):
        j, t = getattr(jl, name), getattr(tl, name)
        for f in ("vocab_size", "n_layer", "n_head", "n_kv_head", "n_embd",
                  "intermediate", "max_seq", "rope_theta", "head_dim"):
            assert getattr(j, f) == getattr(t, f), (name, f)
        assert t.compute_dtype == torch.bfloat16
    assert tl.LLAMA_7B.head_dim == 128


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tuple(tree.shape)}


@pytest.mark.parametrize("name", ["tiny", "d128"])
def test_param_tree_matches_jax(jax_params, name):
    """Names, shapes, dtype and the initialiser's distributions; the values
    come from another generator and cannot match."""
    jcfg, _ = CONFIGS[name]
    cfg = _port_cfg(jcfg)
    gen = torch.Generator().manual_seed(0)
    params = tl.init_params(gen, cfg, device="cpu")
    assert _shapes(params) == _shapes(jax_params[name])
    assert tl.num_params(params) == sum(
        x.size for x in jax.tree.leaves(jax_params[name]))
    for path, _ in _shapes(params).items():
        node = params
        for k in path.split("/"):
            node = node[k]
        assert node.dtype == torch.float32 and node.device.type == "cpu"
        if path.endswith("scale"):
            assert torch.equal(node, torch.ones_like(node)), path
        else:
            assert abs(node.std().item() - 0.02) < 0.002, path
            assert abs(node.mean().item()) < 0.002, path
    again = tl.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    assert torch.equal(again["layer_1"]["mlp"]["up_proj"]["kernel"],
                       params["layer_1"]["mlp"]["up_proj"]["kernel"])


def test_num_params_llama_7b():
    """LLAMA_7B's count from its shapes, without building it: 6.74 B."""
    cfg = tl.LLAMA_7B
    E, I, V = cfg.n_embd, cfg.intermediate, cfg.vocab_size
    per_layer = 4 * E * E + 3 * E * I + 2 * E
    total = cfg.n_layer * per_layer + 2 * V * E + E
    jp = jax.eval_shape(lambda: jl.init_params(jax.random.PRNGKey(0),
                                               jl.LLAMA_7B))
    assert sum(x.size for x in jax.tree.leaves(jp)) == total == 6738415616


def test_default_device_needs_cuda():
    """Entry points default to the card; without one they raise rather
    than move to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tl.LLAMA_TINY
    with pytest.raises((RuntimeError, AssertionError)):
        tl.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises((RuntimeError, AssertionError)):
        tl.init_cache(cfg, 1)


# ---------------------------------------------------------------------------
# the building blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_matches_jax(dtype):
    jx, tx = _pair(_randn((2, 7, 64), 1, 3.0), dtype)
    scale = 1.0 + _randn((64,), 2, 0.1)
    out_j = jl._rms_norm(jx, {"scale": jnp.asarray(scale)})
    out_t = tl._rms_norm(tx, {"scale": torch.from_numpy(scale)})
    assert out_t.dtype == DTYPES[dtype][1]
    # one bf16 ulp where the two sides' f32 rsqrt round differently
    np.testing.assert_allclose(_np(out_t), _np(out_j),
                               atol=F32_TOL if dtype == "f32" else 0.0,
                               rtol=1e-5 if dtype == "f32" else 2 ** -7)


@pytest.mark.parametrize("pos_shape", ["S", "BS"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rope_matches_jax(dtype, pos_shape):
    B, S, H, D = 2, 9, 3, 16
    jx, tx = _pair(_randn((B, S, H, D), 3), dtype)
    if pos_shape == "S":
        pos = np.arange(5, 5 + S)
    else:
        pos = np.random.default_rng(4).integers(0, 4096, (B, S))
    out_j = jl._rope(jx, jnp.asarray(pos), 10000.0)
    out_t = tl._rope(tx, torch.from_numpy(pos), 10000.0)
    assert out_t.shape == (B, S, H, D) and out_t.dtype == DTYPES[dtype][1]
    # angles up to 4096 rad: cos/sin of f32 angles agree to ~1e-4 across
    # libraries; bf16 rounds them first
    np.testing.assert_allclose(_np(out_t), _np(out_j),
                               atol=5e-4 if dtype == "f32" else BF16_TOL)


@pytest.mark.parametrize("n_rep", [1, 2, 4])
def test_repeat_kv_matches_jax(n_rep):
    x = _randn((2, 5, 3, 8), 5)
    out_j = jl._repeat_kv(jnp.asarray(x), n_rep)
    out_t = tl._repeat_kv(torch.from_numpy(x), n_rep)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mlp_block_matches_jax(jax_params, dtype):
    jp = jax_params["tiny"]["layer_0"]["mlp"]
    tp = _port_params(jp, None)
    jx, tx = _pair(_randn((2, 6, 64), 6), dtype)
    np.testing.assert_allclose(_np(tl._mlp_block(tx, tp)),
                               _np(jl._mlp_block(jx, jp)), atol=_tol(dtype))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["tiny", "d128"])
def test_attn_block_without_cache_matches_jax(jax_params, route_calls, name,
                                              dtype):
    """The flash branch: the JAX side through its Pallas route, the port's
    through the plain version of the CUDA kernel."""
    jcfg, _ = CONFIGS[name]
    jp = jax_params[name]["layer_0"]["attn"]
    tp = _port_params(jp, None)
    B, S, E = 2, 128, jcfg.n_embd
    jx, tx = _pair(_randn((B, S, E), 7), dtype)
    pos = np.broadcast_to(np.arange(S), (B, S))
    out_j, cache_j = jl._attn_block(jx, jp, _jax_cfg(jcfg, dtype),
                                    jnp.asarray(pos))
    out_t, cache_t = tl._attn_block(tx, tp, _port_cfg(jcfg, dtype),
                                    torch.from_numpy(pos.copy()))
    assert cache_j is None and cache_t is None
    assert route_calls == {ROUTES[name]: 1}
    np.testing.assert_allclose(_np(out_t), _np(out_j), atol=_tol(dtype))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["tiny", "d128"])
def test_attn_block_with_cache_matches_jax(jax_params, route_calls, name,
                                           dtype):
    """The dense cached branch over a cache already holding 40 positions
    of random k/v: the write at cache_index 40 and the attention of the
    new rows over slots 0..position."""
    jcfg, _ = CONFIGS[name]
    jp = jax_params[name]["layer_0"]["attn"]
    tp = _port_params(jp, None)
    B, S, E, idx = 2, 6, jcfg.n_embd, 40
    shape = (B, jcfg.max_seq, jcfg.n_kv_head, jcfg.head_dim)
    (jk, tk), (jv, tv) = (_pair(_randn(shape, s), dtype) for s in (8, 9))
    jx, tx = _pair(_randn((B, S, E), 10), dtype)
    pos = np.broadcast_to(np.arange(idx, idx + S), (B, S))
    out_j, (ck_j, cv_j) = jl._attn_block(
        jx, jp, _jax_cfg(jcfg, dtype), jnp.asarray(pos), (jk, jv), idx)
    out_t, (ck_t, cv_t) = tl._attn_block(
        tx, tp, _port_cfg(jcfg, dtype), torch.from_numpy(pos.copy()),
        (tk, tv), idx)
    assert route_calls == {}
    assert ck_t is tk and cv_t is tv   # written in place
    np.testing.assert_allclose(_np(out_t), _np(out_j), atol=_tol(dtype))
    np.testing.assert_allclose(_np(ck_t), _np(ck_j), atol=_tol(dtype))
    np.testing.assert_array_equal(_np(cv_t), _np(cv_j))


@pytest.mark.parametrize("n_kv_head", [2, 1], ids=["mha", "gqa"])
def test_kernel_inputs_need_no_copy(monkeypatch, n_kv_head):
    """The q, k, v the uncached branch hands to the kernel (q and k out of
    RoPE's concatenation, k and v repeated for GQA or v a view of its
    projection) are read through their strides: ``_kernel_ready`` makes no
    copy of them."""
    cfg = tl.LlamaConfig(vocab_size=64, n_layer=1, n_head=2,
                         n_kv_head=n_kv_head, n_embd=256, intermediate=64,
                         max_seq=64, compute_dtype=torch.bfloat16)
    params = tl.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    seen = []

    def spy(q, k, v, causal):
        seen.append((q, k, v))
        return tfa.flash_attention_bshd(q, k, v, causal)

    monkeypatch.setattr(tl, "flash_attention_bshd", spy)
    tl.forward(params, torch.zeros((2, 40), dtype=torch.long), cfg)
    (q, k, v), = seen
    assert q.shape == k.shape == v.shape == (2, 40, 2, 128)
    assert all(tfa._kernel_ready(x) is x for x in (q, k, v))


@pytest.mark.parametrize("index", [0, 120, 125, 200])
def test_clamped_cache_write_matches_dynamic_update_slice(index):
    """A write that would run past max_seq starts at max_seq - S, as
    ``lax.dynamic_update_slice`` clamps it."""
    cache = _randn((2, 128, 2, 4), 11)
    x = _randn((2, 8, 2, 4), 12)
    want = jax.lax.dynamic_update_slice(jnp.asarray(cache), jnp.asarray(x),
                                        (0, index, 0, 0))
    got = tl._cache_write(torch.from_numpy(cache.copy()),
                          torch.from_numpy(x), index)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["tiny", "d128"])
def test_logits_match_jax(jax_params, route_calls, name, dtype):
    jcfg, _ = CONFIGS[name]
    S = 128 if name == "d128" else 48
    tokens = _tokens(jcfg, 2, S)
    jlog, jc = jl.forward(jax_params[name], jnp.asarray(tokens),
                          _jax_cfg(jcfg, dtype))
    cfg = _port_cfg(jcfg, dtype)
    tlog, tc = tl.forward(_port_params(jax_params[name], cfg),
                          torch.from_numpy(tokens), cfg)
    assert jc is None and tc is None
    assert route_calls == {ROUTES[name]: jcfg.n_layer}
    assert tlog.dtype == torch.float32
    assert tlog.shape == (2, S, jcfg.vocab_size)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=_tol(dtype))


@pytest.mark.parametrize("name", ["tiny", "d128"])
def test_cached_prefill_and_decode_match_jax_and_uncached(jax_params, name):
    """Cached prefill of S-1 tokens, then one decode step (f32 caches, bf16
    compute, as tests/test_models.py runs the JAX model): logits and caches
    against JAX, and the decode step's logits against the port's own
    uncached forward over all S tokens."""
    jcfg, _ = CONFIGS[name]
    B, S = 2, 16
    tokens = _tokens(jcfg, B, S, seed=1)
    cfg = _port_cfg(jcfg)
    params = _port_params(jax_params[name], cfg)
    jparams = jax_params[name]

    jcaches = jl.init_cache(jcfg, B, jnp.float32)
    tcaches = tl.init_cache(cfg, B, torch.float32, device="cpu")
    pos = np.broadcast_to(np.arange(S - 1), (B, S - 1))
    jpre, jcaches = jl.forward(jparams, jnp.asarray(tokens[:, :-1]), jcfg,
                               jcaches, 0, jnp.asarray(pos))
    tpre, tcaches = tl.forward(params, torch.from_numpy(tokens[:, :-1]), cfg,
                               tcaches, 0, torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(tpre.numpy(), np.asarray(jpre), atol=BF16_TOL)
    last = np.full((B, 1), S - 1)
    jstep, jcaches = jl.forward(jparams, jnp.asarray(tokens[:, -1:]), jcfg,
                                jcaches, S - 1, jnp.asarray(last))
    tstep, tcaches = tl.forward(params, torch.from_numpy(tokens[:, -1:]),
                                cfg, tcaches, S - 1, torch.from_numpy(last))
    np.testing.assert_allclose(tstep.numpy(), np.asarray(jstep),
                               atol=BF16_TOL)
    for (jk, jv), (tk, tv) in zip(jcaches, tcaches):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=BF16_TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=BF16_TOL)
        assert not tk[:, S:].any() and not tv[:, S:].any()

    full, _ = tl.forward(params, torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(tstep[:, 0].numpy(), full[:, -1].numpy(),
                               atol=CACHE_TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_past_max_seq_clamps_like_jax(jax_params, dtype):
    """A cached step at cache_index + S > max_seq: both write at
    max_seq - S and attend over the whole cache."""
    jcfg = jl.LLAMA_TINY
    cfg = _port_cfg(jcfg, dtype)
    B, S, idx = 2, 4, jcfg.max_seq - 2
    tokens = _tokens(jcfg, B, S, seed=2)
    pos = np.broadcast_to(np.arange(idx, idx + S), (B, S))
    shape = (B, jcfg.max_seq, jcfg.n_kv_head, jcfg.head_dim)
    jcaches, tcaches = [], []
    for i in range(jcfg.n_layer):
        (jk, tk), (jv, tv) = (_pair(_randn(shape, 20 + 2 * i + j, 0.1),
                                    dtype) for j in (0, 1))
        jcaches.append((jk, jv))
        tcaches.append((tk, tv))
    jlog, jcaches = jl.forward(jax_params["tiny"], jnp.asarray(tokens),
                               _jax_cfg(jcfg, dtype), jcaches, idx,
                               jnp.asarray(pos))
    tlog, tcaches = tl.forward(_port_params(jax_params["tiny"], cfg),
                               torch.from_numpy(tokens), cfg, tcaches, idx,
                               torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=_tol(dtype))
    for (jk, jv), (tk, tv) in zip(jcaches, tcaches):
        np.testing.assert_allclose(_np(tk), _np(jk), atol=_tol(dtype))
        np.testing.assert_allclose(_np(tv), _np(jv), atol=_tol(dtype))


@pytest.mark.parametrize("name", ["tiny", "d128"])
def test_serving_params_give_identical_logits(jax_params, name):
    """Cast once (lm head f32) or per use: the same logits, bit for bit,
    on both attention branches."""
    jcfg, _ = CONFIGS[name]
    cfg = _port_cfg(jcfg)
    params = _port_params(jax_params[name], cfg)
    served = tl.serving_params(params, cfg)
    assert served["lm_head"]["kernel"].dtype == torch.float32
    assert served["embed_tokens"]["embedding"].dtype == torch.bfloat16
    assert served["layer_0"]["input_norm"]["scale"].dtype == torch.bfloat16
    assert served["layer_1"]["mlp"]["down_proj"]["kernel"].dtype == \
        torch.bfloat16
    tokens = torch.from_numpy(_tokens(jcfg, 2, 32, seed=3))
    a, _ = tl.forward(params, tokens, cfg)
    b, _ = tl.forward(served, tokens, cfg)
    assert torch.equal(a, b)
    ca, cb = (tl.init_cache(cfg, 2, device="cpu") for _ in range(2))
    a, _ = tl.forward(params, tokens, cfg, ca, 0)
    b, _ = tl.forward(served, tokens, cfg, cb, 0)
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for u, w in zip(ca, cb)
               for x, y in zip(u, w))


@pytest.mark.parametrize("prompt_len", [5, 16])
def test_greedy_generate_matches_jax(jax_params, prompt_len):
    """LLAMA_TINY in f32, B = 2: the same tokens, token for token."""
    jcfg = _jax_cfg(jl.LLAMA_TINY, "f32")
    cfg = _port_cfg(jl.LLAMA_TINY, "f32")
    prompt = _tokens(jcfg, 2, prompt_len, seed=4)
    want = np.asarray(jl.generate(jax_params["tiny"],
                                  jnp.asarray(prompt, jnp.int32), jcfg,
                                  max_new_tokens=8))
    got = tl.generate(_port_params(jax_params["tiny"], cfg),
                      torch.from_numpy(prompt), cfg, max_new_tokens=8)
    assert got.dtype == torch.int64 and got.shape == (2, prompt_len + 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_generate_equals_uncached_greedy(jax_params):
    """Greedy decoding through the cache picks the tokens that a full
    uncached forward per token picks (f32, where the two agree to ~1e-6)."""
    cfg = _port_cfg(jl.LLAMA_TINY, "f32")
    params = _port_params(jax_params["tiny"], cfg)
    prompt = torch.from_numpy(_tokens(cfg, 1, 7, seed=5))
    out = tl.generate(params, prompt, cfg, max_new_tokens=6)
    seq = prompt
    for _ in range(6):
        logits, _ = tl.forward(params, seq, cfg)
        seq = torch.cat([seq, logits[:, -1].argmax(-1, keepdim=True)], 1)
    assert torch.equal(out, seq)


def test_sampled_generate_is_reproducible(jax_params):
    """temperature > 0: tokens in the vocabulary, the prompt unchanged,
    the same tokens under one seed (and by default), others under
    another."""
    cfg = _port_cfg(jl.LLAMA_TINY, "f32")
    params = _port_params(jax_params["tiny"], cfg)
    prompt = torch.from_numpy(_tokens(cfg, 2, 5, seed=6))

    def sample(seed=None, n=24):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return tl.generate(params, prompt, cfg, n, temperature=1.5,
                           generator=gen)

    a, b, c = sample(7), sample(7), sample(8)
    assert a.shape == (2, 29) and torch.equal(a[:, :5], prompt)
    assert ((a >= 0) & (a < cfg.vocab_size)).all()
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(sample(), sample(0))
    assert tl.generate(params, prompt, cfg, 0).shape == (2, 5)
