"""Llama in PyTorch — counterpart of ``ray_tpu/models/llama.py``.

A Llama-family decoder (RMSNorm, rotate-half RoPE, SwiGLU MLP, grouped-query
attention) with a static KV cache and a ``generate`` loop.  Parameters are
a nested dict of tensors with the JAX package's names
(``embed_tokens/embedding``, ``layer_{i}/attn/q_proj/kernel``, ...,
``norm_f/scale``, ``lm_head/kernel``), f32 as there; ``params_from_numpy``
carries a JAX parameter tree across as numpy arrays.

Numerics follow the JAX model step for step: the RMSNorm variance in f32
with ``rsqrt`` cast to the activations' dtype before the products; RoPE
angles in f32 with cos and sin cast to the activations' dtype; the
residual stream in ``compute_dtype``; an f32 x f32 lm head (TF32 must be
off on the card: ``torch.backends.cuda.matmul.allow_tf32 = False``).

Attention has the reference's two branches:

* no cache (``forward(params, tokens, cfg)``): k and v repeated to the
  query heads, then ``flash_attention_bshd`` (causal) — the CUDA kernel on
  the card, its plain version on the CPU;
* a cache (prefill and decode, hence all of ``generate``): the step's k
  and v written into the static ``(B, max_seq, Hk, D)`` cache at
  ``cache_index`` (clamped so the write fits, as
  ``lax.dynamic_update_slice`` clamps), then dense f32 attention over the
  whole cache with the mask ``slot <= position``.  This branch is plain
  PyTorch by design: the reference computes it outside any kernel.

Unlike the JAX model, which returns updated copies, ``forward`` writes the
cache tensors in place and returns them.

``serving_params`` casts a tree once to ``compute_dtype`` (the lm head
stays f32), which gives the same numbers as the per-use casts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.ops.flash_attention import flash_attention_bshd

_MASK_FILL = -1e30


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    n_layer: int = 32
    n_head: int = 32
    n_kv_head: int = 32
    n_embd: int = 4096
    intermediate: int = 11008
    max_seq: int = 4096
    rope_theta: float = 10000.0
    compute_dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


LLAMA_7B = LlamaConfig()
LLAMA_TINY = LlamaConfig(vocab_size=256, n_layer=2, n_head=4, n_kv_head=2,
                         n_embd=64, intermediate=128, max_seq=128)


def init_params(generator: torch.Generator, cfg: LlamaConfig,
                device="cuda") -> Dict[str, Any]:
    """Random f32 parameters with the JAX initialiser's distributions
    (normal std 0.02 on the embedding and every matmul weight, unit norm
    scales).  ``generator`` draws every tensor on its own device; the
    result lives on ``device``."""
    std = 0.02
    E, D = cfg.n_embd, cfg.head_dim

    def normal(*shape):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * std
        return x.to(device)

    def ones():
        return torch.ones(E, dtype=torch.float32, device=device)

    params: Dict[str, Any] = {
        "embed_tokens": {"embedding": normal(cfg.vocab_size, E)},
        "norm_f": {"scale": ones()},
        "lm_head": {"kernel": normal(E, cfg.vocab_size)},
    }
    for i in range(cfg.n_layer):
        params[f"layer_{i}"] = {
            "input_norm": {"scale": ones()},
            "attn": {
                "q_proj": {"kernel": normal(E, cfg.n_head * D)},
                "k_proj": {"kernel": normal(E, cfg.n_kv_head * D)},
                "v_proj": {"kernel": normal(E, cfg.n_kv_head * D)},
                "o_proj": {"kernel": normal(cfg.n_head * D, E)},
            },
            "post_norm": {"scale": ones()},
            "mlp": {
                "gate_proj": {"kernel": normal(E, cfg.intermediate)},
                "up_proj": {"kernel": normal(E, cfg.intermediate)},
                "down_proj": {"kernel": normal(cfg.intermediate, E)},
            },
        }
    return params


def params_from_numpy(tree, cfg: LlamaConfig, device="cuda") -> Dict[str, Any]:
    """The JAX parameter tree as numpy arrays (``jax.tree.map(np.asarray,
    params)``) -> the port's f32 parameters on ``device``, same names."""

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return torch.tensor(node, dtype=torch.float32, device=device)

    return conv(tree)


def serving_params(params, cfg: LlamaConfig) -> Dict[str, Any]:
    """The tree with every leaf cast once to ``cfg.compute_dtype`` except
    ``lm_head/kernel``, which the head multiplies in f32.  ``forward`` gives
    the same logits on either tree: the reference casts each weight, norm
    scale and the gathered embedding rows to the compute dtype at every
    use, and a cast is idempotent and commutes with the gather."""

    def cast(node, path):
        if isinstance(node, dict):
            return {k: cast(v, path + (k,)) for k, v in node.items()}
        if path == ("lm_head", "kernel"):
            return node
        return node.to(cfg.compute_dtype)

    return cast(params, ())


def _rms_norm(x, p, eps=1e-5):
    """The mean square in f32; ``rsqrt`` cast to x's dtype, and both
    products in x's dtype."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * p["scale"].to(x.dtype)


def _rope(x, positions, theta):
    """Rotate-half RoPE.  x: (B, S, H, D); positions: (S,) or (B, S).
    Angles in f32; cos and sin cast to x's dtype before the products."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs   # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :].to(x.dtype)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    x1, x2 = x.split(half, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _repeat_kv(x, n_rep: int):
    """(B, S, Hk, D) -> (B, S, Hk * n_rep, D), each head repeated
    ``n_rep`` times in place (``jnp.repeat`` on the head axis)."""
    if n_rep == 1:
        return x
    return x.repeat_interleave(n_rep, dim=2)


def _cache_write(cache, x, cache_index):
    """``lax.dynamic_update_slice(cache, x, (0, cache_index, 0, 0))`` in
    place: the start is clamped to [0, max_seq - S] so the write fits."""
    S, max_seq = x.shape[1], cache.shape[1]
    start = min(max(int(cache_index), 0), max_seq - S)
    cache[:, start:start + S] = x.to(cache.dtype)
    return cache


def _attn_block(x, p, cfg: LlamaConfig, positions, cache=None,
                cache_index=None):
    """Returns (attention output projected to E, the updated cache or
    None).  ``positions`` must be (B, S) when a cache is given."""
    B, S, _ = x.shape
    H, Hk, D = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    q = (x @ p["q_proj"]["kernel"].to(x.dtype)).reshape(B, S, H, D)
    k = (x @ p["k_proj"]["kernel"].to(x.dtype)).reshape(B, S, Hk, D)
    v = (x @ p["v_proj"]["kernel"].to(x.dtype)).reshape(B, S, Hk, D)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    new_cache = None
    if cache is not None:
        ck = _cache_write(cache[0], k, cache_index)
        cv = _cache_write(cache[1], v, cache_index)
        new_cache = (ck, cv)
        # every slot of the static cache, masked by absolute position:
        # slots past the write frontier are zeros and masked
        kk = _repeat_kv(ck, H // Hk).transpose(1, 2).float()
        vv = _repeat_kv(cv, H // Hk).transpose(1, 2).float()
        s = torch.einsum("bhqd,bhkd->bhqk", q.transpose(1, 2).float(),
                         kk) * D ** -0.5
        kv_pos = torch.arange(ck.shape[1], device=x.device)
        mask = kv_pos[None, None, None, :] <= positions[:, None, :, None]
        s = torch.where(mask, s, torch.full_like(s, _MASK_FILL))
        o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), vv)
        o = o.to(x.dtype).transpose(1, 2).reshape(B, S, H * D)
    else:
        k = _repeat_kv(k, H // Hk)
        v = _repeat_kv(v, H // Hk)
        o = flash_attention_bshd(q, k, v, True).reshape(B, S, H * D)
    return o @ p["o_proj"]["kernel"].to(x.dtype), new_cache


def _mlp_block(x, p):
    g = F.silu(x @ p["gate_proj"]["kernel"].to(x.dtype))
    u = x @ p["up_proj"]["kernel"].to(x.dtype)
    return (g * u) @ p["down_proj"]["kernel"].to(x.dtype)


def forward(params, tokens, cfg: LlamaConfig, caches=None, cache_index=None,
            positions=None) -> Tuple[torch.Tensor, Optional[List]]:
    """tokens (B, S) -> (logits (B, S, vocab) f32, new_caches).

    Without ``caches`` attention runs causally over the S tokens through
    the flash kernel and ``new_caches`` is None.  With ``caches`` (from
    ``init_cache``) the step's k and v are written at ``cache_index`` and
    attention is dense over the cache; ``positions`` (B, S) default to
    0..S-1."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = params["embed_tokens"]["embedding"][tokens].to(cfg.compute_dtype)
    new_caches = []
    for i in range(cfg.n_layer):
        p = params[f"layer_{i}"]
        h, nc = _attn_block(_rms_norm(x, p["input_norm"]), p["attn"], cfg,
                            positions, None if caches is None else caches[i],
                            cache_index)
        x = x + h
        x = x + _mlp_block(_rms_norm(x, p["post_norm"]), p["mlp"])
        new_caches.append(nc)
    x = _rms_norm(x, params["norm_f"]).float()
    logits = x @ params["lm_head"]["kernel"]
    return logits, (new_caches if caches is not None else None)


def init_cache(cfg: LlamaConfig, batch_size: int, dtype=None,
               device="cuda") -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per layer, zero (k, v) caches of (batch, max_seq, n_kv_head, D) in
    ``dtype`` (default ``compute_dtype``) on ``device``."""
    shape = (batch_size, cfg.max_seq, cfg.n_kv_head, cfg.head_dim)
    dtype = dtype or cfg.compute_dtype
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.n_layer)]


@torch.inference_mode()
def generate(params, prompt_tokens, cfg: LlamaConfig, max_new_tokens: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (``temperature == 0``) or sampled decoding with a static KV
    cache on the prompt's device.  prompt_tokens (B, S_prompt) ->
    (B, S_prompt + max_new_tokens) in the prompt's dtype.

    A cached prefill of the prompt, then one cached forward per new token
    (the loop in place of the reference's ``lax.scan``); attention is the
    dense cached branch throughout, as in the reference, so the flash
    kernel is never launched here.  Greedy picks the first maximum, as
    ``jnp.argmax`` does.  Sampling draws from ``softmax(logits /
    temperature)`` with ``generator`` (default: seeded 0, as the
    reference's default key is fixed); it cannot reproduce JAX's bits.
    The reference's last forward, whose logits it discards, is skipped:
    the tokens are the same."""
    B, S0 = prompt_tokens.shape
    device = prompt_tokens.device
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    caches = init_cache(cfg, B, device=device)
    positions = torch.arange(S0, device=device).expand(B, S0)
    logits, caches = forward(params, prompt_tokens, cfg, caches, 0,
                             positions)
    last = logits[:, -1]
    toks = []
    for i in range(max_new_tokens):
        if temperature == 0.0:
            tok = last.argmax(dim=-1)
        else:
            probs = torch.softmax(last / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        toks.append(tok)
        if i + 1 == max_new_tokens:
            break
        pos = S0 + i
        positions = torch.full((B, 1), pos, device=device)
        logits, caches = forward(params, tok[:, None], cfg, caches, pos,
                                 positions)
        last = logits[:, -1]
    new = (torch.stack(toks, dim=1) if toks
           else prompt_tokens.new_zeros((B, 0)))
    return torch.cat([prompt_tokens, new.to(prompt_tokens.dtype)], dim=1)


def num_params(params) -> int:
    if isinstance(params, dict):
        return sum(num_params(v) for v in params.values())
    return params.numel()
