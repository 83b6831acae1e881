"""GPT-2 forward in PyTorch — counterpart of ``ray_tpu/models/gpt2.py``.

Parameters are a nested dict of tensors with the JAX package's names
(``wte/embedding``, ``h_{i}/attn/c_attn/kernel``, ...), f32 as there;
matmuls run in ``compute_dtype`` (bf16) with the weights cast per use, as
the JAX model's ``.astype(x.dtype)`` does.  ``params_from_numpy`` carries
a JAX parameter tree across as numpy arrays.

Numerics follow the JAX model step for step: layer-norm statistics in f32
with the population variance, tanh-approximated GELU, the f32 embedding
sum cast to ``compute_dtype``, a final layer norm on f32 input, and a tied
lm head with bf16 operands and f32 logits over the padded vocabulary.
Attention goes through ``flash_attention_bshd`` (``attention="flash"``,
the CUDA kernel on the card) or the plain dense version
(``attention="dense"``).

Forward only.  MoE, ring/ulysses attention, pipeline-stacked ``blocks``,
remat, the loss and the train step are not ported yet (ROADMAP.md); a
config that selects one of them raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ray_tpu_torch.ops.flash_attention import (_reference_attention,
                                               flash_attention_bshd)


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50304  # padded to a multiple of 128
    block_size: int = 1024
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    compute_dtype: Any = torch.bfloat16
    attention: str = "flash"  # flash | dense (ring | ulysses: not ported)
    remat: bool = False       # training only: not ported
    moe_experts: int = 0      # >0 selects the MoE FFN: not ported

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


GPT2_SMALL = GPT2Config()
GPT2_MEDIUM = GPT2Config(n_layer=24, n_head=16, n_embd=1024)
GPT2_LARGE = GPT2Config(n_layer=36, n_head=20, n_embd=1280)
GPT2_XL = GPT2Config(n_layer=48, n_head=25, n_embd=1600)
GPT2_TINY = GPT2Config(vocab_size=512, block_size=128, n_layer=2, n_head=2,
                       n_embd=64)


def _check_ported(cfg: GPT2Config):
    if cfg.attention not in ("flash", "dense"):
        raise NotImplementedError(
            f"attention={cfg.attention!r} is not ported yet (ROADMAP.md: "
            "ring/ulysses attention)")
    if cfg.moe_experts > 0:
        raise NotImplementedError(
            "the MoE FFN is not ported yet (ROADMAP.md: GPT-2 MoE)")
    if cfg.remat:
        raise NotImplementedError(
            "remat is a training option, not ported yet (ROADMAP.md: "
            "Training GPT-2)")


def init_params(generator: torch.Generator, cfg: GPT2Config,
                device="cuda") -> Dict[str, Any]:
    """Random f32 parameters with the JAX initialiser's distributions
    (normal std 0.02, wpe 0.01, residual projections 0.02/sqrt(2L), zero
    biases, unit LN scales).  ``generator`` draws every tensor on its own
    device; the result lives on ``device``."""
    _check_ported(cfg)
    std = 0.02
    proj_std = std / math.sqrt(2 * cfg.n_layer)
    E = cfg.n_embd

    def normal(shape, s=std):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * s
        return x.to(device)

    def ones(n):
        return torch.ones(n, dtype=torch.float32, device=device)

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=device)

    params: Dict[str, Any] = {
        "wte": {"embedding": normal((cfg.vocab_size, E))},
        "wpe": {"embedding": normal((cfg.block_size, E), 0.01)},
        "ln_f": {"scale": ones(E), "bias": zeros(E)},
    }
    for i in range(cfg.n_layer):
        params[f"h_{i}"] = {
            "ln_1": {"scale": ones(E), "bias": zeros(E)},
            "attn": {
                "c_attn": {"kernel": normal((E, 3 * E)),
                           "bias": zeros(3 * E)},
                "c_proj": {"kernel": normal((E, E), proj_std),
                           "bias": zeros(E)},
            },
            "ln_2": {"scale": ones(E), "bias": zeros(E)},
            "mlp": {
                "c_fc": {"kernel": normal((E, 4 * E)), "bias": zeros(4 * E)},
                "c_proj": {"kernel": normal((4 * E, E), proj_std),
                           "bias": zeros(E)},
            },
        }
    return params


def params_from_numpy(tree, cfg: GPT2Config, device="cuda") -> Dict[str, Any]:
    """The JAX parameter tree as numpy arrays (``jax.tree.map(np.asarray,
    params)``) -> the port's parameters on ``device``, same names."""
    _check_ported(cfg)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return torch.tensor(node, dtype=torch.float32, device=device)

    return conv(tree)


def _layer_norm(x, p, eps=1e-5):
    """Stats in f32 (population variance); output cast back to the input
    dtype after the f32 scale and bias."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def _linear(x, p):
    """``x @ kernel + bias`` in x's dtype, rounded after the matmul and
    again after the bias add, as the JAX model does."""
    return x @ p["kernel"].to(x.dtype) + p["bias"].to(x.dtype)


def _attention(x, p, cfg: GPT2Config):
    B, S, E = x.shape
    H, D = cfg.n_head, cfg.head_dim
    qkv = _linear(x, p["c_attn"])
    q, k, v = (t.reshape(B, S, H, D) for t in qkv.split(E, dim=-1))
    if cfg.attention == "dense":
        tr = lambda t: t.transpose(1, 2)  # noqa: E731
        o, _ = _reference_attention(tr(q), tr(k), tr(v), D ** -0.5, True)
        o = tr(o.to(x.dtype))
    else:
        # strided views of qkv go straight to the kernel: no transposes
        o = flash_attention_bshd(q, k, v, True)
    return _linear(o.reshape(B, S, E), p["c_proj"])


def _mlp(x, p):
    h = F.gelu(_linear(x, p["c_fc"]), approximate="tanh")
    return _linear(h, p["c_proj"])


def _block(x, p, cfg: GPT2Config):
    x = x + _attention(_layer_norm(x, p["ln_1"]), p["attn"], cfg)
    return x + _mlp(_layer_norm(x, p["ln_2"]), p["mlp"])


def _trunk(params, tokens, cfg: GPT2Config):
    """Embedding + transformer blocks + final LN -> (B, S, E) in
    compute_dtype."""
    _check_ported(cfg)
    if "blocks" in params:
        raise NotImplementedError(
            "pipeline-stacked params are not ported yet (ROADMAP.md: "
            "parallel)")
    S = tokens.shape[1]
    if S > cfg.block_size:
        raise ValueError(
            f"sequence of {S} tokens exceeds block_size {cfg.block_size}")
    x = params["wte"]["embedding"][tokens] + params["wpe"]["embedding"][:S][None]
    x = x.to(cfg.compute_dtype)
    for i in range(cfg.n_layer):
        x = _block(x, params[f"h_{i}"], cfg)
    x = _layer_norm(x.float(), params["ln_f"])
    return x.to(cfg.compute_dtype)


def forward(params, tokens, cfg: GPT2Config):
    """tokens (B, S) int64 -> logits (B, S, vocab) f32.

    The tied lm head multiplies compute-dtype operands with f32 output:
    both operands are up-cast to f32 (exact for bf16) and multiplied in
    f32, so the logits are not rounded to bf16 (which would tie argmaxes
    that the JAX model separates).  Needs TF32 off for f32 matmuls
    (``torch.backends.cuda.matmul.allow_tf32 = False``, the default)."""
    x = _trunk(params, tokens, cfg)
    wte = params["wte"]["embedding"].to(cfg.compute_dtype)
    return torch.matmul(x.float(), wte.float().T)


def num_params(params) -> int:
    if isinstance(params, dict):
        return sum(num_params(v) for v in params.values())
    return params.numel()
