"""GPT-2 in PyTorch — counterpart of ``ray_tpu/models/gpt2.py``.

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

Training: ``loss_fn`` (next-token cross-entropy through the dense tied
head) and ``make_train_step`` (f32 master weights cast once to
``compute_dtype`` per step, as the JAX ``_cast_weights`` does, and a
``torch.optim`` optimizer such as AdamW over ``param_leaves``).  Gradients
of attention go through the flash backward kernels on the card.

MoE, ring/ulysses attention, pipeline-stacked ``blocks``, remat and the
chunked cross-entropy are not ported yet (ROADMAP.md); a config that
selects one of the first four raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

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
    remat: bool = False       # checkpoint each block: not ported
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
            "remat is not ported yet (ROADMAP.md: remat and the chunked "
            "cross-entropy)")


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
    compute_dtype.  The embedding sum runs in the dtype of the tables: f32
    when serving, ``compute_dtype`` in training, where ``_cast_weights``
    has cast them, as in the JAX model."""
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


def _lm_head(x, wte):
    """The tied lm head: compute-dtype operands, f32 logits.  Both operands
    are up-cast to f32 (exact for bf16) and multiplied in f32, so the
    logits are not rounded to bf16 (which would tie argmaxes that the JAX
    model separates).  Needs TF32 off for f32 matmuls
    (``torch.backends.cuda.matmul.allow_tf32 = False``, the default)."""
    return torch.matmul(x.float(), wte.float().T)


def forward(params, tokens, cfg: GPT2Config):
    """tokens (B, S) int64 -> logits (B, S, vocab) f32."""
    x = _trunk(params, tokens, cfg)
    return _lm_head(x, params["wte"]["embedding"].to(cfg.compute_dtype))


def loss_fn(params, batch, cfg: GPT2Config):
    """batch: {"tokens": (B, S+1) int64} -> mean next-token cross-entropy
    (f32 scalar) through the tied head's f32 logits."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    x = _trunk(params, inputs, cfg)
    logits = _lm_head(x, params["wte"]["embedding"].to(cfg.compute_dtype))
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets[..., None])[..., 0]
    return (lse - tgt).mean()


def _cast_weights(params, dtype):
    """The parameter tree with every f32 leaf of ndim >= 2 (the matmul
    weights and both embedding tables) cast once to ``dtype``; 1-D leaves
    (biases, LN scales) stay f32.  Differentiable: gradients flow back to
    the f32 leaves."""
    if isinstance(params, dict):
        return {k: _cast_weights(v, dtype) for k, v in params.items()}
    if params.dtype == torch.float32 and params.dim() >= 2:
        return params.to(dtype)
    return params


def named_leaves(params, prefix="") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf, in sorted key order at each level (the
    order of ``jax.tree.leaves`` on the JAX tree)."""
    if not isinstance(params, dict):
        return [(prefix, params)]
    out = []
    for k in sorted(params):
        out += named_leaves(params[k], f"{prefix}/{k}" if prefix else k)
    return out


def param_leaves(params) -> List[torch.Tensor]:
    """The leaves of ``named_leaves``, for one optimizer parameter group."""
    return [t for _, t in named_leaves(params)]


def make_train_step(cfg: GPT2Config, optimizer):
    """Returns ``train_step(params, batch) -> {"loss": tensor}``.

    ``params`` are the f32 master leaves, each with ``requires_grad``;
    ``optimizer`` is a ``torch.optim.Optimizer`` over them (one group, e.g.
    ``torch.optim.AdamW(param_leaves(params), ...)``).  A step casts the
    tree to ``cfg.compute_dtype`` (``_cast_weights``), runs ``loss_fn``,
    backpropagates through the cast (so the gradients are f32), steps the
    optimizer and clears the gradients.  Unlike the JAX step, which
    returns new parameter and optimizer-state trees, this one updates the
    parameters and the optimizer's state in place."""

    def train_step(params, batch):
        loss = loss_fn(_cast_weights(params, cfg.compute_dtype), batch, cfg)
        loss.backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return {"loss": loss.detach()}

    return train_step


def num_params(params) -> int:
    if isinstance(params, dict):
        return sum(num_params(v) for v in params.values())
    return params.numel()


def count_flops_per_token(cfg: GPT2Config, seq_len: int) -> float:
    """Training (fwd+bwd) FLOPs per token: 6N + 12*L*E*S (PaLM appendix B).

    N counts matmul params only: 12*L*E^2 for the blocks (c_attn 3E^2 +
    attn c_proj E^2 + mlp 8E^2) plus V*E for the tied lm head (the
    embedding gather is not a matmul).  The 6 covers fwd (2) + bwd (4);
    callers must NOT multiply by 3 again.
    """
    n = 12 * cfg.n_layer * cfg.n_embd ** 2 + cfg.vocab_size * cfg.n_embd
    return 6 * n + 12 * cfg.n_layer * cfg.n_embd * seq_len
