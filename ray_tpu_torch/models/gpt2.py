"""GPT-2 in PyTorch — counterpart of ``ray_tpu/models/gpt2.py``.

Parameters are a nested dict of tensors with the JAX package's names
(``wte/embedding``, ``h_{i}/attn/c_attn/kernel``, ...), f32 as there;
matmuls run in ``compute_dtype`` (bf16) with the weights cast per use, as
the JAX model's ``.astype(x.dtype)`` does.  ``params_from_numpy`` carries
a JAX parameter tree across as numpy arrays.

Numerics follow the JAX model step for step: layer-norm statistics in f32
with the population variance, tanh-approximated GELU, the f32 embedding
sum cast to ``compute_dtype``, a final layer norm on f32 input, and a tied
lm head with bf16 operands and f32 logits over the padded vocabulary
(``ops/lm_head.py``: a product of two bf16 values is exact in f32, so a
bf16 GEMM that sums in f32 computes the f32 product of the up-cast
operands; its backward carries the f32 cotangent as two bf16 parts, which
hold it to 2^-16, 256 times below the bf16 rounding of the gradients it
makes).
Attention goes through ``flash_attention_bshd`` (``attention="flash"``,
the CUDA kernel on the card), the plain dense version
(``attention="dense"``), or sequence parallelism over the ``sp`` axis of
the bound mesh (``attention="ring"|"ulysses"``, under ``use_mesh``;
``ray_tpu_torch/parallel/ring_attention.py``).  Under sequence parallelism
each rank runs the model on its own chunk of the sequence (``seq_shard``):
``forward`` gives the rank's logits, the positions are the chunk's global
ones.

Parallelism over ranks, under ``use_mesh``: data parallelism on ``dp``
(each rank its rows, ``batch_shard``), sequence parallelism on ``sp``,
tensor parallelism on ``tp`` and pipeline parallelism on ``pp``, alone or
together.  Under tp (Megatron's split, what GSPMD derives from the JAX
model's "heads", "mlp" and "vocab" rules) each rank holds its
``shard_params`` shard: the heads of ``c_attn`` (cut by heads) and of the
attention's ``c_proj`` rows, the FFN's ``c_fc`` columns and ``c_proj``
rows (the MoE experts' hidden dim), and a block of the rows of ``wte``
and of ``wpe`` (whose name JAX's "vocab" rule matches too).  The input of
each column-parallel product goes through ``c10d.identity`` ("f": its
gradient summed over tp), each row-parallel product is summed over tp by
``c10d.allreduce`` ("g") before its bias, the embedding is each rank's
rows' lookup summed over tp, and the lm head
gives each rank its block of the vocabulary: ``forward`` gathers the
logits, ``loss_fn`` takes a vocabulary-parallel cross-entropy (max, sum
of exponentials and target logit over tp) that never gathers them.  The
flash kernels then run n_head / tp heads.  Under fsdp (the JAX model's
"embed" rule for the parameters, "batch" on (dp, fsdp) for the rows) each
rank holds its ``shard_params`` block of every leaf's "embed" dim and its
rows of the batch; each leaf is gathered whole over fsdp for its use
(``_whole_on_fsdp``, ``c10d.allgather``, whose backward is the
reduce-scatter of the cotangent): a block's leaves inside the block, so
that under remat the gather runs again in the recompute and a layer's
whole weights exist only while it runs (ZeRO-3's memory; without remat
autograd keeps every gathered weight for the backward), wte and wpe once a
step (the embedding and the tied head then sum their cotangents before
wte's one reduce-scatter), a pipeline stage's stacked leaves once a step
before the schedule (the stage sums their cotangents over the
microbatches first).  In training the gathers move the bf16 weights that
``_cast_weights`` made.  Pipeline parallelism on
``pp``: ``to_pipeline_params`` stacks the blocks
into ``blocks`` with a leading layer dim, ``shard_params`` gives each rank
its stage's layers, and ``_trunk`` runs them through
``parallel/pipeline.py``'s ``pipeline_apply`` in ``pp_microbatches``
microbatches (always recomputing each stage in the backward, as the JAX
pipeline's checkpoint does).  ``forward`` gives the rank's rows of logits
(all rows when the microbatches do not divide by the stages), ``loss_fn``
the global mean, and ``make_train_step`` sums each gradient over the ranks
that computed other terms of it, so every replica takes the same step.

``moe_experts > 0`` swaps every block's dense FFN for the top-k routed
mixture of experts (``_moe_mlp``: the reference's capacity dispatch,
computed with index gathers in place of its dense one-hot tensors), whose
Switch load-balancing loss ``loss_fn`` adds.  Over ranks it computes the
reference's function of the global batch: under dp and sp the capacity,
the slot positions and the aux loss count every rank's tokens
(``_moe_route``), though no token leaves its rank; on ``ep`` each rank
holds its ``shard_params`` block of the experts, every ep rank routes the
same tokens and runs its own experts, and their outputs are gathered over
ep before the combine.

Training: ``loss_fn`` (next-token cross-entropy through the dense tied
head, or ``_chunked_xent`` over token chunks with ``xent_chunks > 0``) and
``make_train_step`` (f32 master weights cast once to ``compute_dtype`` per
step, as the JAX ``_cast_weights`` does, and a ``torch.optim`` optimizer
such as AdamW over ``param_leaves``).  ``remat=True`` checkpoints each
block (``torch.utils.checkpoint``), so the backward recomputes it.
Gradients of attention go through the flash backward kernels on the card.

Under pipeline parallelism with dp or fsdp the MoE routes each microbatch
as the reference does: its microbatch m is the global rows [m B/M, (m+1)
B/M), routed with one capacity over that microbatch's tokens, so each rank
first takes its block of every global microbatch's rows
(``_to_microbatch_blocks``: the tokens all-gathered over dp and fsdp, a
local select), and ``forward`` puts the trunk's rows back
(``_from_microbatch_blocks``).  Pipeline stages with ring or Ulysses
attention raise ``NotImplementedError``: the reference's pipelined GPT-2
raises for pp with sp too (ROADMAP.md §A11).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.collective import _all_gather, c10d
from ray_tpu_torch.ops import lm_head
from ray_tpu_torch.ops.flash_attention import (_reference_attention,
                                               flash_attention_bshd)
from ray_tpu_torch.parallel.context import get_mesh, require_mesh, use_mesh
from ray_tpu_torch.parallel.mesh import mesh_axis_size, mesh_shape
from ray_tpu_torch.parallel.pipeline import (pipeline_apply,
                                             stack_layer_params)
from ray_tpu_torch.parallel.ring_attention import ring_attention_sharded
from ray_tpu_torch.parallel.sharding import fsdp_dim
from ray_tpu_torch.util.tracing import region


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50304  # padded to a multiple of 128
    block_size: int = 1024
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    compute_dtype: Any = torch.bfloat16
    attention: str = "flash"  # flash | ring | ulysses | dense
    remat: bool = False       # checkpoint each block (trade FLOPs for memory)
    # MoE: >0 swaps every block's dense FFN for a top-k routed mixture
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.5
    moe_aux_weight: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


GPT2_SMALL = GPT2Config()
GPT2_MEDIUM = GPT2Config(n_layer=24, n_head=16, n_embd=1024)
GPT2_LARGE = GPT2Config(n_layer=36, n_head=20, n_embd=1280)
GPT2_XL = GPT2Config(n_layer=48, n_head=25, n_embd=1600)
GPT2_TINY = GPT2Config(vocab_size=512, block_size=128, n_layer=2, n_head=2,
                       n_embd=64)


_SP = ("ring", "ulysses")


def _check_ported(cfg: GPT2Config):
    if cfg.attention not in ("flash", "dense") + _SP:
        raise ValueError(f"unknown attention {cfg.attention!r}")


def _sp_rank_and_size(cfg: GPT2Config):
    """(rank, ranks) on the bound mesh's sp axis; (0, 1) without sequence
    parallelism."""
    if cfg.attention not in _SP:
        return 0, 1
    mesh = require_mesh()
    n = mesh_axis_size(mesh, "sp")
    return (mesh.get_local_rank("sp") if n > 1 else 0), n


def _axis_rank_and_size(axis: str):
    """(rank, ranks) on the bound mesh's ``axis``; (0, 1) without one."""
    mesh = get_mesh()
    n = mesh_axis_size(mesh, axis) if mesh is not None else 1
    return (mesh.get_local_rank(axis) if n > 1 else 0), n


def _check_mesh(params, cfg: GPT2Config):
    """Raise for what the bound mesh asks that is not ported, and for
    parameters that are not the rank's shard of it."""
    mesh = get_mesh()
    shape = mesh_shape(mesh) if mesh is not None else {}
    fsdp = shape.get("fsdp", 1)
    blocks = params["blocks"] if "blocks" in params else params["h_0"]
    rows = blocks["attn"]["c_attn"]["kernel"].shape[-2]
    if fsdp > 1 and rows * fsdp != cfg.n_embd:
        raise ValueError(
            f"c_attn's kernel holds {rows} rows: n_embd {cfg.n_embd} over "
            f"fsdp {fsdp} needs n_embd / fsdp each (shard_params gives a "
            f"rank its shard)")
    tp = shape.get("tp", 1)
    if cfg.n_head % tp:
        raise ValueError(
            f"n_head {cfg.n_head} does not divide by the tp axis size {tp}")
    rows = params["wte"]["embedding"].shape[0]
    if tp > 1 and rows * tp != cfg.vocab_size:
        raise ValueError(
            f"wte holds {rows} rows: vocab_size {cfg.vocab_size} over tp "
            f"{tp} needs vocab_size / tp each (shard_params gives a rank its "
            f"shard)")
    n, ep = cfg.moe_experts, shape.get("ep", 1)
    if n > 0:
        if n % ep:
            raise ValueError(
                f"moe_experts {n} does not divide by the ep axis size {ep}")
        held = blocks["moe"]["wi"].shape[-3]  # (stage layers,) n, E, 4E
        if held * ep != n:
            raise ValueError(
                f"wi holds {held} experts: moe_experts {n} over ep "
                f"{ep} needs moe_experts / ep each (shard_params gives a "
                f"rank its shard)")
    if "blocks" in params and cfg.attention in _SP:
        # jax 0.9: "The context mesh AbstractMesh(...) should match the mesh
        # passed to shard_map": the ring's shard_map nested in the
        # pipeline's is refused
        raise NotImplementedError(
            "pipeline stages with ring or Ulysses attention: the reference's "
            "pipelined GPT-2 raises for pp composed with sp too (ROADMAP.md "
            "§A11)")


def _loss_axes(params, cfg: GPT2Config) -> List[Tuple[str, int]]:
    """[(axis, size)] of the bound mesh's axes whose ranks hold other terms
    of the loss: dp and fsdp (other rows), sp under ring/Ulysses attention
    (other positions) and pp for pipeline-stacked ``blocks`` (other rows, or
    a share of the replicated head).  Sizes of 1 are left out."""
    mesh = get_mesh()
    if mesh is None:
        return []
    shape = mesh_shape(mesh)
    names = ["dp", "fsdp"] + (["pp"] if "blocks" in params else []) + (
        ["sp"] if cfg.attention in _SP else [])
    return [(a, shape[a]) for a in names if shape.get(a, 1) > 1]


def init_params(generator: torch.Generator, cfg: GPT2Config,
                device="cuda") -> Dict[str, Any]:
    """Random f32 parameters with the JAX initialiser's distributions
    (normal std 0.02, wpe 0.01, residual projections 0.02/sqrt(2L), zero
    biases, unit LN scales; with ``moe_experts`` an ``moe`` FFN of a
    router and stacked expert weights in place of ``mlp``).  ``generator``
    draws every tensor on its own device; the result lives on
    ``device``."""
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
    n = cfg.moe_experts
    for i in range(cfg.n_layer):
        block = {
            "ln_1": {"scale": ones(E), "bias": zeros(E)},
            "attn": {
                "c_attn": {"kernel": normal((E, 3 * E)),
                           "bias": zeros(3 * E)},
                "c_proj": {"kernel": normal((E, E), proj_std),
                           "bias": zeros(E)},
            },
            "ln_2": {"scale": ones(E), "bias": zeros(E)},
        }
        if n > 0:
            block["moe"] = {
                "router": {"kernel": normal((E, n))},
                "wi": normal((n, E, 4 * E)),
                "wo": normal((n, 4 * E, E), proj_std),
            }
        else:
            block["mlp"] = {
                "c_fc": {"kernel": normal((E, 4 * E)), "bias": zeros(4 * E)},
                "c_proj": {"kernel": normal((4 * E, E), proj_std),
                           "bias": zeros(E)},
            }
        params[f"h_{i}"] = block
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


def _with_mesh(mesh, fn):
    """``fn`` that runs with ``mesh`` bound.  A recompute in the backward (a
    checkpointed block or chunk, a pipeline stage) runs on autograd's
    device thread when its tensors are on a card, where the caller's
    binding, which is thread-local, is not seen."""
    def run(*args):
        with use_mesh(mesh):
            return fn(*args)

    return run


def _whole_on_fsdp(tree, path=()):
    """A parameter (sub)tree at ``path`` with each leaf that ``shard_params``
    cut on fsdp (``fsdp_dim``) all-gathered whole over the bound mesh's
    fsdp axis (``c10d.allgather``), the others as they are.  The gather's
    backward is the reduce-scatter of the whole leaf's cotangent: each rank
    keeps its block of the sum over fsdp, the gradient of its shard summed
    over the fsdp ranks' rows.  Without fsdp the tree itself."""
    if _axis_rank_and_size("fsdp")[1] == 1:
        return tree

    def whole(node, at):
        if isinstance(node, dict):
            return {k: whole(v, at + (k,)) for k, v in node.items()}
        dim = fsdp_dim(at, tuple(node.shape))
        return node if dim is None else c10d.allgather(node, "fsdp", dim)

    return whole(tree, path)


def _copy_to_tp(x, tp: int):
    """Megatron's "f": x for work cut over tp, its gradient summed there."""
    return c10d.identity(x, "tp") if tp > 1 else x


def _column_shard(p, rank: int, tp: int, fused_qkv: bool = False):
    """A column-parallel linear's kernel (already the rank's columns) and
    the rank's slice of its whole bias: the same head-order block of each
    of q, k and v for the fused ``c_attn``, a contiguous block otherwise.
    The bias's gradient is then zero outside the slice (``_sum_grads``
    sums it over tp)."""
    if tp == 1:
        return p
    b = p["bias"]
    b = (b.view(3, tp, -1)[:, rank].reshape(-1) if fused_qkv
         else b.view(tp, -1)[rank])
    return {"kernel": p["kernel"], "bias": b}


def _row_linear(x, p, tp: int):
    """A row-parallel linear: the rank's rows of the kernel against x's
    columns, summed over tp ("g"), then the bias, once.  As GSPMD
    partitions the JAX model's bf16 dot, each rank's partial product is
    rounded to x's dtype and the partials are summed in it (gloo sums in
    the tensor's dtype): that rounds otherwise than the unsharded product
    does, which the tests hold within their tolerances, not bit for bit.
    At tp = 1 it is ``_linear``."""
    y = x @ p["kernel"].to(x.dtype)
    if tp > 1:
        y = c10d.allreduce(y, "tp")
    return y + p["bias"].to(x.dtype)


def _attention(x, p, cfg: GPT2Config):
    B, S, _ = x.shape
    rank, tp = _axis_rank_and_size("tp")
    H, D = cfg.n_head // tp, cfg.head_dim  # the rank's heads
    qkv = _linear(_copy_to_tp(x, tp), _column_shard(p["c_attn"], rank, tp,
                                                    fused_qkv=True))
    q, k, v = (t.reshape(B, S, H, D) for t in qkv.split(H * D, dim=-1))
    tr = lambda t: t.transpose(1, 2)  # noqa: E731
    if cfg.attention in _SP:
        # head-major views for the ring's (B, H, Sq, D) chunks: no copy,
        # the kernels read strides
        o = tr(ring_attention_sharded(tr(q), tr(k), tr(v), require_mesh(),
                                      causal=True, variant=cfg.attention))
    elif cfg.attention == "dense":
        o, _ = _reference_attention(tr(q), tr(k), tr(v), D ** -0.5, True)
        o = tr(o.to(x.dtype))
    else:
        # strided views of qkv go straight to the kernel: no transposes
        o = flash_attention_bshd(q, k, v, True)
    return _row_linear(o.reshape(B, S, H * D), p["c_proj"], tp)


def _mlp(x, p):
    rank, tp = _axis_rank_and_size("tp")
    h = F.gelu(_linear(_copy_to_tp(x, tp), _column_shard(p["c_fc"], rank,
                                                         tp)),
               approximate="tanh")
    return _row_linear(h, p["c_proj"], tp)


class _RowGather(torch.autograd.Function):
    """``out = src[fwd_idx]`` over rows, where index ``len(src)`` reads a
    zero row, with a backward that is a gather too: ``bwd_idx`` maps each
    row of ``src`` to the rows of ``out`` copied from it (the row count of
    ``out`` where there is none), and a row's gradient is the f32 sum of
    theirs, rounded once, as the reference's one-hot einsum accumulates
    it.  No scatter, so no atomics and no order among them."""

    @staticmethod
    def forward(ctx, src, fwd_idx, bwd_idx):
        ctx.save_for_backward(bwd_idx)
        return _pad_row(src)[fwd_idx]

    @staticmethod
    def backward(ctx, grad):
        (bwd_idx,) = ctx.saved_tensors
        g = _pad_row(grad.reshape(-1, grad.shape[-1]))[bwd_idx]
        if bwd_idx.dim() == 2:
            g = g.float().sum(1).to(grad.dtype)
        return g, None, None


def _pad_row(x):
    return torch.cat([x, x.new_zeros((1, x.shape[-1]))])


def _top_k(probs, k):
    """Indices of each row's k largest entries, largest first and ties to
    the lower index, as ``jax.lax.top_k`` orders them (``torch.topk``
    promises no order among ties on CUDA; a stable sort does)."""
    return torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :k]


def _token_axes(cfg: GPT2Config) -> List[Tuple[str, int]]:
    """[(axis, size)] of the bound mesh's axes over which the global
    batch's tokens are spread: dp and fsdp (rows, ``batch_shard``) and,
    under ring or Ulysses attention, sp (positions, ``seq_shard``).  Sizes
    of 1 are left out."""
    mesh = get_mesh()
    if mesh is None:
        return []
    shape = mesh_shape(mesh)
    names = ["dp", "fsdp"] + (["sp"] if cfg.attention in _SP else [])
    return [(a, shape[a]) for a in names if shape.get(a, 1) > 1]


def _batch_block() -> int:
    """The rank's block of the "batch" rule's (dp, fsdp) blocks, dp major:
    ``batch_shard``'s d n_fsdp + f."""
    d, _ = _axis_rank_and_size("dp")
    f, n_fsdp = _axis_rank_and_size("fsdp")
    return d * n_fsdp + f


def _regroups(params, cfg: GPT2Config) -> bool:
    """Whether a pipelined MoE's rows must be regrouped over the ranks: the
    reference's microbatches are blocks of the global rows, routed over
    every dp and fsdp rank's share of them."""
    return (cfg.moe_experts > 0 and "blocks" in params
            and any(a in ("dp", "fsdp") for a, _ in _token_axes(cfg)))


def _gather_rows(x):
    """x's leading blocks on every (dp, fsdp) rank, concatenated in
    ``batch_shard``'s block order: gathered over fsdp, then dp
    (``c10d.allgather``: its backward is the reduce-scatter)."""
    for axis in ("fsdp", "dp"):
        if _axis_rank_and_size(axis)[1] > 1:
            x = c10d.allgather(x, axis, 0)
    return x


def _to_microbatch_blocks(tokens, M: int):
    """The rank's ``batch_shard`` rows (Bl of B = n Bl over the n (dp,
    fsdp) ranks) -> its block b of each of the M global microbatches: rows
    [m B/M + b Bl/M, m B/M + (b+1) Bl/M) for every m, in order.  The
    reference's pipeline cuts the global batch into microbatches of
    contiguous rows and routes each over every rank's share of it; after
    this, the rank's microbatch m is its block of global microbatch m, and
    ``_routes`` orders the blocks as the reference orders those rows.  The
    tokens (integers, a few hundred kB) cross the ranks, not
    activations."""
    rows = tokens.shape[0]
    if rows % M:
        raise ValueError(f"batch {rows} not divisible by num_microbatches "
                         f"{M}")
    every = _gather_rows(tokens)
    n = every.shape[0] // rows
    return every.view(M, n, rows // M, *tokens.shape[1:])[
        :, _batch_block()].reshape(tokens.shape)


def _from_microbatch_blocks(x, M: int):
    """The trunk's output rows of ``_to_microbatch_blocks``' grouping (the
    rank's stage part of them when the pipeline cut its output over pp) ->
    the rows a dense model's trunk gives the rank: its ``batch_shard``
    rows, and their stage part.  The rows are all-gathered over pp and
    (dp, fsdp) (``c10d.allgather``, whose backward is the reduce-scatter:
    each row's cotangent goes back to the rank that computed it) and the
    rank's selected."""
    mesh = require_mesh()
    pp = mesh_axis_size(mesh, "pp")
    cut = pp > 1 and M % pp == 0
    if cut:
        x = c10d.allgather(x, "pp", 0)
    rows = x.shape[0]                          # the rank's regrouped rows
    every = _gather_rows(x)
    n = every.shape[0] // rows
    tail = x.shape[1:]
    whole = every.view(n, M, rows // M, *tail).transpose(0, 1).reshape(
        -1, *tail)                             # the global rows, in order
    mine = whole.view(n, rows, *tail)[_batch_block()]
    if cut:
        mine = mine.view(pp, -1, *tail)[mesh.get_local_rank("pp")]
    return mine


class _Routes(NamedTuple):
    probs: torch.Tensor   # (T, n) f32 router probabilities
    gate: torch.Tensor    # (T, k) f32 gate values
    idx: torch.Tensor     # (T, k) expert choices
    pos: torch.Tensor     # (T, k) slots in the global order
    capacity: int         # slots an expert, over the global tokens
    local: torch.Tensor   # (T, k) slots among the rank's own choices
    first: torch.Tensor   # (n,) global count of choice 0 of each expert
    tokens: int           # global token count


def _routes(xt, router, cfg: GPT2Config, rows: int) -> _Routes:
    """``_moe_route``'s work, with what ``_moe_mlp`` also needs: each
    choice's slot among the rank's own choices and the global count of
    choice 0 per expert."""
    T = xt.shape[0]
    k, n = cfg.moe_top_k, cfg.moe_experts
    probs = torch.softmax((xt @ router.to(xt.dtype)).float(), dim=-1)
    idx = _top_k(probs, k)
    gate = probs.gather(1, idx)
    gate = gate / (gate.sum(-1, keepdim=True) + 1e-9)
    axes = _token_axes(cfg)
    tokens = T * math.prod(size for _, size in axes)
    capacity = max(k, int(cfg.moe_capacity_factor * tokens * k / n))
    # (k, n, rows, S), tokens innermost: a cumsum over the outer dim of
    # (T, k, n) scans 16 columns of 16,384 rows, 14% of the MoE train step
    # at B=16, S=1024 on an H100
    onehot = F.one_hot(idx.T, n).transpose(1, 2).contiguous().view(
        k, n, rows, T // rows)
    within = (onehot.cumsum(-1) - 1).view(k, n, T).gather(
        1, idx.T[:, None])[:, 0]                                # (k, T)
    tok = idx.T.reshape(k, rows, -1)

    def slots(counts, d, r):
        """Each choice's slot, given the (row blocks, n_sp, rows, k, n)
        counts of every chunk (a row's positions on one rank) and this
        rank's block d and sp rank r: chunks run in global token order (the
        blocks, row major, then the sp ranks' chunks of the row), choice 0
        of every token first."""
        flat = counts.transpose(1, 2).reshape(-1, k, n)
        total = flat.sum(0)
        before = (flat.cumsum(0) - flat).view(
            counts.shape[0], rows, counts.shape[1], k, n)[d, :, r]
        off = before + (total.cumsum(0) - total)                # (rows, k, n)
        return (within + off.permute(1, 0, 2).gather(2, tok).reshape(k, T)
                ).T, total

    mine = onehot.sum(-1).permute(2, 0, 1)[None, None]   # (1, 1, rows, k, n)
    local, total = slots(mine, 0, 0)
    pos, r = local, 0
    if axes:
        mesh, spread = require_mesh(), dict(axes)
        every = mine[0]
        if "sp" in spread:
            every = _all_gather(every, mesh.get_group("sp"), 0)
            r = mesh.get_local_rank("sp")
        # the rows' blocks in batch_shard's order: block d n_fsdp + f
        pos, total = slots(_gather_rows(every[None]), _batch_block(), r)
    return _Routes(probs, gate, idx, pos, capacity, local, total[0], tokens)


def _moe_route(xt, router, cfg: GPT2Config, rows: int = 1):
    """Top-k routing with capacity, as the reference computes it.  xt (T,
    E) -> (probs (T, n) f32, gate (T, k) f32, idx (T, k), pos (T, k),
    capacity): each token's experts in order of probability (ties: lower
    index first, as ``jax.lax.top_k``), their gate values divided by their
    sum + 1e-9, and each choice's slot in its expert's buffer.  Slots go to
    choice 0 of every token in token order, then choice 1, ...: a choice's
    position counts the earlier tokens with the same expert at that choice
    and every token's earlier choices of it.

    Over ranks (``_token_axes``: dp and fsdp, and sp under ring or
    Ulysses) xt is the rank's ``rows`` rows of tokens (each its positions
    of a row) and the routing is the reference's over the global batch, of
    T x ranks tokens in the order t = b S + s: the capacity counts every
    token, and a position counts every earlier token of the global order.
    Each rank counts its choices per (row, choice, expert), all-gathers
    those counts over sp, fsdp and dp (a few kB, integers) and takes the
    exclusive prefix of every chunk's counts in global order: under dp and
    fsdp a rank's rows follow the earlier ranks' rows (``batch_shard``'s
    blocks, dp major), under sp the ranks' chunks of each row interleave
    row by row.  Without such axes ``rows`` changes nothing."""
    return _routes(xt, router, cfg, rows)[:5]


def _moe_mlp(x, p, cfg: GPT2Config):
    """Top-k routed mixture-of-experts FFN (the reference's GShard/Switch
    capacity dispatch) -> (y, aux load-balancing loss).  A choice past its
    expert's capacity is dropped (no renormalisation; a token with every
    choice dropped gets y = 0).  The reference builds (T, k, n, C) one-hot
    dispatch and combine tensors (6.4 GB a layer at B=16, S=1024, 8
    experts); here the same function runs on index maps: each expert's
    buffer gets its tokens' rows copied exactly (empty slots zero), the
    expert products are batched matmuls over every slot as there, and
    each token sums its kept choices' outputs, weighted by the gate value
    rounded to ``x.dtype``.

    Over dp, fsdp and sp ranks (``_moe_route``) the capacity, the positions
    and the aux are global, but no token crosses ranks: the expert FFN works
    row by row, so a rank computes its own kept choices only.  A rank's
    buffer holds C = min(capacity, T k) slots an expert (T: the rank's
    tokens), a number it knows without a host sync: its kept choices of an
    expert come first in its own order, so each takes the slot of its
    position among the rank's choices (``_Routes.local``), and there are at
    most T k of them.  At B=16, S=1024 over dp = 2 that is the capacity
    itself, as on one rank.  The aux's ``frac`` comes from the choice-0
    counts summed over the ranks (integers, no gradient), its
    ``importance`` from the rank's probability sums summed with
    ``c10d.allreduce``, whose backward hands each rank the whole
    cotangent: each rank gets its own tokens' share of the router
    gradient, and ``_sum_grads``' sum over dp, fsdp and sp makes it whole.

    Under tp the experts' hidden dim is cut (``wi``'s columns, ``wo``'s
    rows) and the router is whole: x is the same on every tp rank, so
    every rank routes the same tokens to the same slots, the expert
    products are local and their outputs are summed over tp ("g") before
    the combine.  Under ep each rank holds n / ep experts (the leading dim
    of ``wi``/``wo``); x is the same on every ep rank, which routes as
    every other, fills and runs its experts' buffers, and all-gathers the
    (n / ep C, E) outputs over ep (after the tp sum) into the whole (n C,
    E), whose backward hands each rank its own block of the cotangent
    (``_GatherWhole``: the loss is the same on every ep rank, so a
    reduce-scatter would count it ep times).  Nothing after the gather is
    partial, so the gate values, the router and the aux need no sum; the
    (T, E) combined output, summed over ep and tp, would be a third of the
    bytes but would leave the gate values' and the router's gradients
    partial.  The tokens enter the expert products through "f" over tp and
    ep (each rank adds the cotangent of its own experts' rows and hidden
    columns), the router's input does not."""
    B, S, E = x.shape
    T = B * S
    k, n = cfg.moe_top_k, cfg.moe_experts
    _, tp = _axis_rank_and_size("tp")
    ep_rank, ep = _axis_rank_and_size("ep")
    xt = x.reshape(T, E)
    r = _routes(xt, p["router"]["kernel"], cfg, B)
    keep = r.pos < r.capacity
    C = min(r.capacity, T * k)
    slot = torch.where(keep, r.idx * C + r.local, n * C)       # (T, k)
    # the choice (t * k + j) each slot holds, T * k where it is empty
    owner = torch.full((n * C + 1,), T * k, dtype=slot.dtype,
                       device=x.device)
    owner[slot.reshape(-1)] = torch.arange(T * k, device=x.device)
    owner = owner[:n * C]
    m = n // ep                                  # the rank's experts
    lo = ep_rank * m * C
    mine = torch.where((slot >= lo) & (slot < lo + m * C), slot - lo, m * C)
    xe = _copy_to_tp(xt, tp)
    if ep > 1:
        xe = c10d.identity(xe, "ep")
    expert_in = _RowGather.apply(xe, owner[lo:lo + m * C] // k,
                                 mine)                          # (mC, E)
    h = F.gelu(torch.bmm(expert_in.view(m, C, E), p["wi"].to(x.dtype)),
               approximate="tanh")
    out = torch.bmm(h, p["wo"].to(x.dtype))
    if tp > 1:
        out = c10d.allreduce(out, "tp")
    out = out.view(m * C, E)
    if ep > 1:
        out = _GatherWhole.apply(out, require_mesh().get_group("ep"), 0)
    picked = _RowGather.apply(out, slot, owner)                 # (T, k, E)
    weight = (r.gate * keep).to(x.dtype)
    y = (picked.float() * weight.float()[..., None]).sum(1).to(x.dtype)
    # load-balancing aux (Switch eq. 4): fraction routed x router prob,
    # both means over the global tokens
    importance = r.probs.sum(0)
    for axis, _ in _token_axes(cfg):
        importance = c10d.allreduce(importance, axis)
    frac = r.first.float() / r.tokens
    aux = n * (frac * (importance / r.tokens)).sum()
    return y.reshape(B, S, E), aux


def _block(x, p, cfg: GPT2Config, aux_acc=None):
    x = x + _attention(_layer_norm(x, p["ln_1"]), p["attn"], cfg)
    if "moe" in p:
        y, aux = _moe_mlp(_layer_norm(x, p["ln_2"]), p["moe"], cfg)
        if aux_acc is not None:
            aux_acc.append(aux)
        return x + y
    return x + _mlp(_layer_norm(x, p["ln_2"]), p["mlp"])


def _block_with_aux(x, p, cfg: GPT2Config):
    acc: list = []
    x = _block(x, p, cfg, acc)
    return x, (acc[0] if acc else torch.zeros((), device=x.device))


def _layer(x, p, cfg: GPT2Config):
    """``_block_with_aux`` on the layer's parameters gathered whole over
    fsdp: under ``checkpoint`` the gather runs again in the recompute, so
    the layer's whole weights are not kept between its forward and its
    backward."""
    return _block_with_aux(x, _whole_on_fsdp(p), cfg)


def to_pipeline_params(params, cfg: GPT2Config):
    """Stack the per-layer blocks into one leading-layer-dim tree,
    ``blocks`` (the "stage" axis ``shard_params`` places on pp); the other
    params pass through.  Use with ``forward``/``make_train_step`` under a
    mesh whose pp axis > 1, after ``shard_params``."""
    out = {k: v for k, v in params.items() if not k.startswith("h_")}
    out["blocks"] = stack_layer_params(
        [params[f"h_{i}"] for i in range(cfg.n_layer)])
    return out


def _trunk(params, tokens, cfg: GPT2Config, aux_acc=None,
           pp_microbatches: int = 2):
    """Embedding + transformer blocks + final LN -> (B, S, E) in
    compute_dtype.  The embedding sum runs in the dtype of the tables: f32
    when serving, ``compute_dtype`` in training, where ``_cast_weights``
    has cast them, as in the JAX model.  MoE blocks append their aux loss
    to ``aux_acc``.  With ``cfg.remat`` each block runs under
    ``checkpoint``: its activations are dropped after the forward and
    recomputed in the backward (the flash forward kernel runs again).
    Under sequence parallelism ``tokens`` are the rank's chunk: rank r of
    n holds positions [r*S, (r+1)*S) of a sequence of n*S.  With stacked
    ``blocks`` (the rank's stage of ``to_pipeline_params``'s tree, cut by
    ``shard_params``) the blocks run as a pipeline over the bound mesh's pp
    axis in ``pp_microbatches`` microbatches, each stage recomputed in the
    backward whatever ``cfg.remat`` says; the MoE aux rides the stage
    handoff, and ``pp_aux / n_layer`` (the mean over layers of each
    layer's mean over microbatches) goes to ``aux_acc``.  The result is the
    rank's rows when the microbatches divide by the stages, else every
    row.  Under tp the embedding tables are the rank's blocks of their
    rows (``_embed``); under fsdp they are whole (``_whole_tables``) and
    each block's leaves are gathered for its use: a layer's inside the
    layer (``_layer``), a stage's stacked ones before the schedule."""
    S = tokens.shape[1]
    rank, n = _sp_rank_and_size(cfg)
    if S * n > cfg.block_size:
        raise ValueError(
            f"sequence of {S * n} tokens exceeds block_size {cfg.block_size}")
    x = _embed(params["wte"]["embedding"], params["wpe"]["embedding"],
               tokens, rank * S)
    x = x.to(cfg.compute_dtype)
    mesh = get_mesh()
    if "blocks" in params:
        mesh = require_mesh()
        stages = mesh_axis_size(mesh, "pp")
        local = params["blocks"]["ln_1"]["scale"].shape[0]
        if local * stages != cfg.n_layer:
            raise ValueError(
                f"the stage holds {local} stacked layers: n_layer "
                f"{cfg.n_layer} over pp {stages} needs n_layer / pp each "
                f"(shard_params gives a rank its stage)")
        block = _with_mesh(mesh, _block_with_aux)
        x, pp_aux = pipeline_apply(lambda p, h: block(h, p, cfg),
                                   _whole_on_fsdp(params["blocks"],
                                                  ("blocks",)),
                                   x, mesh, pp_microbatches)
        if aux_acc is not None and cfg.moe_experts > 0:
            aux_acc.append(pp_aux / cfg.n_layer)
    else:
        layer = _with_mesh(mesh, _layer)
        for i in range(cfg.n_layer):
            if cfg.remat:
                # the blocks draw no random numbers: no RNG state to restore
                x, aux = checkpoint(layer, x, params[f"h_{i}"], cfg,
                                    use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                x, aux = layer(x, params[f"h_{i}"], cfg)
            if aux_acc is not None and cfg.moe_experts > 0:
                aux_acc.append(aux)
    x = _layer_norm(x.float(), params["ln_f"])
    return x.to(cfg.compute_dtype)


def _whole_tables(params, cfg: GPT2Config):
    """Check the mesh and the parameters (``_check_mesh``), then gather wte
    and wpe whole over fsdp, once a step: wte's two uses, the embedding and
    the tied head, then sum their cotangents before its one
    reduce-scatter."""
    _check_ported(cfg)
    _check_mesh(params, cfg)
    return {**params, **{k: _whole_on_fsdp(params[k], (k,))
                         for k in ("wte", "wpe")}}


def _rows_in_block(table, idx, rank):
    """``table[idx]`` where ``table`` holds rank's block of the rows of a
    whole table, zeros where idx lies outside it."""
    rows = table.shape[0]
    local = idx - rank * rows
    inside = (local >= 0) & (local < rows)
    return torch.where(inside[..., None], table[local.clamp(0, rows - 1)], 0)


def _embed(wte, wpe, tokens, start: int):
    """``wte[tokens]`` plus the positions [start, start + S) of ``wpe``, in
    the tables' dtype.  Under tp JAX's rules cut both tables' rows ("vocab":
    wpe's name matches it too), and each rank adds the rows of its blocks,
    zeros for the others; the sum over tp ("g") has at most a token's and a
    position's row as nonzero terms, so it rounds their sum once: the whole
    lookup bit for bit."""
    rank, tp = _axis_rank_and_size("tp")
    S = tokens.shape[-1]
    if tp == 1:
        return wte[tokens] + wpe[start:start + S][None]
    pos = torch.arange(start, start + S, device=tokens.device)
    return c10d.allreduce(_rows_in_block(wte, tokens, rank)
                          + _rows_in_block(wpe, pos, rank)[None], "tp")


class _GatherWhole(torch.autograd.Function):
    """The ranks' blocks side by side along ``dim`` (the tp ranks' blocks
    of the logits' vocabulary, the ep ranks' expert outputs): a value every
    rank holds whole, so each rank's block takes its own part of the
    (whole, same) cotangent, as ``_AllReduce`` hands its input the
    cotangent whole."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.rank, ctx.n, ctx.dim = group.rank(), group.size(), dim
        return _all_gather(x, group, dim)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return g.chunk(ctx.n, ctx.dim)[ctx.rank], None, None


#: calls of the tied lm head by path (``head_path_counts``): "bf16_parts"
#: where both operands are bf16 (``lm_head.tied_head``), "f32" otherwise
_HEAD_PATHS = {"bf16_parts": 0, "f32": 0}


def head_path_counts(reset: bool = False) -> Dict[str, int]:
    """The lm head's calls by path since the last reset (a chunked loss
    counts each chunk, and again in its recompute); ``reset`` zeroes them
    after reading."""
    out = dict(_HEAD_PATHS)
    if reset:
        _HEAD_PATHS.update(dict.fromkeys(_HEAD_PATHS, 0))
    return out


def _lm_head(x, wte, v=None):
    """The tied lm head: compute-dtype operands, f32 logits, not rounded
    to bf16 (which would tie argmaxes that the JAX model separates).  bf16
    operands take ``lm_head.tied_head``: bf16 GEMMs with f32 sums, the
    same products as the f32 GEMM of the up-cast operands, and a backward
    over the f32 cotangent's two bf16 parts.  Other operands (the f32
    configurations) are multiplied in f32, which needs TF32 off
    (``torch.backends.cuda.matmul.allow_tf32 = False``, the default).
    ``v``: the vocabulary, where wte's rows past it are a zero pad
    (``_chunked_xent``'s); by default all of wte's rows."""
    v = wte.shape[0] if v is None else v
    if x.dtype == wte.dtype == torch.bfloat16:
        _HEAD_PATHS["bf16_parts"] += 1
        return lm_head.tied_head(x, wte, v)
    _HEAD_PATHS["f32"] += 1
    return torch.matmul(x.float(), wte[:v].float().T)


def forward(params, tokens, cfg: GPT2Config, aux_acc=None,
            pp_microbatches: int = 2):
    """tokens (B, S) int64 -> logits (B, S, vocab) f32 (under sequence
    parallelism: the rank's chunk of tokens and of logits; with pipeline
    ``blocks``: the rank's rows, or every row when ``pp_microbatches`` does
    not divide by the pp axis).  Under tp each rank's head gives its block
    of the vocabulary, and the blocks are gathered over tp: every tp rank
    returns the whole vocabulary.  Under fsdp: the rank's rows.  A pipelined
    MoE over dp or fsdp runs the rank's block of each global microbatch
    (``_to_microbatch_blocks``) and returns its own rows all the same."""
    params = _whole_tables(params, cfg)
    regroup = _regroups(params, cfg)
    if regroup:
        tokens = _to_microbatch_blocks(tokens, pp_microbatches)
    with region("gpt2.trunk"):
        x = _trunk(params, tokens, cfg, aux_acc, pp_microbatches)
    if regroup:
        x = _from_microbatch_blocks(x, pp_microbatches)
    _, tp = _axis_rank_and_size("tp")
    with region("gpt2.head"):
        logits = _lm_head(_copy_to_tp(x, tp),
                          params["wte"]["embedding"].to(cfg.compute_dtype))
        if tp > 1:
            logits = _GatherWhole.apply(
                logits, require_mesh().get_group("tp"), logits.dim() - 1)
    return logits


def _xent_terms(logits, targets, vocab_lo=None):
    """lse - target logit of each row of f32 logits.  ``vocab_lo`` (under
    tp): the logits are the rank's block of the vocabulary, which starts
    there, and the terms come from the blocks of every tp rank without
    gathering them: the max over tp (no gradient), the sum of exp(l - max)
    summed over tp ("g"), and the target's logit from the rank whose block
    holds it, zeros elsewhere, summed over tp."""
    if vocab_lo is None:
        lse = torch.logsumexp(logits, dim=-1)
        return lse - logits.gather(-1, targets[..., None])[..., 0]
    V = logits.shape[-1]
    m = c10d.allreduce(logits.detach().amax(-1), "tp", op="max")
    lse = m + torch.log(c10d.allreduce(
        torch.exp(logits - m[..., None]).sum(-1), "tp"))
    local = targets - vocab_lo
    inside = (local >= 0) & (local < V)
    tgt = logits.gather(-1, local.clamp(0, V - 1)[..., None])[..., 0]
    return lse - c10d.allreduce(torch.where(inside, tgt, 0.0), "tp")


def _xent_sum(x, wte, targets, vocab_lo=None, v=None):
    """Summed cross-entropy of one chunk: ``_lm_head``'s f32 logits (of
    wte's first ``v`` rows), then ``_xent_terms``."""
    return _xent_terms(_lm_head(x, wte, v), targets, vocab_lo).sum()


def _chunked_xent(x, wte, targets, n_chunks: int, vocab_lo=None):
    """Linear + softmax cross-entropy over token chunks, each under
    ``checkpoint``: the backward recomputes a chunk's logits and contracts
    them at once, so the (N, V) f32 logits never exist (3.3 GB at B=16,
    S=1024).  x: (N, E) compute dtype; wte: (V, E) compute dtype, which
    each chunk's head takes as it is (no f32 copy; in bf16 padded with
    zero rows once for every chunk, ``lm_head.pad_rows``), so each chunk's
    gradient of wte is rounded to its dtype and summed in it, as the
    reference's scan sums them; targets: (N,).  The chunk count falls to
    the nearest divisor of N, as in the reference.
    Under tp (``vocab_lo``: ``_xent_terms``) each chunk's collectives run
    again in its recompute, in the same order on every rank.  Returns the
    summed loss (f32)."""
    N, V = x.shape[0], wte.shape[0]
    n_chunks = max(1, min(n_chunks, N))
    while N % n_chunks:
        n_chunks -= 1
    if x.dtype == wte.dtype == torch.bfloat16:
        wte = lm_head.pad_rows(wte, lm_head.padded_vocab(V))
    xent_sum = _with_mesh(get_mesh(), _xent_sum)
    total = torch.zeros((), device=x.device)
    for xi, ti in zip(x.chunk(n_chunks), targets.chunk(n_chunks)):
        total = total + checkpoint(xent_sum, xi, wte, ti, vocab_lo, V,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
    return total


def loss_fn(params, batch, cfg: GPT2Config, pp_microbatches: int = 2,
            xent_chunks: int = 0):
    """batch: {"tokens": (B, S+1) int64} -> mean next-token cross-entropy
    (f32 scalar) through the tied head's f32 logits (``_lm_head``: with
    bf16 compute, bf16 GEMMs that sum in f32 and a backward over the
    cotangent's two bf16 parts), plus ``moe_aux_weight`` x the mean of
    the blocks' load-balancing losses for a mixture.
    ``xent_chunks > 0`` takes ``_chunked_xent``, which never holds the
    (B, S, V) logits.

    Over ranks (``_loss_axes``: dp, fsdp, sp, pp) the batch is the rank's
    part (``batch_shard`` on dp and fsdp, ``seq_shard(tokens, mesh,
    overlap=1)`` on sp) and the loss is the global mean on every rank: each
    rank's share, its sum over the rows it holds divided by its token count
    times the ranks of those axes, all-reduced over each of them.  The
    gradient a rank gets is that of its share.  A pipeline whose
    microbatches do not divide by the stages gives every stage all rows,
    and each stage's share is then 1/pp of their sum (``pipeline_apply``
    sums the stages' cotangents back onto the last stage's output).  The
    MoE aux is the same global value on every rank and is added once,
    after the all-reduce.  A pipelined MoE over dp or fsdp takes the
    rank's block of each global microbatch first (``_to_microbatch_blocks``;
    the targets follow their inputs' rows).
    Under tp the loss is a vocabulary-parallel cross-entropy
    (``_xent_terms``), the same on every tp rank; tp holds no other terms
    of it.  The trunk runs in the ``region`` ``gpt2.trunk``, the head and
    its cross-entropy terms in ``gpt2.head`` (as in ``forward``)."""
    tokens = batch["tokens"]
    params = _whole_tables(params, cfg)
    if _regroups(params, cfg):
        # the loss is a sum over rows: the targets follow the inputs' rows
        tokens = _to_microbatch_blocks(tokens, pp_microbatches)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    aux_acc: list = []
    with region("gpt2.trunk"):
        x = _trunk(params, inputs, cfg, aux_acc, pp_microbatches)
    B, S, E = x.shape
    if B != targets.shape[0]:  # the rank's rows of the pipeline's output
        targets = targets.reshape(-1, B, S)[
            require_mesh().get_local_rank("pp")]
    axes = _loss_axes(params, cfg)
    ranks = math.prod(size for _, size in axes)
    tp_rank, tp = _axis_rank_and_size("tp")
    with region("gpt2.head"):
        wte = params["wte"]["embedding"].to(cfg.compute_dtype)
        x = _copy_to_tp(x, tp)
        vocab_lo = tp_rank * wte.shape[0] if tp > 1 else None
        if xent_chunks > 0:
            loss = _chunked_xent(x.reshape(B * S, E), wte,
                                 targets.reshape(B * S), xent_chunks,
                                 vocab_lo) / (B * S * ranks)
        else:
            terms = _xent_terms(_lm_head(x, wte), targets, vocab_lo)
            loss = (terms.mean() if ranks == 1
                    else terms.sum() / (B * S * ranks))
    for axis, _ in axes:
        loss = c10d.allreduce(loss, axis)
    if aux_acc:
        loss = loss + cfg.moe_aux_weight * sum(aux_acc) / len(aux_acc)
    return loss


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


def make_train_step(cfg: GPT2Config, optimizer, pp_microbatches: int = 2,
                    xent_chunks: int = 0):
    """Returns ``train_step(params, batch) -> {"loss": tensor}``.

    ``params`` are the f32 master leaves, each with ``requires_grad``;
    ``optimizer`` is a ``torch.optim.Optimizer`` over them (one group, e.g.
    ``torch.optim.AdamW(param_leaves(params), ...)``).  A step casts the
    tree to ``cfg.compute_dtype`` (``_cast_weights``), runs ``loss_fn``,
    backpropagates through the cast (so the gradients are f32), steps the
    optimizer and clears the gradients.  Unlike the JAX step, which
    returns new parameter and optimizer-state trees, this one updates the
    parameters and the optimizer's state in place.  ``pp_microbatches``
    and ``xent_chunks`` go to ``loss_fn``.  Over ranks (``batch`` is the
    rank's part) every gradient is summed over the ranks that computed
    other terms of it before the optimizer's step (``_sum_grads``), so the
    ranks that hold a leaf keep it equal bit for bit.  Each phase is a
    ``region`` (``train_step.cast``, ``.loss``, ``.backward``,
    ``.grad_sum``, ``.optimizer``, ``.zero_grad``) inside ``train_step``."""

    def train_step(params, batch):
        with region("train_step"):
            with region("train_step.cast"):
                weights = _cast_weights(params, cfg.compute_dtype)
            with region("train_step.loss"):
                loss = loss_fn(weights, batch, cfg, pp_microbatches,
                               xent_chunks)
            del weights  # the graph holds what the backward needs of them
            with region("train_step.backward"):
                loss.backward()
            with region("train_step.grad_sum"):
                _sum_grads(params, cfg)
            with region("train_step.optimizer"):
                optimizer.step()
            with region("train_step.zero_grad"):
                optimizer.zero_grad(set_to_none=True)
            return {"loss": loss.detach()}

    return train_step


#: the whole bias leaves of which a tp rank adds only its slice
_TP_SLICED = ("attn/c_attn/bias", "mlp/c_fc/bias")


def _sum_grads(params, cfg: GPT2Config):
    """Each leaf's gradient summed over the loss's axes (``_loss_axes``),
    one all-reduce of the flattened gradients per axis: every leaf over dp
    and sp; over fsdp only the leaves fsdp does not cut (biases, LN scales:
    ``fsdp_dim``), a cut leaf's gradient being the reduce-scatter of its
    gather's cotangent, already summed over fsdp and the rank's block (an
    all-reduce would add the other ranks' blocks into it); over pp the
    leaves outside ``blocks`` (wte and wpe take their embedding terms from
    stage 0, wte and ln_f their head terms from each stage's rows), not the
    stacked blocks, whose layers differ by stage.
    Over tp only the biases of which each rank adds a slice (``c_attn``'s
    and ``c_fc``'s: zero elsewhere, so the sum is exact); every other
    leaf's gradient is already whole and the same bits on every tp rank,
    the residual stream's cotangent being summed by each "f".  Over ep
    nothing: a rank's experts' gradients are its own, and every other
    leaf's is whole on every ep rank, the expert outputs being gathered
    before the combine.  A leaf with no gradient (wpe beyond stage 0)
    counts as zeros."""
    axes = [axis for axis, _ in _loss_axes(params, cfg)]
    if _axis_rank_and_size("tp")[1] > 1:
        axes.append("tp")
    if not axes:
        return

    def takes(axis, name, leaf):
        if axis == "pp":
            return not name.startswith("blocks/")
        if axis == "fsdp":
            return fsdp_dim(tuple(name.split("/")), tuple(leaf.shape)) is None
        if axis == "tp":
            return name.endswith(_TP_SLICED)
        return True

    named = named_leaves(params)
    for t in (t for _, t in named if t.grad is None):
        t.grad = torch.zeros_like(t)
    for axis in axes:
        grads = [t.grad for name, t in named if takes(axis, name, t)]
        with torch.no_grad():
            flat = c10d.allreduce(torch.cat([g.reshape(-1) for g in grads]),
                                  axis)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


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
