"""ShardingConfig: declarative parallelism strategy → per-dimension mesh
axes — counterpart of ``ray_tpu/parallel/sharding.py``.

Logical dims used by the bundled models (ray_tpu_torch/models/*):
  "batch"   → (dp, fsdp)     activations' leading dim
  "seq"     → sp             sequence dim of activations
  "embed"   → fsdp           model width when it's the param *sharded* dim
  "mlp"     → tp             hidden/ffn dim
  "heads"   → tp             attention head dim
  "kv"      → None           per-head dim (never sharded)
  "vocab"   → tp             embedding vocab dim
  "expert"  → ep             MoE expert dim
  "stage"   → pp             pipeline-stacked leading dim

``spec`` gives, per tensor dim, the mesh axis name(s) or ``None``: the
entries of the JAX ``PartitionSpec``.  Each rank holds its own shard of the
data: ``batch_shard`` cuts a rank's rows on the "batch" rule (dp, fsdp),
``seq_shard`` its sequence chunk on sp.  ``shard_params`` gives a rank its
local parameters: a leaf whose spec names ``pp`` (the "stage" dim of
pipeline-stacked blocks) is narrowed to the rank's layers, a dim on ``tp``
("heads", "mlp", "vocab"), ``ep`` (the MoE "expert" dim) or ``fsdp`` (the
"embed" dim, ``fsdp_dim``) to the rank's block of it, and a leaf
replicated on every axis comes back whole; ``param_shardings`` gives every
leaf's spec, and ``gather_params`` the whole leaves back from the ranks'
shards (what reading a global ``jax.Array`` gives).  ``named_sharding``
and ``constraint`` raise ``NotImplementedError``: nothing of the port
needs them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ray_tpu_torch.collective import _all_gather
from ray_tpu_torch.parallel.mesh import create_mesh, mesh_shape

DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("dp", "fsdp"),
    "seq": "sp",
    "embed": "fsdp",
    "mlp": "tp",
    "heads": "tp",
    "kv": None,
    "vocab": "tp",
    "expert": "ep",
    "stage": "pp",
    None: None,
}

_NAMED = ("named_sharding and constraint are not ported (ROADMAP.md §A9c: "
          "nothing of the port places a tensor by them)")


@dataclass
class ShardingConfig:
    """Axis sizes for the mesh.  -1 = all remaining ranks."""

    dp: int = 1
    fsdp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1
    tp: int = 1
    rules: Dict[str, Any] = field(default_factory=lambda: dict(DEFAULT_RULES))

    def axes(self) -> Dict[str, int]:
        sizes = {"dp": self.dp, "fsdp": self.fsdp, "pp": self.pp,
                 "sp": self.sp, "ep": self.ep, "tp": self.tp}
        return {k: v for k, v in sizes.items() if v != 1 or k == "dp"}

    def build_mesh(self, ranks: Optional[Sequence[int]] = None,
                   device_type: str = "cuda") -> DeviceMesh:
        return create_mesh(self.axes(), ranks, device_type)

    # ------------------------------------------------------------------

    def _resolve(self, logical: Optional[str], mesh: DeviceMesh):
        axis = self.rules.get(logical, None)
        if axis is None:
            return None
        shape = mesh_shape(mesh)
        if isinstance(axis, (tuple, list)):
            present = tuple(a for a in axis if shape.get(a, 1) > 1)
            if not present:
                return None
            return present if len(present) > 1 else present[0]
        if shape.get(axis, 1) > 1:
            return axis
        return None

    def spec(self, mesh: DeviceMesh, *logical_dims: Optional[str]) -> tuple:
        """Per dim, the mesh axis (a name, a tuple of names, or None).  A
        mesh axis may appear only once; earlier dims win (so "batch" on
        (dp, fsdp) suppresses "embed" on fsdp for activations — params
        without a batch dim still shard on fsdp)."""
        used: set = set()
        parts = []
        for d in logical_dims:
            axis = self._resolve(d, mesh)
            if axis is None:
                parts.append(None)
                continue
            axes = axis if isinstance(axis, tuple) else (axis,)
            axes = tuple(a for a in axes if a not in used)
            used.update(axes)
            parts.append(axes if len(axes) > 1 else (axes[0] if axes else None))
        return tuple(parts)

    def named_sharding(self, mesh: DeviceMesh, *logical_dims):
        raise NotImplementedError(_NAMED)

    def constraint(self, x, mesh: DeviceMesh, *logical_dims):
        raise NotImplementedError(_NAMED)


def infer_param_logical_dims(path: Tuple[str, ...], shape: Tuple[int, ...]):
    """Heuristic logical dims for a transformer param by its name path.

    Mirrors how t5x/maxtext-style logical axis rules classify params; used
    when a model doesn't annotate its params explicitly.
    """
    name = "/".join(str(p) for p in path).lower()
    if path and str(path[0]) == "blocks":
        # pipeline-stacked block params: leading layer dim = "stage" (pp)
        inner = infer_param_logical_dims(path[1:], shape[1:])
        return ("stage",) + tuple(inner)
    nd = len(shape)
    if nd == 0:
        return ()
    if "router" in name:
        return ("embed", None)[:nd]
    if "moe" in name and "/wi" in name:
        return ("expert", "embed", "mlp")[:nd]
    if "moe" in name and "/wo" in name:
        return ("expert", "mlp", "embed")[:nd]
    if "embedding" in name or "wte" in name or "embed_tokens" in name:
        return ("vocab", "embed")[:nd] if nd >= 2 else ("embed",)
    if "wpe" in name or "pos_emb" in name:
        return (None, "embed")[:nd] if nd >= 2 else ("embed",)
    if any(k in name for k in ("ln", "layernorm", "layer_norm", "norm",
                               "scale", "bias", "rmsnorm")) and nd == 1:
        return (None,)
    if any(k in name for k in ("q_proj", "k_proj", "v_proj", "qkv", "c_attn",
                               "wq", "wk", "wv", "query", "key", "value")):
        return ("embed", "heads") if nd == 2 else ("embed", "heads", "kv")[:nd]
    if any(k in name for k in ("o_proj", "c_proj/attn", "attn/c_proj", "wo",
                               "out_proj")):
        return ("heads", "embed")[:nd]
    if any(k in name for k in ("up_proj", "gate_proj", "c_fc", "wi", "fc1",
                               "mlp_in")):
        return ("embed", "mlp")[:nd]
    if any(k in name for k in ("down_proj", "wo_mlp", "c_proj", "fc2", "wo2",
                               "mlp_out")):
        return ("mlp", "embed")[:nd]
    if "lm_head" in name:
        return ("embed", "vocab")[:nd]
    if nd == 2:
        return ("embed", "mlp")
    if nd == 1:
        return (None,)
    return tuple([None] * nd)


def fsdp_dim(path: Tuple[str, ...], shape: Tuple[int, ...]):
    """The dim of a parameter that the "embed" rule places on fsdp (its
    inferred "embed" dim: wte's and wpe's columns, the rows of ``c_attn``,
    ``c_fc`` and the router, the columns of both ``c_proj``, the MoE
    ``wi``'s and ``wo``'s embed dims), or None for a leaf fsdp does not
    cut (biases, LN scales)."""
    dims = infer_param_logical_dims(path, shape)
    return dims.index("embed") if "embed" in dims else None


def _leaf_specs(params, config: ShardingConfig, mesh: DeviceMesh,
                path=()):
    """{name: (leaf, spec, path)} over the nested dicts, with the spec of
    each leaf's inferred logical dims."""
    if isinstance(params, dict):
        return {k: _leaf_specs(v, config, mesh, path + (k,))
                for k, v in params.items()}
    dims = infer_param_logical_dims(path, tuple(params.shape))
    return params, config.spec(mesh, *dims), path


def _map_specs(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return fn(*tree)


def _fused_qkv(path) -> bool:
    """GPT-2's fused [q | k | v] projection kernel, cut on tp by heads."""
    return "c_attn" in path and path[-1] == "kernel"


def _divisible(path, leaf, dim, n):
    c, rem = divmod(leaf.shape[dim], n)
    if rem:
        raise ValueError(
            f"{'/'.join(path)}: the global size of its dimension {dim} should "
            f"be divisible by {n}, but it is equal to {leaf.shape[dim]} "
            f"(full shape: {tuple(leaf.shape)})")
    return c


def shard_params(params, config: ShardingConfig, mesh: DeviceMesh):
    """The calling rank's local parameters: each leaf cut as its inferred
    logical dims place it on ``mesh`` (JAX: ``device_put`` with the
    ``NamedSharding``, of which a rank holds its shard).  A dim on ``pp``
    (the "stage" dim of ``blocks``) is narrowed to the rank's n_layer / pp
    consecutive layers, a dim on ``tp`` to the rank's contiguous block of
    it (the rows of wte and wpe, ``c_fc``'s columns, both ``c_proj``'s
    rows, the MoE ``wi``/``wo`` hidden dim), the MoE ``wi``/``wo`` expert
    dim on ``ep`` to the rank's n / ep consecutive experts, the "embed" dim
    on ``fsdp`` (``fsdp_dim``) to the rank's contiguous block of it: JAX's
    device shard at the same mesh coordinates.  One exception, by design:
    the fused (E, 3E) ``c_attn`` kernel, whose columns are [q | k | v], is
    cut by heads on tp (its rows on fsdp are a contiguous block, as every
    fsdp cut).  tp rank t holds [q_t | k_t | v_t], q_t the columns
    [t E/tp, (t+1) E/tp) of the q block and the same of k and v, so its
    (E, 3E/tp) leaf splits into its heads' q, k and v as the whole leaf
    does; JAX's shard is 3E/tp contiguous columns instead (at tp = 2 all of
    q and half of k), and ``param_shardings`` still gives JAX's spec.
    Every cut is a copy; a leaf replicated on every axis comes back whole,
    the given tensor.  Raises ``ValueError`` for a dim that does not divide
    by its axis (as ``device_put`` does)."""
    shape = mesh_shape(mesh)

    def local(leaf, spec, path):
        for dim, part in enumerate(spec):
            if part is None:
                continue
            n, r = shape[part], mesh.get_local_rank(part)
            if part == "pp":
                c, rem = divmod(leaf.shape[dim], n)
                if rem:
                    raise ValueError(
                        f"{leaf.shape[dim]} layers do not divide by the pp "
                        f"axis size {n}")
                leaf = leaf.narrow(dim, r * c, c).clone()
            elif part == "tp" and _fused_qkv(path):
                # [q | k | v] as (3, n, E / n): each block's rank-r columns
                c = _divisible(path, leaf, dim, 3 * n)
                leaf = leaf.unflatten(dim, (3, n, c)).select(
                    dim + 1, r).flatten(dim, dim + 1).clone()
            else:
                c = _divisible(path, leaf, dim, n)
                leaf = leaf.narrow(dim, r * c, c).clone()
        return leaf

    return _map_specs(local, _leaf_specs(params, config, mesh))


def gather_params(local, config: ShardingConfig, mesh: DeviceMesh):
    """The whole leaves on every rank from each rank's fsdp, ep and tp
    shards (of parameters or of their gradients, named as the parameters):
    every dim ``shard_params`` cut on an axis other than pp all-gathered
    over that axis, the ``c_attn`` kernel put back from head order into
    [q | k | v].  What reading a global ``jax.Array`` gives, for the port's
    tests and checks; a stage cut on pp stays the rank's stage.  Every
    rank calls it together."""
    shape = mesh_shape(mesh)
    groups = {a: mesh.get_group(a) for a, n in shape.items()
              if a != "pp" and n > 1}
    if not groups:
        return local

    def whole(leaf, spec, path):
        for dim, part in enumerate(spec):
            if part not in groups:
                continue
            with torch.no_grad():
                full = _all_gather(leaf.detach(), groups[part], dim)
            if part == "tp" and _fused_qkv(path):
                n = shape["tp"]
                full = full.unflatten(dim, (n, 3, -1)).transpose(
                    dim, dim + 1).flatten(dim, dim + 2)
            leaf = full
        return leaf

    return _map_specs(whole, _leaf_specs(local, config, mesh))


def param_shardings(params, config: ShardingConfig, mesh: DeviceMesh):
    """Every leaf's spec (a tuple as ``spec`` gives it: the entries of the
    JAX ``NamedSharding``'s ``PartitionSpec``), nested as the params."""
    return _map_specs(lambda leaf, spec, path: spec,
                      _leaf_specs(params, config, mesh))


def batch_shard(x, mesh: DeviceMesh, dim: int = 0):
    """The calling rank's rows of a global tensor along ``dim`` on the
    "batch" rule, (dp, fsdp): the axes of size > 1 among them index the
    rank's block, dp major (what ``device_put(x, named_sharding(mesh,
    "batch", ...))`` gives a rank in JAX).  Rank (d, f) of (n_dp, n_fsdp)
    takes block d * n_fsdp + f of n_dp * n_fsdp."""
    shape = mesh_shape(mesh)
    axes = [a for a in DEFAULT_RULES["batch"] if shape.get(a, 1) > 1]
    n, idx = 1, 0
    for a in axes:
        n, idx = n * shape[a], idx * shape[a] + mesh.get_local_rank(a)
    if n == 1:
        return x
    c, rem = divmod(x.shape[dim], n)
    if rem:
        raise ValueError(f"length {x.shape[dim]} along dim {dim} does not "
                         f"divide by the batch axes' size {n}")
    return x.narrow(dim, idx * c, c)


def seq_shard(x, mesh: DeviceMesh, dim: int = 1, overlap: int = 0):
    """The calling rank's chunk of a global tensor along ``dim`` over the
    mesh's sp axis (the "seq" → sp rule, applied to one rank's data):
    rank r of n takes [r*c, (r+1)*c + overlap) with c = (len - overlap) /
    n.  ``overlap=1`` cuts a train batch of (B, S+1) tokens into (B, S/n +
    1): the last token of a chunk is the target of its last input, and the
    next chunk's first input."""
    n = mesh_shape(mesh).get("sp", 1)
    if n == 1:
        return x
    c, rem = divmod(x.shape[dim] - overlap, n)
    if rem:
        raise ValueError(f"length {x.shape[dim] - overlap} along dim {dim} "
                         f"does not divide by the sp axis size {n}")
    return x.narrow(dim, mesh.get_local_rank("sp") * c, c + overlap)
