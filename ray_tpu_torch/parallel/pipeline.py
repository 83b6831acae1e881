"""Pipeline parallelism over the ``pp`` axis of a process-group mesh —
counterpart of ``ray_tpu/parallel/pipeline.py``.

The JAX package runs the whole pipeline as one program: the layer-stacked
block params shard across ``pp`` (each stage holds ``n_layer / pp``
consecutive layers), a ``lax.scan`` runs the fill-drain microbatch
schedule with a ``ppermute`` between stages at every tick, the MoE aux
loss rides the handoff as a scalar lane, and the output leaves through a
reduce-scatter over pp (or a ``psum`` when the microbatches do not divide
by the stages).  Its backward is autodiff through the scan, each stage body
under ``jax.checkpoint``.

Here each stage is a process (a rank of the mesh's pp group) and the
schedule is one ``torch.autograd.Function`` whose backward runs the
reverse schedule explicitly, as ``ring_attention`` runs its ring:

* forward — stage s runs its layers on microbatch m at tick m + s: stage
  0 takes it from x, every other stage receives it (and the aux scalar)
  from stage s - 1 (``collective.exchange``, one tag per direction and
  microbatch; the next microbatch's receive is posted before this one's
  compute), and every stage but the last sends its output on.  It runs
  without grad and keeps one activation per microbatch, the stage's input
  (JAX's remat residual set);
* backward — stage s walks the microbatches in reverse: it receives the
  output and aux cotangents from stage s + 1 (the last stage takes them
  from the Function's outputs), recomputes its layers on the saved input
  under ``enable_grad``, takes ``torch.autograd.grad`` with respect to the
  input and its stacked params, and sends the input cotangent to stage
  s - 1.  The recompute is ``remat=True``: the stage body runs twice a
  microbatch, as under JAX's checkpoint.  ``remat=False`` keeps each
  microbatch's graph from the forward instead;
* the bubble ticks are skipped: JAX computes the stage body at all M + n
  - 1 ticks and masks the n - 1 whose outputs reach nothing; here a stage
  runs its M microbatches only, so per rank and step the body runs M times
  forward (2M with remat) and M times backward.  The wrap hop n - 1 -> 0,
  whose value stage 0 drops, is not made either;
* the cross-rank calls pair up in a fixed order that no autograd
  traversal decides: every rank of the axis enters the Function's
  backward (its outputs feed collectives whose backward reaches every
  rank), and the Function's own forward and backward post every send and
  receive.  Building the schedule from differentiable ``permute`` calls
  would not: stage 0 ignores what it receives, so that permute's backward
  would never run and its peer would wait for it.

The outputs leave as in JAX: ``c10d.reducescatter`` of the (microbatches,
...) buffer, zero except on the last stage, when M divides by the stages
(rank r gets microbatches [rM/n, (r+1)M/n), rows [rB/n, (r+1)B/n)); a sum
over the stages otherwise, every rank getting the whole output.

The stage groups are per mesh coordinate: under tensor parallelism each tp
rank of a stage runs the same schedule with its own pp group, and the
stage body's collectives over tp (in the no-grad forward, the recompute
and ``torch.autograd.grad``) pair up across the stage's tp ranks because
every one of them runs every tick the others run.  A body that needs the
mesh binds it itself: the backward runs on autograd's device thread when
the tensors are on a card, where the caller's ``use_mesh`` is not seen.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from ray_tpu_torch.collective import _all_reduce, c10d, exchange
from ray_tpu_torch.parallel.context import use_mesh
from ray_tpu_torch.parallel.mesh import mesh_axis_size


def _leaves(tree) -> List[torch.Tensor]:
    """Leaves of nested dicts, in sorted key order at each level."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree]


def _rebuild(like, leaves):
    """A tree shaped like ``like`` from ``leaves`` (an iterator)."""
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    return next(leaves)


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_layer_params(layer_params: list):
    """[per-layer params] -> one tree with a leading layer dim (the
    shardable "stage" axis): a ``torch.stack`` per leaf."""
    return _map(lambda *xs: torch.stack(xs, dim=0), *layer_params)


def schedule_info(num_microbatches: int, n_stages: int) -> Dict[str, Any]:
    """Tick/bubble accounting for the fill-drain schedule.

    The schedule spans ``ticks`` stage-body slots per direction, of which
    ``num_microbatches`` process real data on each stage — utilization is
    the best any non-interleaved schedule (GPipe flush or 1F1B) achieves
    at this M, S."""
    ticks = num_microbatches + n_stages - 1
    return {
        "ticks": ticks,
        "useful_ticks": num_microbatches,
        "bubble_fraction": (n_stages - 1) / ticks,
        "utilization": num_microbatches / ticks,
    }


class _Schedule:
    """What the pipeline's Function needs besides tensors: the stage body,
    the stacked params' tree, the pp group and this rank's stage."""

    def __init__(self, block_fn, like, group, n_stages, M, remat):
        self.block_fn, self.like, self.group = block_fn, like, group
        self.n, self.M, self.remat = n_stages, M, remat
        self.stage = group.rank() if group is not None else 0

    def layers(self, leaves):
        """Per-layer param trees of the stage (views of the stacked
        leaves: one unbind each, whose backward stacks the layers'
        gradients at once)."""
        cols = [t.unbind(0) for t in leaves]
        return [_rebuild(self.like, iter(c[i] for c in cols))
                for i in range(leaves[0].shape[0])]

    def body(self, leaves, h):
        """The stage's layers on one microbatch: (h, aux summed over them,
        f32)."""
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for p in self.layers(leaves):
            h, a = self.block_fn(p, h)
            aux = aux + a
        return h, aux

    # hops: the activation and the aux scalar of microbatch m, forward
    # (stage s -> s + 1) at tags 2m, 2m + 1, backward (s + 1 -> s) at
    # 2M + 2m, 2M + 2m + 1
    def send(self, y, a, m, backward=False):
        dst = self.stage - 1 if backward else self.stage + 1
        tag = 2 * m + (2 * self.M if backward else 0)
        return exchange([(y, dst), (a, dst)], [], self.group, tag)

    def recv(self, like_y, like_a, m, backward=False):
        src = self.stage + 1 if backward else self.stage - 1
        tag = 2 * m + (2 * self.M if backward else 0)
        return exchange([], [(src, like_y), (src, like_a)], self.group, tag)


class _Pipeline(torch.autograd.Function):
    """The fill-drain schedule of one stage and its reverse (see the module
    docstring).  Returns (out, aux): the (B, ...) output and the (M,) f32
    aux of each microbatch on the last stage, zeros on the others."""

    @staticmethod
    def forward(ctx, run: _Schedule, x, *leaves):
        M, s, last = run.M, run.stage, run.stage == run.n - 1
        mbs = x.reshape(M, x.shape[0] // M, *x.shape[1:])
        zero_aux = torch.zeros((), dtype=torch.float32, device=x.device)
        kept, outs, auxes, sends = [], [], [], []
        graph_leaves = ([t.detach().requires_grad_(t.is_floating_point())
                         for t in leaves] if not run.remat else None)
        hop = run.recv(mbs[0], zero_aux, 0) if s > 0 else None
        for m in range(M):
            if s == 0:
                h, a_in = mbs[m], zero_aux
            else:
                h, a_in = hop.wait()
                if m + 1 < M:
                    hop = run.recv(mbs[0], zero_aux, m + 1)
            if run.remat:
                kept.append(h)
                y, a = run.body(leaves, h)
            else:
                with torch.enable_grad():
                    h = h.detach().requires_grad_(True)
                    y, a = run.body(graph_leaves, h)
                kept.append((h, y, a))
                y, a = y.detach(), a.detach()
            y_aux = a_in + a
            if last:
                outs.append(y)
                auxes.append(y_aux)
            else:
                sends.append(run.send(y, y_aux, m))
        for hop in sends:
            hop.wait()
        ctx.run, ctx.kept, ctx.graph_leaves = run, kept, graph_leaves
        ctx.x_like = (x.shape, x.dtype)
        ctx.save_for_backward(*leaves)
        if last:
            return torch.cat(outs), torch.stack(auxes)
        return (x.new_zeros(x.shape),
                torch.zeros((M,), dtype=torch.float32, device=x.device))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out, g_aux):
        run, kept = ctx.run, ctx.kept
        M, s, last = run.M, run.stage, run.stage == run.n - 1
        leaves = ctx.saved_tensors
        if run.remat:
            grad_leaves = [t.detach().requires_grad_(t.is_floating_point())
                           for t in leaves]
        else:
            grad_leaves = ctx.graph_leaves
        wrt = [t for t in grad_leaves if t.requires_grad]
        g_mbs = g_out.reshape(M, g_out.shape[0] // M, *g_out.shape[1:])
        like_aux = g_aux[0]
        if s == 0:
            dx = torch.zeros(*ctx.x_like[0], dtype=ctx.x_like[1],
                             device=g_out.device)
            dx_mbs = dx.view(M, -1, *dx.shape[1:])
        else:
            dx = None
        d_leaves, sends = None, []
        hop = run.recv(g_mbs[0], like_aux, M - 1, backward=True) \
            if not last else None
        for m in reversed(range(M)):
            if last:
                gy, ga = g_mbs[m], g_aux[m]
            else:
                gy, ga = hop.wait()
                if m > 0:
                    hop = run.recv(g_mbs[0], like_aux, m - 1, backward=True)
            if run.remat:
                with torch.enable_grad():
                    h = kept[m].detach().requires_grad_(True)
                    y, a = run.body(grad_leaves, h)
            else:
                h, y, a = kept[m]
            outputs, cots = [y], [gy]
            if a.requires_grad:
                outputs.append(a)
                cots.append(ga)
            grads = torch.autograd.grad(outputs, [h] + wrt, cots,
                                        allow_unused=True)
            dh, dw = grads[0], grads[1:]
            dw = [torch.zeros_like(t) if g is None else g
                  for g, t in zip(dw, wrt)]
            # the stacked params' cotangents summed over the microbatches in
            # their dtype, in reverse order, as JAX's reversed scan sums a
            # closed-over value's
            d_leaves = dw if d_leaves is None else [
                acc + g for acc, g in zip(d_leaves, dw)]
            if s > 0:
                # the aux lane's cotangent passes through unchanged: y_aux =
                # aux_in + the stage's aux
                sends.append(run.send(dh, ga, m, backward=True))
            else:
                dx_mbs[m] = dh
        for hop in sends:
            hop.wait()
        ctx.kept = ctx.graph_leaves = None
        it = iter(d_leaves)
        out = [next(it) if t.requires_grad else None for t in grad_leaves]
        return (None, dx, *out)


class _SumOverStages(torch.autograd.Function):
    """The replicated branch's exit, JAX's ``psum`` over pp: the stages'
    buffers summed into the whole output on every rank.  Each rank's loss
    is its share of the replicated head (``gpt2.loss_fn`` divides by the
    stage count), so the cotangent of the last stage's output is the sum
    of the stages' cotangents: the backward sums over the stages too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group, "sum")

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, "sum"), None


def pipeline_apply(
    block_fn: Callable[[Any, Any], Any],
    stacked_params: Any,
    x: torch.Tensor,
    mesh,
    num_microbatches: int,
    axis: str = "pp",
    remat: bool = True,
):
    """Run this rank's stage of a pipeline over ``x`` (batch-leading) with
    the fill-drain microbatch schedule over the ``axis`` group of ``mesh``.

    ``stacked_params`` are the calling rank's LOCAL stage params: the
    leading-dim slice of the layer-stacked tree that ``shard_params`` gives
    it (L / n layers).  The JAX function takes the global stacked array and
    its ``shard_map`` cuts it.  Every rank of the axis passes the same x
    (stage 0 reads it; the others use its shape and dtype only).

    ``block_fn(params_one_layer, x) -> (x, aux)``, ``aux`` a scalar
    auxiliary loss (0.0 for plain blocks; MoE load balancing for routed
    FFNs).  Returns ``(out, aux_total)``: ``out`` equals the layers applied
    in order to each microbatch; when ``num_microbatches % n == 0`` it is
    rank r's rows [rB/n, (r+1)B/n) (JAX: sharded over ``axis`` on the batch
    dim), otherwise every row on every rank.  ``aux_total`` is the
    per-layer aux summed over layers and averaged over microbatches —
    ``sum_l mean_m aux[l, m]`` — the same scalar on every rank.  Bubble
    ticks are skipped (module docstring)."""
    batch = x.shape[0]
    M = num_microbatches
    if batch % M:
        raise ValueError(f"batch {batch} not divisible by "
                         f"num_microbatches {M}")
    n_stages = mesh_axis_size(mesh, axis)
    group = mesh.get_group(axis) if n_stages > 1 else None
    leaves = _leaves(stacked_params)
    run = _Schedule(block_fn, stacked_params, group, n_stages, M, remat)
    out, aux = _Pipeline.apply(run, x, *leaves)
    if n_stages == 1:
        return out, aux.sum() / M
    with use_mesh(mesh):
        aux_total = c10d.allreduce(aux.sum(), axis) / M
        if M % n_stages == 0:
            out = c10d.reducescatter(out, axis, 0)
        else:
            out = _SumOverStages.apply(out, group)
    return out, aux_total
