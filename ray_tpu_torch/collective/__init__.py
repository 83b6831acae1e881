"""Collective communication of the port — counterpart of the in-program
half of ``ray_tpu/collective/__init__.py`` (its ``xla`` class).

``c10d`` mirrors ``xla``: collectives over a named mesh axis.  In the JAX
package they are XLA ops inside ``jit``/``shard_map``, where the axis name
is bound; here each rank is a process and the axis is the process group of
that axis of the bound mesh (``ray_tpu_torch.parallel.context.use_mesh``).
Every rank of the axis calls an op together, in the same order.

The transport is ``torch.distributed``:

* ``allreduce``, ``allgather``, ``reducescatter``, ``broadcast`` and
  ``alltoall`` (``all_to_all_single``) pass their tensors to the group's
  backend directly, CUDA tensors included: NCCL takes them, and so does
  gloo, which stages them through host memory itself.
* ``permute`` and the ring's hops are point-to-point (``exchange``).
  gloo's ``send``/``recv`` hand a tensor's pointer to its TCP transport,
  which cannot read device memory (on an H100 with torch 2.11 the write
  fails with "Bad address" and the rank aborts), so a hop of CUDA tensors
  over a gloo group goes through pinned host buffers: that is
  ``_host_staged_buffers``, the one place that stages, chosen by the
  group's backend (``_p2p_through_host``) and counted in
  ``HOST_STAGED_HOPS`` / ``HOST_STAGED_BYTES``.  NCCL and CPU tensors hop
  directly.  Ranks that share one card can only use gloo.

``timing()`` records, while active, a pair of CUDA events around each of
the transport's calls on a CUDA tensor (from the call to the moment its
result is on the device), by kind ("hop", "all_reduce", "all_to_all",
"all_gather", "reduce_scatter"), and the host time blocked in them.
``SENT_BYTES`` counts, by the same kinds, the bytes each call hands the
transport (a hop's sends; a collective's input).

Megatron's pair of operators for tensor parallelism: ``allreduce`` (sum)
is "g", a sum in the forward whose backward is the identity, and
``identity`` is "f", the identity in the forward whose backward sums the
cotangents over the axis: the input of work cut over the axis, which
every rank holds whole.

The host group (``init_collective_group``, ``_HostGroup``, ``allreduce``,
``allgather``, ``broadcast``, ``barrier``, ``send``, ``recv``) is the
reference's "host" backend: cross-process collectives outside the tensor
plane over the runtime's KV store, for small host-side sync.  Its
``allreduce`` of a tensor takes it to the host and returns a CPU tensor;
``backend="c10d"`` names the in-program class, as ``"xla"`` does there.
"""

from __future__ import annotations

import contextlib
import pickle
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from ray_tpu_torch.parallel.context import require_mesh

#: point-to-point hops in this process (``exchange`` calls), and those of
#: them staged through host memory with the bytes they sent
HOPS = 0
HOST_STAGED_HOPS = 0
HOST_STAGED_BYTES = 0
#: bytes handed to the transport in this process, by kind
SENT_BYTES: Dict[str, int] = {}


def _count(kind, *tensors):
    SENT_BYTES[kind] = SENT_BYTES.get(kind, 0) + sum(
        t.numel() * t.element_size() for t in tensors)


def axis_group(axis_name: str):
    """The process group of ``axis_name`` of the bound mesh."""
    return require_mesh().get_group(axis_name)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class CommTimes:
    """CUDA-event spans of the transport's calls and host seconds blocked
    in them, by kind, gathered while ``timing()`` is active."""

    def __init__(self):
        self.spans: List[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = []
        self.blocked_s: Dict[str, float] = {}

    def split_ms(self) -> Dict[str, Tuple[float, float]]:
        """{kind: (ms of the stream's timeline during which a call of that
        kind was in flight, host ms blocked in such calls)}, and "all" for
        every kind together.  Spans overlap (a hop is in flight across the
        kernel it hides behind), so each kind's time is the union of its
        spans, not their sum.  Synchronises the device."""
        if not self.spans:  # nothing on a card
            return {"all": (0.0, sum(self.blocked_s.values()) * 1e3)}
        torch.cuda.synchronize()
        first = self.spans[0][1]
        out = {}
        for kind in sorted({k for k, _, _ in self.spans}) + ["all"]:
            spans = sorted((first.elapsed_time(a), first.elapsed_time(b))
                           for k, a, b in self.spans if kind in (k, "all"))
            busy, (lo, hi) = 0.0, spans[0]
            for a, b in spans[1:]:
                if a > hi:
                    busy, lo = busy + hi - lo, a
                hi = max(hi, b)
            blocked = (sum(self.blocked_s.values()) if kind == "all"
                       else self.blocked_s.get(kind, 0.0))
            out[kind] = (busy + hi - lo, blocked * 1e3)
        return out


_times: Optional[CommTimes] = None


@contextlib.contextmanager
def timing():
    """Time the transport's calls of this process while active; yields the
    ``CommTimes``."""
    global _times
    prev, _times = _times, CommTimes()
    try:
        yield _times
    finally:
        _times = prev


def _span_start(device):
    if _times is None or device.type != "cuda":
        return None
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    return start


def _span_end(start, kind):
    if start is not None and _times is not None:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        _times.spans.append((kind, start, end))


@contextlib.contextmanager
def _blocked(kind):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if _times is not None:
            _times.blocked_s[kind] = (_times.blocked_s.get(kind, 0.0)
                                      + time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# point-to-point hops
# ---------------------------------------------------------------------------

def _p2p_through_host(group, device) -> bool:
    """gloo's point-to-point transport reads host memory only."""
    return device.type == "cuda" and dist.get_backend(group) == "gloo"


def _host_staged_buffers(sends, likes):
    """Host copies of the tensors to send (pinned when they are on a card;
    the copy waits for the work that writes them) and host buffers to
    receive into, shaped like ``likes``."""
    global HOST_STAGED_HOPS, HOST_STAGED_BYTES
    out = []
    for t in sends:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
        buf.copy_(t)
        out.append(buf)
    bufs = [torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda)
            for x in likes]
    HOST_STAGED_HOPS += 1
    HOST_STAGED_BYTES += sum(t.numel() * t.element_size() for t in sends)
    return out, bufs


class Hop:
    """Sends and receives in flight; ``wait()`` returns the received
    tensors on the receiving device, in the order of the receives."""

    def __init__(self, works, bufs, device, keep, start):
        self._works, self._bufs, self._device = works, bufs, device
        self._keep, self._start = keep, start  # send buffers stay alive

    def wait(self) -> List[torch.Tensor]:
        with _blocked("hop"):
            for w in self._works:
                w.wait()
        out = [b.to(self._device, non_blocking=True) for b in self._bufs]
        self._keep = None
        _span_end(self._start, "hop")
        return out


def exchange(sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[int, torch.Tensor]], group,
             tag: int = 0) -> Hop:
    """Post ``sends`` [(tensor, destination)] and ``recvs`` [(source,
    tensor shaped like what arrives)], ranks of ``group``; the i-th send
    and the i-th receive carry ``tag + i``, so the peer lists its sends and
    receives in the same order.  Returns the ``Hop`` in flight."""
    global HOPS
    device = (sends[0][0] if sends else recvs[0][1]).device
    start = _span_start(device)
    tensors = [t.contiguous() for t, _ in sends]
    likes = [x for _, x in recvs]
    if _p2p_through_host(group, device):
        tensors, bufs = _host_staged_buffers(tensors, likes)
    else:
        bufs = [torch.empty_like(x, memory_format=torch.contiguous_format)
                for x in likes]
    peer = lambda r: dist.get_global_rank(group, r)  # noqa: E731
    ops = [dist.P2POp(dist.isend, t, peer(dst), group, tag + i)
           for i, (t, (_, dst)) in enumerate(zip(tensors, sends))]
    ops += [dist.P2POp(dist.irecv, b, peer(src), group, tag + i)
            for i, (b, (src, _)) in enumerate(zip(bufs, recvs))]
    works = dist.batch_isend_irecv(ops) if ops else []
    HOPS += 1
    _count("hop", *tensors)
    return Hop(works, bufs, device, tensors, start)


def _permute(x, group, perm):
    me = group.rank()
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    got = exchange([(x, d) for d in dst], [(s, x) for s in src],
                   group).wait() if dst or src else []
    return got[0] if src else torch.zeros_like(x)


def _check_perm(perm, n):
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
            or not all(0 <= r < n for r in srcs + dsts)):
        raise ValueError(f"perm {perm} is not a partial permutation of "
                         f"range({n})")


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def _all_reduce(x, group, op):
    """A new tensor: the reduction of x over the group (op sum, max, min,
    mean)."""
    if op not in _OPS and op != "mean":
        raise ValueError(f"unknown op {op}")
    y = x.clone(memory_format=torch.contiguous_format)
    _count("all_reduce", y)
    start = _span_start(y.device)
    with _blocked("all_reduce"):
        dist.all_reduce(y, op=_OPS.get(op, dist.ReduceOp.SUM), group=group)
    _span_end(start, "all_reduce")
    return y / group.size() if op == "mean" else y


def _all_to_all(x, group, split_axis, concat_axis):
    """Tiled all-to-all: x's n blocks along ``split_axis`` go to ranks
    0..n-1; the blocks received from ranks 0..n-1 are concatenated along
    ``concat_axis``."""
    n = group.size()
    if x.shape[split_axis] % n:
        raise ValueError(f"dim {split_axis} of {tuple(x.shape)} does not "
                         f"divide by the group size {n}")
    inp = torch.stack(x.chunk(n, split_axis))
    out = torch.empty_like(inp)
    _count("all_to_all", inp)
    start = _span_start(x.device)
    with _blocked("all_to_all"):
        dist.all_to_all_single(out, inp, group=group)
    _span_end(start, "all_to_all")
    return torch.cat(out.unbind(0), concat_axis)


def _all_gather(x, group, axis):
    """Tiled all-gather: the ranks' x concatenated along ``axis`` in rank
    order."""
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(group.size())]
    _count("all_gather", x)
    start = _span_start(x.device)
    with _blocked("all_gather"):
        dist.all_gather(out, x, group=group)
    _span_end(start, "all_gather")
    return torch.cat(out, axis)


def _reduce_scatter(x, group, axis):
    """Tiled reduce-scatter: the sum over the ranks of x, of which rank j
    keeps block j along ``axis``."""
    n = group.size()
    if x.shape[axis] % n:
        raise ValueError(f"dim {axis} of {tuple(x.shape)} does not "
                         f"divide by the group size {n}")
    xm = x.movedim(axis, 0).contiguous()
    out = xm.new_empty((xm.shape[0] // n, *xm.shape[1:]))
    _count("reduce_scatter", xm)
    start = _span_start(x.device)
    with _blocked("reduce_scatter"):
        dist.reduce_scatter_tensor(out, xm, group=group)
    _span_end(start, "reduce_scatter")
    return out.movedim(0, axis)


class _AllReduce(torch.autograd.Function):
    """Sum (or mean) over the group into a value every rank holds whole.
    Each rank's copy is the same value and its cotangent arrives whole on
    every rank, so the transpose hands each input that cotangent (divided
    by n for the mean): no second collective.  This is how JAX transposes
    ``psum`` into a replicated value under ``shard_map``, and Megatron's
    "g" operator; a loss made so (``gpt2.loss_fn``) gives each rank the
    gradient of its own terms, which the train step then sums."""

    @staticmethod
    def forward(ctx, x, group, op):
        ctx.scale = 1.0 / group.size() if op == "mean" else 1.0
        return _all_reduce(x, group, op)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return g * ctx.scale, None, None


class _Identity(torch.autograd.Function):
    """The transpose of ``_AllReduce``'s sum, Megatron's "f": the identity
    in the forward, a sum over the group in the backward.  A value every
    rank holds whole and feeds to work cut over the group (a
    column-parallel product) gets from each rank the cotangent of that
    rank's part only; their sum is its whole cotangent, on every rank.
    JAX's ``shard_map`` transposes a replicated input consumed by sharded
    work into the same ``psum``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, "sum"), None


class _Permute(torch.autograd.Function):
    """``permute``; its transpose sends the cotangents back along the
    inverted pairs."""

    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _permute(x, group, perm)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        inv = [(d, s) for s, d in ctx.perm]
        return _permute(g, ctx.group, inv), None, None


class _AllToAll(torch.autograd.Function):
    """``alltoall``; its transpose is the all-to-all with the two axes
    swapped."""

    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, concat_axis, split_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None


class _AllGather(torch.autograd.Function):
    """Tiled ``allgather``; its transpose is the reduce-scatter along the
    same axis: rank j's block of every rank's cotangent, summed (JAX
    transposes ``all_gather`` into ``psum_scatter``)."""

    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.args = (group, axis)
        return _all_gather(x, group, axis)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _reduce_scatter(g, *ctx.args), None, None


class _ReduceScatter(torch.autograd.Function):
    """Tiled ``reducescatter`` (sum); its transpose is the all-gather of
    the cotangents along the same axis."""

    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.args = (group, axis)
        return _reduce_scatter(x, group, axis)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _all_gather(g, *ctx.args), None, None


class c10d:
    """Named-axis collectives over the bound mesh's process groups — the
    counterpart of ``ray_tpu.collective.xla`` (named-axis collectives
    inside jit/shard_map).  ``permute``, ``alltoall``, ``allgather``,
    ``reducescatter``, ``allreduce`` with op sum or mean and ``identity``
    are differentiable."""

    @staticmethod
    def allreduce(x, axis_name: str, op: str = "sum"):
        group = axis_group(axis_name)
        if op in ("sum", "mean"):
            return _AllReduce.apply(x, group, op)
        with torch.no_grad():
            return _all_reduce(x, group, op)

    @staticmethod
    def identity(x, axis_name: str):
        """x itself; its gradient is summed over the axis (the transpose of
        ``allreduce``): the input of work cut over the axis."""
        return _Identity.apply(x, axis_group(axis_name))

    @staticmethod
    def allgather(x, axis_name: str, axis: int = 0, tiled: bool = True):
        """Every rank's x along ``axis``, in rank order: concatenated
        (``tiled``) or stacked on a new dim ``axis``."""
        if not tiled:
            x = x.unsqueeze(axis)
        return _AllGather.apply(x, axis_group(axis_name), axis)

    @staticmethod
    def reducescatter(x, axis_name: str, axis: int = 0, op: str = "sum"):
        """The sum over the ranks of x, cut along ``axis`` into one block
        per rank: rank j keeps block j (``psum_scatter(..., tiled=True)``).
        """
        if op != "sum":
            raise ValueError("reducescatter supports sum")
        return _ReduceScatter.apply(x, axis_group(axis_name), axis)

    @staticmethod
    def broadcast(x, axis_name: str, root: int = 0):
        group = axis_group(axis_name)
        y = x.clone(memory_format=torch.contiguous_format)
        dist.broadcast(y, src=dist.get_global_rank(group, root), group=group)
        return y

    @staticmethod
    def permute(x, axis_name: str, perm: List[tuple]):
        """Each rank sends x to its destination in ``perm`` (pairs of axis
        indices); a rank that no pair sends to gets zeros."""
        group = axis_group(axis_name)
        perm = [tuple(p) for p in perm]
        _check_perm(perm, group.size())
        return _Permute.apply(x, group, perm)

    @staticmethod
    def alltoall(x, axis_name: str, split_axis: int = 0,
                 concat_axis: int = 0):
        """Tiled, as ``lax.all_to_all(..., tiled=True)``: rank j receives
        block j (along ``split_axis``) of every rank, concatenated along
        ``concat_axis`` in rank order."""
        return _AllToAll.apply(x, axis_group(axis_name), split_axis,
                               concat_axis)


# --------------------------------------------------------------------------
# Host-level (cross-process) collectives over the driver KV store: the
# reference's, definition by definition (``tests/test_torch_runtime_copy.py``).


def _reduce_tensors(stack: torch.Tensor, op: str) -> torch.Tensor:
    """``_HostGroup.allreduce``'s reduction over dim 0 of stacked CPU
    tensors, numpy's semantics (an integer mean is a float64 one)."""
    if op == "sum":
        return stack.sum(0)
    if op == "mean":
        return (stack if stack.is_floating_point() else stack.double()
                ).mean(0)
    if op == "max":
        return stack.amax(0)
    if op == "min":
        return stack.amin(0)
    raise ValueError(f"unknown op {op}")


class _HostGroup:
    def __init__(self, name: str, world_size: int, rank: int):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self._seq = 0

    # -- kv helpers ---------------------------------------------------------

    def _kv(self):
        from ray_tpu_torch.core.worker import global_worker

        return global_worker()

    def _put(self, key: str, value: Any):
        self._kv().kv_put(key.encode(), pickle.dumps(value),
                          namespace="collective")

    def _del(self, key: str):
        try:
            self._kv().kv_del(key.encode(), namespace="collective")
        except Exception:  # noqa: BLE001 — cleanup is best-effort
            pass

    def _gc_round(self, kind: str):
        """Delete THIS rank's key from two rounds ago: every rank has
        finished reading round seq-1 before any rank can enter seq+1 (the
        gather blocks on all ranks' seq keys), so seq-2 keys are dead.
        Without this, hot-path collectives (gradient allreduce per update)
        accumulate world_size x payload in the KV forever."""
        if self._seq > 2:
            self._del(f"{self.name}/{kind}{self._seq - 2}/{self.rank}")

    def _get(self, key: str, timeout: float = 120.0):
        w = self._kv()
        deadline = time.monotonic() + timeout
        while True:
            blob = w.kv_get(key.encode(), namespace="collective")
            if blob is not None:
                return pickle.loads(blob)
            if time.monotonic() > deadline:
                raise TimeoutError(f"collective key {key} not posted")
            time.sleep(0.002)

    # -- ops ----------------------------------------------------------------

    def barrier(self, timeout: float = 120.0):
        self._seq += 1
        self._gc_round("bar")
        self._put(f"{self.name}/bar{self._seq}/{self.rank}", True)
        for r in range(self.world_size):
            self._get(f"{self.name}/bar{self._seq}/{r}", timeout)

    def allgather_obj(self, obj: Any, timeout: float = 120.0) -> List[Any]:
        self._seq += 1
        self._gc_round("ag")
        self._put(f"{self.name}/ag{self._seq}/{self.rank}", obj)
        return [self._get(f"{self.name}/ag{self._seq}/{r}", timeout)
                for r in range(self.world_size)]

    def allreduce(self, arr, op: str = "sum", timeout: float = 120.0):
        if isinstance(arr, torch.Tensor):
            # a tensor on the card goes to the host, as np.asarray of a
            # device array does in the reference: a CPU tensor comes back
            parts = self.allgather_obj(arr.detach().cpu(), timeout)
            return _reduce_tensors(torch.stack(parts), op)
        parts = self.allgather_obj(np.asarray(arr), timeout)
        stack = np.stack(parts)
        if op == "sum":
            return stack.sum(0)
        if op == "mean":
            return stack.mean(0)
        if op == "max":
            return stack.max(0)
        if op == "min":
            return stack.min(0)
        raise ValueError(f"unknown op {op}")

    def broadcast(self, arr, root: int = 0, timeout: float = 120.0):
        # NOTE: no _gc_round here — broadcast doesn't block the root on
        # readers, so an old key may still be in flight; bc keys are
        # typically few (bootstrap-time) and small.
        self._seq += 1
        if self.rank == root:
            self._put(f"{self.name}/bc{self._seq}", np.asarray(arr))
            return np.asarray(arr)
        return self._get(f"{self.name}/bc{self._seq}", timeout)

    def send_obj(self, obj: Any, dst: int):
        self._seq += 1
        self._put(f"{self.name}/p2p{self._seq}/{self.rank}->{dst}", obj)

    def recv_obj(self, src: int, timeout: float = 120.0):
        self._seq += 1
        return self._get(f"{self.name}/p2p{self._seq}/{src}->{self.rank}",
                         timeout)


_groups: Dict[str, _HostGroup] = {}


def init_collective_group(world_size: int, rank: int,
                          backend: str = "host",
                          group_name: str = "default") -> _HostGroup:
    """Create/join a named collective group (reference:
    `collective.py:120` `init_collective_group`)."""
    if backend not in ("host", "c10d"):
        raise ValueError("backend must be 'host' or 'c10d'")
    g = _HostGroup(group_name, world_size, rank)
    _groups[group_name] = g
    return g


def get_group(group_name: str = "default") -> _HostGroup:
    if group_name not in _groups:
        raise ValueError(f"collective group {group_name!r} not initialized")
    return _groups[group_name]


def destroy_collective_group(group_name: str = "default"):
    _groups.pop(group_name, None)


def allreduce(tensor, group_name: str = "default", op: str = "sum"):
    return get_group(group_name).allreduce(tensor, op)


def allgather(obj, group_name: str = "default"):
    return get_group(group_name).allgather_obj(obj)


def broadcast(tensor, root: int = 0, group_name: str = "default"):
    return get_group(group_name).broadcast(tensor, root)


def barrier(group_name: str = "default"):
    get_group(group_name).barrier()


def send(obj, dst_rank: int, group_name: str = "default"):
    get_group(group_name).send_obj(obj, dst_rank)


def recv(src_rank: int, group_name: str = "default"):
    return get_group(group_name).recv_obj(src_rank)


__all__ = ["c10d", "exchange", "Hop", "axis_group", "timing", "CommTimes",
           "SENT_BYTES", "init_collective_group", "get_group",
           "destroy_collective_group", "allreduce", "allgather", "broadcast",
           "barrier", "send", "recv"]
