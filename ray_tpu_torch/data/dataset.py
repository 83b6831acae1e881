"""Dataset — distributed data over object-store blocks.

Reference analogues: `python/ray/data/dataset.py:385` (``map_batches``),
`python/ray/data/_internal/execution/streaming_executor.py:49` (bounded
streaming execution), `python/ray/data/_internal/plan.py` (lazy op chain).

TPU-first redesign decisions:

  * Blocks are columnar dicts of numpy arrays (`ray_tpu_torch/data/block.py`) —
    the exact format a JAX host feed consumes, zero-copy through the shm
    object store.
  * The lazy plan is a flat chain of row/batch transforms.  Chained
    map-like ops FUSE into one task per block (the reference's operator
    fusion, without the logical/physical planner indirection).
  * Execution is streaming with a bounded in-flight window: consuming
    ``iter_batches`` keeps at most ``window`` map tasks live, so a
    pipeline over a large dataset never materializes it.
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata, VALUE_COL


# --------------------------------------------------------------------------
# Lazy op chain


class ActorPoolStrategy:
    """compute= strategy for map_batches: run the UDF in a pool of
    long-lived actors instead of stateless tasks (reference:
    `_internal/execution/operators/actor_pool_map_operator.py`) — for
    stateful/expensive-setup UDFs (model inference)."""

    def __init__(self, size: int = 2, num_cpus: float = 1,
                 num_tpus: float = 0):
        self.size = size
        self.num_cpus = num_cpus
        self.num_tpus = num_tpus


class _OpSpec:
    """One logical transform; a chain of these fuses into one task."""

    __slots__ = ("kind", "fn", "batch_size", "batch_format", "fn_kwargs",
                 "compute")

    def __init__(self, kind: str, fn: Callable, batch_size=None,
                 batch_format: str = "numpy", fn_kwargs: Optional[dict] = None,
                 compute: Optional[ActorPoolStrategy] = None):
        self.kind = kind
        self.fn = fn
        self.batch_size = batch_size
        self.batch_format = batch_format
        self.fn_kwargs = fn_kwargs or {}
        self.compute = compute

    def __repr__(self):
        return f"_OpSpec({self.kind}, {getattr(self.fn, '__name__', self.fn)})"


def _apply_ops(block: Block, ops: List[_OpSpec]) -> Block:
    for op in ops:
        acc = BlockAccessor.for_block(block)
        if op.kind == "map_batches":
            n = acc.num_rows()
            bs = op.batch_size or max(n, 1)
            outs = []
            for start in range(0, max(n, 1), bs):
                if n == 0 and start > 0:
                    break
                batch = BlockAccessor.for_block(
                    acc.slice(start, min(start + bs, n))
                ).to_batch(op.batch_format)
                outs.append(BlockAccessor.batch_to_block(
                    op.fn(batch, **op.fn_kwargs)))
            block = BlockAccessor.concat(outs)
        elif op.kind == "map":
            block = BlockAccessor.rows_to_block(
                [op.fn(row, **op.fn_kwargs) for row in acc.iter_rows()])
        elif op.kind == "flat_map":
            rows: List[Any] = []
            for row in acc.iter_rows():
                rows.extend(op.fn(row, **op.fn_kwargs))
            block = BlockAccessor.rows_to_block(rows)
        elif op.kind == "filter":
            block = BlockAccessor.rows_to_block(
                [row for row in acc.iter_rows() if op.fn(row, **op.fn_kwargs)])
        else:
            raise ValueError(f"unknown op kind {op.kind!r}")
    return block


# --------------------------------------------------------------------------
# Task bodies (run in ray_tpu_torch workers)


def _map_block_task(ops: List[_OpSpec], block: Block):
    out = _apply_ops(block, ops)
    return out, BlockAccessor.for_block(out).metadata()


def _read_task(read_fn: Callable, ops: List[_OpSpec]):
    """Fused read+transform: the reader produces the block in the worker,
    so the driver never touches raw bytes (reference: read tasks)."""
    out = _apply_ops(read_fn(), ops)
    return out, BlockAccessor.for_block(out).metadata()


def _slice_task(block: Block, start: int, end: int):
    out = BlockAccessor.for_block(block).slice(start, end)
    return out, BlockAccessor.for_block(out).metadata()


def _concat_task(*blocks: Block):
    out = BlockAccessor.concat(list(blocks))
    return out, BlockAccessor.for_block(out).metadata()


def _zip_task(b1: Block, b2: Block):
    a1, a2 = BlockAccessor.for_block(b1), BlockAccessor.for_block(b2)
    if a1.num_rows() != a2.num_rows():
        raise ValueError(
            f"zip: block row counts differ ({a1.num_rows()} vs "
            f"{a2.num_rows()})")
    if isinstance(b1, dict) and isinstance(b2, dict):
        out = dict(b1)
        for k, v in b2.items():
            name = k
            i = 1
            while name in out:  # find a free suffix, never clobber
                name = f"{k}_{i}"
                i += 1
            out[name] = v
    else:
        out = [(r1, r2) for r1, r2 in zip(a1.iter_rows(), a2.iter_rows())]
    return out, BlockAccessor.for_block(out).metadata()


def _stable_hash(k) -> int:
    """Process-independent key hash: Python's str hashing is randomized
    per process, which would scatter one key across partitions when each
    block partitions in a different worker."""
    import hashlib

    return int.from_bytes(
        hashlib.md5(str(k).encode()).digest()[:8], "little")


def _hash_partition_task(block: Block, key, n_parts: int):
    """Split a block into n_parts by hash(key) — one RETURN PER PART
    (num_returns=n_parts), so each downstream group task ships only its
    own partition, not the whole dataset."""
    acc = BlockAccessor.for_block(block)
    buckets: List[List[Any]] = [[] for _ in range(n_parts)]
    for row in acc.iter_rows():
        k = row[key] if not callable(key) else key(row)
        buckets[_stable_hash(k) % n_parts].append(row)
    blocks = [BlockAccessor.rows_to_block(rows) for rows in buckets]
    return blocks[0] if n_parts == 1 else blocks


def _group_apply_task(key, fn, batch_format: str, *parts):
    """Gather one hash partition from every block, group rows by key, and
    apply ``fn`` per group (reference: map_groups)."""
    rows: List[Any] = []
    for part in parts:
        rows.extend(BlockAccessor.for_block(part).iter_rows())
    keyfn = key if callable(key) else (lambda r: r[key])
    groups: dict = {}
    for row in rows:
        groups.setdefault(keyfn(row), []).append(row)
    outs = []
    for k in sorted(groups, key=lambda x: (str(type(x)), x)):
        if batch_format == "rows":
            gbatch = groups[k]
        else:
            gblock = BlockAccessor.rows_to_block(groups[k])
            gbatch = BlockAccessor.for_block(gblock).to_batch(batch_format)
        res = fn(gbatch)
        outs.append(res if isinstance(res, list)
                    else BlockAccessor.batch_to_block(res))
    outs = [BlockAccessor.rows_to_block(o) if isinstance(o, list) else o
            for o in outs]
    out = (BlockAccessor.concat(outs) if outs
           else BlockAccessor.rows_to_block([]))
    return out, BlockAccessor.for_block(out).metadata()


def _shuffle_split_task(block: Block, n: int, seed: int):
    """Stage 1 of the 2-stage random shuffle: scatter rows into n parts."""
    acc = BlockAccessor.for_block(block)
    rows = acc.num_rows()
    rng = np.random.default_rng(seed)
    assignment = rng.integers(0, n, size=rows)
    return tuple(acc.take_rows(np.nonzero(assignment == j)[0])
                 for j in range(n))


def _shuffle_merge_task(seed: int, *parts: Block):
    """Stage 2: concat this output block's parts and shuffle within."""
    block = BlockAccessor.concat(list(parts))
    acc = BlockAccessor.for_block(block)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(acc.num_rows())
    out = acc.take_rows(perm)
    return out, BlockAccessor.for_block(out).metadata()


def _sort_partition_task(block: Block, key, boundaries: list, descending: bool):
    """Range-partition rows of a block by key against sampled boundaries."""
    acc = BlockAccessor.for_block(block)
    keys = _sort_keys(block, key)
    idx = np.searchsorted(np.asarray(boundaries), keys, side="right")
    if descending:
        idx = len(boundaries) - idx
    return tuple(acc.take_rows(np.nonzero(idx == j)[0])
                 for j in range(len(boundaries) + 1))


def _sort_merge_task(key, descending: bool, *parts: Block):
    block = BlockAccessor.concat(list(parts))
    keys = _sort_keys(block, key)
    order = np.argsort(keys, kind="stable")
    if descending:
        order = order[::-1]
    out = BlockAccessor.for_block(block).take_rows(order)
    return out, BlockAccessor.for_block(out).metadata()


def _sort_keys(block: Block, key) -> np.ndarray:
    acc = BlockAccessor.for_block(block)
    if callable(key):
        return np.asarray([key(r) for r in acc.iter_rows()])
    if isinstance(block, dict):
        col = key if key is not None else next(iter(block))
        return np.asarray(block[col])
    return np.asarray(list(acc.iter_rows()))


def _agg_task(ops: List[_OpSpec], block: Block, on: Optional[str], kind: str):
    block = _apply_ops(block, ops)
    acc = BlockAccessor.for_block(block)
    if acc.num_rows() == 0:
        return None
    if isinstance(block, dict):
        col = on if on is not None else VALUE_COL
        vals = np.asarray(block[col], dtype=np.float64)
    else:
        vals = np.asarray(block, dtype=np.float64)
    if kind == "sum":
        return float(vals.sum())
    if kind == "min":
        return float(vals.min())
    if kind == "max":
        return float(vals.max())
    if kind == "mean":
        return float(vals.sum()), int(vals.size)
    raise ValueError(kind)


# Lazily-created RemoteFunction wrappers (module import must not require an
# initialized runtime).
_REMOTES: Dict[Any, Any] = {}


def _remote(fn, **opts):
    key = (fn, tuple(sorted(opts.items())))
    if key not in _REMOTES:
        _REMOTES[key] = ray_tpu_torch.remote(**opts)(fn) if opts else ray_tpu_torch.remote(fn)
    return _REMOTES[key]


# --------------------------------------------------------------------------
# Streaming executor


DEFAULT_WINDOW = 16


class _SplitCoordinator:
    """Streaming-split claim server (runs as a zero-CPU actor): each
    epoch's block indices are claimed exactly once across all shards."""

    def __init__(self, n_blocks: int):
        self._n = n_blocks
        self._next: Dict[int, int] = {}  # epoch -> next unclaimed index

    def claim(self, epoch: int) -> Optional[int]:
        nxt = self._next.get(epoch, 0)
        if nxt >= self._n:
            return None
        self._next[epoch] = nxt + 1
        return nxt


class _Source:
    """A pending block: either an existing ref or an unread read task."""

    __slots__ = ("ref", "read_fn")

    def __init__(self, ref=None, read_fn=None):
        self.ref = ref
        self.read_fn = read_fn


class _MapWorker:
    """Actor hosting the actor-compute suffix of an op chain; class UDFs
    instantiate once here (reference: ActorPoolMapOperator's workers)."""

    def __init__(self, ops: List[_OpSpec]):
        self._ops = []
        for op in ops:
            if isinstance(op.fn, type):
                op = _OpSpec(op.kind, op.fn(), op.batch_size,
                             op.batch_format, op.fn_kwargs)
            self._ops.append(op)

    def apply(self, block: Block):
        out = _apply_ops(block, self._ops)
        return out, BlockAccessor.for_block(out).metadata()


def _actor_stage(block_iter, actor_ops: List[_OpSpec],
                 strategy: "ActorPoolStrategy", window: int):
    """Pipe (ref, meta_ref) pairs through a round-robin actor pool."""
    import itertools as _it

    worker_cls = ray_tpu_torch.remote(
        num_cpus=strategy.num_cpus, num_tpus=strategy.num_tpus,
        max_restarts=1)(_MapWorker)
    actors = [worker_cls.remote(actor_ops) for _ in range(strategy.size)]
    rr = _it.cycle(actors)
    inflight: deque = deque()
    try:
        for ref, _meta in block_iter:
            while len(inflight) >= window:
                yield inflight.popleft()
            out = next(rr).apply.options(num_returns=2).remote(ref)
            inflight.append(tuple(out))
        while inflight:
            yield inflight.popleft()
    finally:
        for a in actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:  # noqa: BLE001
                pass


def _batches_from_block_iter(block_iter, *, batch_size: int,
                             batch_format: str, drop_last: bool,
                             local_shuffle_buffer_size=None,
                             local_shuffle_seed=None):
    """Assemble fixed-size batches from a stream of LOCAL blocks — shared
    by Dataset.iter_batches and the streaming-split shard iterators."""
    rng = (np.random.default_rng(local_shuffle_seed)
           if local_shuffle_buffer_size else None)
    # carry: deque of (block, offset) — rows [offset:] are unconsumed.
    # Slicing from the front instead of re-concatenating the remainder
    # keeps iteration linear (each row is copied at most once).
    carry: deque = deque()
    carry_rows = 0
    shuffle_buf: List[Block] = []
    shuffle_rows = 0

    def emit(block: Block) -> Iterator[Any]:
        nonlocal carry_rows
        n = BlockAccessor.for_block(block).num_rows()
        if n:
            carry.append((block, 0))
            carry_rows += n
        while carry_rows >= batch_size:
            need = batch_size
            parts: List[Block] = []
            while need > 0:
                blk, off = carry[0]
                acc = BlockAccessor.for_block(blk)
                avail = acc.num_rows() - off
                take = min(avail, need)
                parts.append(acc.slice(off, off + take))
                need -= take
                if take == avail:
                    carry.popleft()
                else:
                    carry[0] = (blk, off + take)
            carry_rows -= batch_size
            batch = (parts[0] if len(parts) == 1
                     else BlockAccessor.concat(parts))
            yield BlockAccessor.for_block(batch).to_batch(batch_format)

    def through_shuffle(block: Block) -> Iterator[Block]:
        nonlocal shuffle_buf, shuffle_rows
        if rng is None:
            yield block
            return
        shuffle_buf.append(block)
        shuffle_rows += BlockAccessor.for_block(block).num_rows()
        if shuffle_rows >= local_shuffle_buffer_size:
            merged = BlockAccessor.concat(shuffle_buf)
            acc = BlockAccessor.for_block(merged)
            perm = rng.permutation(acc.num_rows())
            shuffle_buf, shuffle_rows = [], 0
            yield acc.take_rows(perm)

    for block in block_iter:
        for shuffled in through_shuffle(block):
            yield from emit(shuffled)
    if shuffle_buf:
        merged = BlockAccessor.concat(shuffle_buf)
        acc = BlockAccessor.for_block(merged)
        perm = rng.permutation(acc.num_rows())
        yield from emit(acc.take_rows(perm))
    if carry_rows and not drop_last:
        merged = BlockAccessor.concat(
            [BlockAccessor.for_block(b).slice(
                off, BlockAccessor.for_block(b).num_rows())
             for b, off in carry])
        if BlockAccessor.for_block(merged).num_rows():
            yield BlockAccessor.for_block(merged).to_batch(batch_format)


def _stream_blocks(sources: List[_Source], ops: List[_OpSpec],
                   window: int = DEFAULT_WINDOW
                   ) -> Iterator[Tuple[Any, Any]]:
    """Run the fused op chain over blocks with at most ``window`` tasks in
    flight; yields (block_ref, meta_ref) in input order as tasks finish.
    Ops from the first actor-compute op onward run in an actor pool stage.

    Reference analogue: `streaming_executor.py:49` — bounded, pull-based.
    """
    compute_idx = [i for i, op in enumerate(ops) if op.compute is not None]
    if compute_idx:
        # pipeline of stages: each actor-compute op starts its OWN pool
        # (with its own size/resources); following compute-less ops fuse
        # into that stage until the next compute op
        first = compute_idx[0]
        it = _stream_blocks(sources, ops[:first], window)
        bounds = compute_idx + [len(ops)]
        for a, b in zip(bounds[:-1], bounds[1:]):
            it = _actor_stage(it, ops[a:b], ops[a].compute, window)
        yield from it
        return
    map_remote = _remote(_map_block_task, num_returns=2)
    read_remote = _remote(_read_task, num_returns=2)
    pending: deque = deque()
    src_iter = iter(sources)

    def submit_next() -> bool:
        src = next(src_iter, None)
        if src is None:
            return False
        if src.read_fn is not None:
            pending.append(read_remote.remote(src.read_fn, ops))
        elif ops:
            pending.append(map_remote.remote(ops, src.ref))
        else:
            pending.append((src.ref, None))
        return True

    while True:
        while len(pending) < window and submit_next():
            pass
        if not pending:
            return
        yield pending.popleft()


class _ExecutedBlock:
    __slots__ = ("ref", "meta_ref", "_meta")

    def __init__(self, ref, meta_ref=None, meta=None):
        self.ref = ref
        self.meta_ref = meta_ref
        self._meta = meta

    def meta(self) -> BlockMetadata:
        if self._meta is None:
            if self.meta_ref is not None:
                self._meta = ray_tpu_torch.get(self.meta_ref)
            else:
                self._meta = BlockAccessor.for_block(
                    ray_tpu_torch.get(self.ref)).metadata()
        return self._meta


# --------------------------------------------------------------------------


class Dataset:
    """A distributed dataset of blocks with a lazy transform chain.

    Reference analogue: `python/ray/data/dataset.py` (``Dataset``).
    """

    def __init__(self, sources: List[_Source], ops: Optional[List[_OpSpec]] = None,
                 metas: Optional[List[Optional[BlockMetadata]]] = None):
        self._sources = sources
        self._ops: List[_OpSpec] = list(ops or [])
        # per-source metadata, only valid when no ops are pending
        self._metas = metas if metas is not None else [None] * len(sources)

    # ------------------------------------------------------------ factory

    @staticmethod
    def from_block_refs(refs: List[Any],
                        metas: Optional[List[BlockMetadata]] = None) -> "Dataset":
        return Dataset([_Source(ref=r) for r in refs], metas=metas)

    @staticmethod
    def from_read_fns(read_fns: List[Callable]) -> "Dataset":
        return Dataset([_Source(read_fn=f) for f in read_fns])

    # ------------------------------------------------------------ transforms

    def _with_op(self, op: _OpSpec) -> "Dataset":
        return Dataset(self._sources, self._ops + [op])

    def map_batches(self, fn: Callable, *, batch_size: Optional[int] = None,
                    batch_format: str = "numpy",
                    compute: Optional[ActorPoolStrategy] = None,
                    **fn_kwargs) -> "Dataset":
        """Apply ``fn`` to batches (reference: `dataset.py:385`).  With
        ``compute=ActorPoolStrategy(...)`` the UDF runs in a pool of
        actors; ``fn`` may then be a CLASS (instantiated once per actor —
        the stateful-inference pattern)."""
        if isinstance(fn, type) and compute is None:
            raise ValueError(
                "class UDFs need compute=ActorPoolStrategy(...) — the "
                "instance lives in the pool actors")
        return self._with_op(_OpSpec("map_batches", fn, batch_size,
                                     batch_format, fn_kwargs, compute))

    def map(self, fn: Callable, **fn_kwargs) -> "Dataset":
        return self._with_op(_OpSpec("map", fn, fn_kwargs=fn_kwargs))

    def flat_map(self, fn: Callable, **fn_kwargs) -> "Dataset":
        return self._with_op(_OpSpec("flat_map", fn, fn_kwargs=fn_kwargs))

    def filter(self, fn: Callable, **fn_kwargs) -> "Dataset":
        return self._with_op(_OpSpec("filter", fn, fn_kwargs=fn_kwargs))

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        def add(batch):
            batch[name] = np.asarray(fn(batch))
            return batch
        return self.map_batches(add)

    def drop_columns(self, cols: List[str]) -> "Dataset":
        def drop(batch):
            return {k: v for k, v in batch.items() if k not in cols}
        return self.map_batches(drop)

    def select_columns(self, cols: List[str]) -> "Dataset":
        def select(batch):
            return {k: batch[k] for k in cols}
        return self.map_batches(select)

    # ------------------------------------------------------------ execution

    def materialize(self) -> "Dataset":
        """Execute the pending chain; returns a Dataset of concrete refs."""
        if not self._ops and all(s.read_fn is None for s in self._sources):
            return self
        refs, metas = [], []
        for ref, meta_ref in _stream_blocks(self._sources, self._ops):
            refs.append(ref)
            metas.append(ray_tpu_torch.get(meta_ref) if meta_ref is not None
                         else None)
        metas = [m if m is not None
                 else BlockAccessor.for_block(ray_tpu_torch.get(r)).metadata()
                 for r, m in zip(refs, metas)]
        return Dataset.from_block_refs(refs, metas)

    def _stream(self, window: int = DEFAULT_WINDOW) -> Iterator[_ExecutedBlock]:
        for i, (ref, meta_ref) in enumerate(
                _stream_blocks(self._sources, self._ops, window)):
            meta = None
            if meta_ref is None and not self._ops:
                meta = self._metas[i]
            yield _ExecutedBlock(ref, meta_ref, meta)

    # ------------------------------------------------------------ consumption

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str = "numpy", drop_last: bool = False,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None,
                     prefetch_blocks: int = DEFAULT_WINDOW
                     ) -> Iterator[Any]:
        """Stream batches; at most ``prefetch_blocks`` map tasks in flight."""
        return _batches_from_block_iter(
            (ray_tpu_torch.get(eb.ref) for eb in self._stream(prefetch_blocks)),
            batch_size=batch_size, batch_format=batch_format,
            drop_last=drop_last,
            local_shuffle_buffer_size=local_shuffle_buffer_size,
            local_shuffle_seed=local_shuffle_seed)

    def write_parquet(self, path: str,
                      timeout_s: float = 600.0) -> List[str]:
        """One parquet file per block under ``path`` (reference:
        ``Dataset.write_parquet`` / `data/datasource/parquet_datasink`);
        runs as distributed tasks, returns the written file paths."""
        return self._write_files(path, "parquet", timeout_s)

    def write_tfrecords(self, path: str,
                        timeout_s: float = 600.0) -> List[str]:
        """One TFRecord file per block (reference:
        ``Dataset.write_tfrecords``); `tf.train.Example` framing with real
        CRC32C checksums via the built-in codec — no tensorflow."""
        return self._write_files(path, "tfrecords", timeout_s)

    def write_csv(self, path: str, timeout_s: float = 600.0) -> List[str]:
        """One CSV file per block (reference: ``Dataset.write_csv``)."""
        return self._write_files(path, "csv", timeout_s)

    def write_json(self, path: str, timeout_s: float = 600.0) -> List[str]:
        """One JSON-lines file per block (reference:
        ``Dataset.write_json``)."""
        return self._write_files(path, "json", timeout_s)

    def _write_files(self, path: str, fmt: str,
                     timeout_s: float = 600.0) -> List[str]:
        import os as _os

        import ray_tpu_torch

        _os.makedirs(path, exist_ok=True)

        @ray_tpu_torch.remote
        def write_block(block: Block, out_path: str, fmt: str) -> str:
            acc = BlockAccessor.for_block(block)
            if fmt == "parquet":
                import pyarrow.parquet as pq

                pq.write_table(acc.to_batch("pyarrow"), out_path)
            elif fmt == "csv":
                acc.to_batch("pandas").to_csv(out_path, index=False)
            elif fmt == "tfrecords":
                import struct as _struct

                from ray_tpu_torch.data.read_api import (
                    _encode_example, _masked_crc,
                )

                with open(out_path, "wb") as f:
                    for row in acc.iter_rows():
                        payload = _encode_example(row)
                        hdr = _struct.pack("<Q", len(payload))
                        f.write(hdr)
                        f.write(_struct.pack("<I", _masked_crc(hdr)))
                        f.write(payload)
                        f.write(_struct.pack("<I", _masked_crc(payload)))
            else:  # json lines
                acc.to_batch("pandas").to_json(out_path, orient="records",
                                               lines=True)
            return out_path

        refs = []
        for i, eb in enumerate(self._stream()):
            out_path = _os.path.join(path, f"part-{i:05d}.{fmt}")
            refs.append(write_block.remote(eb.ref, out_path, fmt))
        return ray_tpu_torch.get(refs, timeout=timeout_s)

    def iter_torch_batches(self, *, batch_size: int = 256,
                           dtypes=None, device: str = "cuda",
                           drop_last: bool = False,
                           local_shuffle_buffer_size: Optional[int] = None,
                           local_shuffle_seed: Optional[int] = None):
        """Batches as dicts of torch tensors (reference:
        ``Dataset.iter_torch_batches`` / `iterator.py`); columnar numpy
        blocks convert zero-copy via ``torch.from_numpy``.  On the card by
        default (raising where none is present); ``device="cpu"`` keeps
        them on the host."""
        import torch

        from ray_tpu_torch.data.iterator import _torch_device

        device = _torch_device(device)
        for batch in self.iter_batches(
                batch_size=batch_size, batch_format="numpy",
                drop_last=drop_last,
                local_shuffle_buffer_size=local_shuffle_buffer_size,
                local_shuffle_seed=local_shuffle_seed):
            out = {}
            for k, v in batch.items():
                t = torch.from_numpy(np.ascontiguousarray(v))
                if dtypes is not None:
                    want = dtypes.get(k) if isinstance(dtypes, dict) \
                        else dtypes
                    if want is not None:
                        t = t.to(want)
                if device.type != "cpu":
                    t = t.to(device)
                out[k] = t
            yield out

    def iter_rows(self) -> Iterator[Any]:
        for eb in self._stream():
            yield from BlockAccessor.for_block(ray_tpu_torch.get(eb.ref)).iter_rows()

    def take(self, n: int = 20) -> List[Any]:
        out: List[Any] = []
        for eb in self._stream(window=4):
            out.extend(itertools.islice(
                BlockAccessor.for_block(ray_tpu_torch.get(eb.ref)).iter_rows(),
                n - len(out)))
            if len(out) >= n:
                break
        return out[:n]

    def take_all(self) -> List[Any]:
        out: List[Any] = []
        for eb in self._stream():
            out.extend(BlockAccessor.for_block(ray_tpu_torch.get(eb.ref)).iter_rows())
        return out

    def show(self, n: int = 20):
        for row in self.take(n):
            print(row)

    def count(self) -> int:
        if not self._ops and all(m is not None for m in self._metas):
            return sum(m.num_rows for m in self._metas)
        return sum(eb.meta().num_rows for eb in self.materialize()._stream())

    def num_blocks(self) -> int:
        return len(self._sources)

    def size_bytes(self) -> int:
        ds = self.materialize()
        return sum(m.size_bytes for m in ds._metas)

    def schema(self):
        for eb in self._stream(window=1):
            return eb.meta().schema
        return None

    def stats(self) -> str:
        ds = self.materialize()
        return (f"Dataset(num_blocks={ds.num_blocks()}, "
                f"num_rows={ds.count()}, size_bytes={ds.size_bytes()})")

    # ------------------------------------------------------------ reshaping

    def repartition(self, num_blocks: int) -> "Dataset":
        ds = self.materialize()
        total = ds.count()
        sizes = [total // num_blocks + (1 if i < total % num_blocks else 0)
                 for i in range(num_blocks)]
        return ds._repartition_by_sizes(sizes)

    def _repartition_by_sizes(self, sizes: List[int]) -> "Dataset":
        """Build len(sizes) output blocks with the given exact row counts
        (self must be materialized)."""
        slice_remote = _remote(_slice_task, num_returns=2)
        concat_remote = _remote(_concat_task, num_returns=2)
        rows = [m.num_rows for m in self._metas]
        refs = [s.ref for s in self._sources]
        out_refs, out_metas = [], []
        block_i, offset = 0, 0
        for target in sizes:
            parts = []  # refs of slices composing this output block
            need = target
            while need > 0 and block_i < len(refs):
                avail = rows[block_i] - offset
                take = min(avail, need)
                if take == rows[block_i] and offset == 0:
                    parts.append((refs[block_i], self._metas[block_i]))
                else:
                    r, m = slice_remote.remote(refs[block_i], offset,
                                               offset + take)
                    parts.append((r, m))
                need -= take
                offset += take
                if offset >= rows[block_i]:
                    block_i += 1
                    offset = 0
            if len(parts) == 1:
                ref, meta = parts[0]
                out_refs.append(ref)
                out_metas.append(meta)
            else:
                r, m = concat_remote.remote(*[p[0] for p in parts])
                out_refs.append(r)
                out_metas.append(m)
        out_metas = [m if isinstance(m, BlockMetadata) else ray_tpu_torch.get(m)
                     for m in out_metas]
        return Dataset.from_block_refs(out_refs, out_metas)

    def split(self, n: int, *, equal: bool = False,
              locality_hints=None) -> List["Dataset"]:
        """Split into n datasets (reference: `dataset.py` ``split``);
        ``equal=True`` splits at exact row boundaries."""
        ds = self.materialize()
        if equal:
            total = ds.count()
            per = total // n
            resized = ds._repartition_by_sizes([per] * n)
            return [Dataset([resized._sources[i]],
                            metas=[resized._metas[i]]) for i in range(n)]
        # block-granularity split, balanced by rows
        shards: List[List[int]] = [[] for _ in range(n)]
        loads = [0] * n
        order = sorted(range(len(ds._sources)),
                       key=lambda i: -ds._metas[i].num_rows)
        for i in order:
            j = loads.index(min(loads))
            shards[j].append(i)
            loads[j] += ds._metas[i].num_rows
        for s in shards:
            s.sort()
        return [Dataset([ds._sources[i] for i in idxs],
                        metas=[ds._metas[i] for i in idxs])
                for idxs in shards]

    def streaming_split(self, n: int, *, equal: bool = False,
                        locality_hints=None) -> List[Any]:
        """N iterators consuming DISJOINT streamed shards of this dataset
        without up-front materialization (reference:
        `python/ray/data/_internal/iterator/stream_split_iterator.py:1`).

        A coordinator actor hands out block indices on demand, so fast
        consumers take more blocks (pull-based balancing) and each block
        executes through the lazy op chain only when claimed.  The shards
        jointly cover every block exactly once per epoch; iterating a
        shard again starts a new epoch over a fresh claim sequence.
        ``equal`` is accepted for API parity (block-granular splits are
        balanced by the pull loop, not by row counts)."""
        import ray_tpu_torch
        from ray_tpu_torch.data.iterator import StreamSplitDataIterator

        if any(op.compute is not None for op in self._ops):
            raise ValueError(
                "streaming_split does not support actor-compute op chains; "
                "materialize() the actor stage first")
        coord = ray_tpu_torch.remote(num_cpus=0)(_SplitCoordinator).remote(
            len(self._sources))
        return [StreamSplitDataIterator(self, coord, i, n)
                for i in range(n)]

    def _execute_block(self, i: int):
        """Submit source ``i`` through the (task-only) op chain; returns a
        block ref — the streaming-split shard prefetch path."""
        src = self._sources[i]
        if src.read_fn is not None:
            ref, _ = _remote(_read_task, num_returns=2).remote(
                src.read_fn, self._ops)
        elif self._ops:
            ref, _ = _remote(_map_block_task, num_returns=2).remote(
                self._ops, src.ref)
        else:
            ref = src.ref
        return ref

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        """Distributed 2-stage shuffle (reference:
        `_internal/push_based_shuffle.py` — scatter then merge)."""
        ds = self.materialize()
        n = max(len(ds._sources), 1)
        base = seed if seed is not None else np.random.randint(0, 2 ** 31)
        merge_remote = _remote(_shuffle_merge_task, num_returns=2)
        if n == 1:
            # single block: one merge task shuffles in place (num_returns=n
            # would wrap the scatter's 1-tuple as a single object)
            r, m = merge_remote.remote(base, ds._sources[0].ref)
            return Dataset.from_block_refs([r], [ray_tpu_torch.get(m)])
        split_remote = _remote(_shuffle_split_task, num_returns=n)
        parts = []  # parts[i][j]: part j of input block i
        for i, s in enumerate(ds._sources):
            parts.append(split_remote.remote(s.ref, n, base + i))
        out_refs, out_meta_refs = [], []
        for j in range(n):
            r, m = merge_remote.remote(base + 7919 * (j + 1),
                                       *[parts[i][j] for i in range(len(parts))])
            out_refs.append(r)
            out_meta_refs.append(m)
        return Dataset.from_block_refs(out_refs, ray_tpu_torch.get(out_meta_refs))

    def randomize_block_order(self, *, seed: Optional[int] = None) -> "Dataset":
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self._sources))
        return Dataset([self._sources[i] for i in order], self._ops,
                       [self._metas[i] for i in order])

    def sort(self, key=None, descending: bool = False) -> "Dataset":
        """Distributed sample-based range-partition sort (reference:
        `_internal/sort.py`)."""
        ds = self.materialize()
        n = max(len(ds._sources), 1)
        if n == 1:
            merge_remote = _remote(_sort_merge_task, num_returns=2)
            r, m = merge_remote.remote(key, descending, ds._sources[0].ref)
            return Dataset.from_block_refs([r], [ray_tpu_torch.get(m)])
        # sample boundaries from each block
        def _sample(block, key):
            keys = _sort_keys(block, key)
            if len(keys) == 0:
                return []
            idx = np.random.default_rng(0).integers(0, len(keys), size=8)
            return keys[idx].tolist()

        sample_remote = _remote(_sample)
        samples = list(itertools.chain.from_iterable(ray_tpu_torch.get(
            [sample_remote.remote(s.ref, key) for s in ds._sources])))
        samples.sort()
        boundaries = [samples[min(int(len(samples) * (j + 1) / n),
                                  len(samples) - 1)]
                      for j in range(n - 1)] if samples else []
        nparts = len(boundaries) + 1
        merge_remote = _remote(_sort_merge_task, num_returns=2)
        if nparts == 1:
            # all-empty samples: one global merge (num_returns=1 would wrap
            # the partition task's 1-tuple as a single object)
            r, m = merge_remote.remote(key, descending,
                                       *[s.ref for s in ds._sources])
            return Dataset.from_block_refs([r], [ray_tpu_torch.get(m)])
        part_remote = _remote(_sort_partition_task, num_returns=nparts)
        parts = []
        for s in ds._sources:
            parts.append(part_remote.remote(s.ref, key, boundaries, descending))
        out_refs, out_metas = [], []
        for j in range(nparts):
            r, m = merge_remote.remote(key, descending,
                                       *[parts[i][j] for i in range(len(parts))])
            out_refs.append(r)
            out_metas.append(m)
        return Dataset.from_block_refs(out_refs, ray_tpu_torch.get(out_metas))

    def train_test_split(self, test_size: float, *,
                         shuffle: bool = False,
                         seed: Optional[int] = None
                         ) -> Tuple["Dataset", "Dataset"]:
        """(train, test) row split (reference: ``Dataset.train_test_split``).
        ``test_size`` is a fraction in (0, 1)."""
        if not 0 < test_size < 1:
            raise ValueError("test_size must be in (0, 1)")
        ds = self.random_shuffle(seed=seed) if shuffle else self
        ds = ds.materialize()
        total = ds.count()
        n_test = max(1, int(total * test_size))
        if total < 2 or n_test >= total:
            raise ValueError(
                f"cannot split {total} row(s) with test_size={test_size} "
                "(both splits must be non-empty)")
        parts = ds._repartition_by_sizes([total - n_test, n_test])
        return (Dataset([parts._sources[0]], metas=[parts._metas[0]]),
                Dataset([parts._sources[1]], metas=[parts._metas[1]]))

    def union(self, *others: "Dataset") -> "Dataset":
        ds = [self.materialize()] + [o.materialize() for o in others]
        return Dataset([s for d in ds for s in d._sources],
                       metas=[m for d in ds for m in d._metas])

    def zip(self, other: "Dataset") -> "Dataset":
        """Column-wise zip of two datasets with equal row counts."""
        a = self.materialize()
        b = other.materialize()
        rows_a = [m.num_rows for m in a._metas]
        b = b._repartition_by_sizes(rows_a)

        def _zip_task(x: Block, y: Block):
            ax, ay = BlockAccessor.for_block(x), BlockAccessor.for_block(y)
            if not (ax.is_table and ay.is_table):
                out: Block = [(r1, r2) for r1, r2
                              in zip(ax.iter_rows(), ay.iter_rows())]
            else:
                out = dict(x)
                for k, v in y.items():
                    out[k if k not in out else f"{k}_1"] = v
            return out, BlockAccessor.for_block(out).metadata()

        zr = _remote(_zip_task, num_returns=2)
        out_refs, out_metas = [], []
        for sa, sb in zip(a._sources, b._sources):
            r, m = zr.remote(sa.ref, sb.ref)
            out_refs.append(r)
            out_metas.append(m)
        return Dataset.from_block_refs(out_refs, ray_tpu_torch.get(out_metas))

    def limit(self, n: int) -> "Dataset":
        """Truncate to the first n rows (streams only what's needed)."""
        refs, metas = [], []
        got = 0
        slice_remote = _remote(_slice_task, num_returns=2)
        for eb in self._stream(window=4):
            meta = eb.meta()
            if got + meta.num_rows <= n:
                refs.append(eb.ref)
                metas.append(meta)
                got += meta.num_rows
            else:
                r, m = slice_remote.remote(eb.ref, 0, n - got)
                refs.append(r)
                metas.append(ray_tpu_torch.get(m))
                got = n
            if got >= n:
                break
        return Dataset.from_block_refs(refs, metas)

    # ------------------------------------------------------------ combine

    def union(self, *others: "Dataset") -> "Dataset":
        """Concatenate datasets (reference: `dataset.py` ``union``)."""
        parts = [self.materialize()] + [o.materialize() for o in others]
        sources = [s for d in parts for s in d._sources]
        metas = [m for d in parts for m in d._metas]
        return Dataset(sources, metas=metas)

    def zip(self, other: "Dataset") -> "Dataset":
        """Row-aligned combine (reference ``zip``): dict blocks merge
        columns (suffix `_1` on collision), row blocks become tuples.
        The right side is re-sliced to the left side's block boundaries."""
        left = self.materialize()
        right = other.materialize()
        n_left = sum(eb.meta().num_rows for eb in left._stream())
        n_right = sum(eb.meta().num_rows for eb in right._stream())
        if n_left != n_right:
            raise ValueError(
                f"zip: datasets have different row counts "
                f"({n_left} vs {n_right})")
        right = right.repartition_like(left)
        zip_remote = _remote(_zip_task, num_returns=2)
        refs, meta_refs = [], []
        for l, r in zip(left._sources, right._sources):
            br, mr = zip_remote.remote(l.ref, r.ref)
            refs.append(br)
            meta_refs.append(mr)
        return Dataset.from_block_refs(
            refs, ray_tpu_torch.get(meta_refs) if meta_refs else [])

    def repartition_like(self, other: "Dataset") -> "Dataset":
        """Re-slice into the same per-block row counts as ``other``."""
        me = self.materialize()
        target = [eb.meta().num_rows for eb in other.materialize()._stream()]
        mine = [eb.meta().num_rows for eb in me._stream()]
        if sum(target) != sum(mine):
            raise ValueError(
                f"repartition_like: row counts differ "
                f"({sum(mine)} vs {sum(target)})")
        if target == mine:
            return me
        slice_remote = _remote(_slice_task, num_returns=2)
        concat_remote = _remote(_concat_task, num_returns=2)
        pieces: deque = deque()  # (ref, rows_remaining, offset)
        for s, n in zip(me._sources, mine):
            pieces.append([s.ref, n, 0])
        refs, metas = [], []
        for want in target:
            got = 0
            segs = []
            while got < want:
                ref, n, off = pieces[0]
                take = min(want - got, n - off)
                r, _m = slice_remote.remote(ref, off, off + take)
                segs.append(r)
                got += take
                pieces[0][2] += take
                if pieces[0][2] >= n:
                    pieces.popleft()
            if len(segs) == 1:
                br, mr = segs[0], None
            else:
                br, mr = concat_remote.remote(*segs)
            refs.append(br)
            metas.append(mr)
        fetched = ray_tpu_torch.get([m for m in metas if m is not None]) \
            if any(m is not None for m in metas) else []
        out_metas, fi = [], 0
        for m in metas:
            if m is None:
                out_metas.append(None)
            else:
                out_metas.append(fetched[fi])
                fi += 1
        return Dataset.from_block_refs(refs, out_metas)

    def groupby(self, key) -> "GroupedData":
        """Group rows by a column name (dict blocks) or key callable
        (reference: `dataset.py` ``groupby`` -> GroupedData)."""
        return GroupedData(self.materialize(), key)

    # ------------------------------------------------------------ aggregates

    def _aggregate(self, kind: str, on: Optional[str]):
        """Per-block partial aggregates in parallel tasks, combined on the
        driver (self must be materialized)."""
        agg_remote = _remote(_agg_task)
        parts = [p for p in ray_tpu_torch.get(
            [agg_remote.remote(self._ops, s.ref, on, kind)
             for s in self._sources]) if p is not None]
        if not parts:
            return None
        if kind == "sum":
            return sum(parts)
        if kind == "min":
            return min(parts)
        if kind == "max":
            return max(parts)
        if kind == "mean":
            tot = sum(p[0] for p in parts)
            cnt = sum(p[1] for p in parts)
            return tot / cnt if cnt else None
        raise ValueError(kind)

    def sum(self, on: Optional[str] = None):
        return self.materialize()._aggregate("sum", on)

    def min(self, on: Optional[str] = None):
        return self.materialize()._aggregate("min", on)

    def max(self, on: Optional[str] = None):
        return self.materialize()._aggregate("max", on)

    def mean(self, on: Optional[str] = None):
        return self.materialize()._aggregate("mean", on)

    # ------------------------------------------------------------ export

    def to_pandas(self):
        import pandas as pd

        frames = []
        for eb in self._stream():
            frames.append(BlockAccessor.for_block(
                ray_tpu_torch.get(eb.ref)).to_batch("pandas"))
        return (pd.concat(frames, ignore_index=True) if frames
                else pd.DataFrame())

    def to_numpy_refs(self) -> List[Any]:
        return [eb.ref for eb in self.materialize()._stream()]

    # (write_parquet/write_csv/write_json are defined with the other IO
    # methods above — distributed one-task-per-block writers)

    # ------------------------------------------------------------ misc

    def __iter__(self):
        return self.iter_rows()

    def __repr__(self):
        pend = f", pending_ops={len(self._ops)}" if self._ops else ""
        return f"Dataset(num_blocks={len(self._sources)}{pend})"


class GroupedData:
    """Result of ``Dataset.groupby`` (reference: `grouped_data.py`):
    hash-partitions blocks by key, then applies per-group logic inside
    per-partition tasks."""

    def __init__(self, ds: Dataset, key):
        self._ds = ds
        self._key = key

    def map_groups(self, fn: Callable, *,
                   batch_format: str = "numpy") -> Dataset:
        """fn(group_batch) -> batch; groups never split across calls."""
        ds = self._ds
        n_parts = max(1, min(len(ds._sources), 16))
        part_remote = _remote(_hash_partition_task, num_returns=n_parts)
        parts = [part_remote.remote(s.ref, self._key, n_parts)
                 for s in ds._sources]
        if n_parts == 1:
            parts = [[p] for p in parts]
        apply_remote = _remote(_group_apply_task, num_returns=2)
        refs, meta_refs = [], []
        for j in range(n_parts):
            r, m = apply_remote.remote(self._key, fn, batch_format,
                                       *[p[j] for p in parts])
            refs.append(r)
            meta_refs.append(m)
        return Dataset.from_block_refs(refs, ray_tpu_torch.get(meta_refs))

    def count(self) -> Dataset:
        key = self._key

        def _count(batch):
            rows = _batch_rows(batch)
            k = rows[0][key] if not callable(key) else key(rows[0])
            return [{"key": k, "count": len(rows)}]

        return self.map_groups(_count, batch_format="rows")

    def sum(self, on: str) -> Dataset:
        key = self._key
        on_ = on

        def _sum(batch):
            rows = _batch_rows(batch)
            k = rows[0][key] if not callable(key) else key(rows[0])
            return [{"key": k, "sum": sum(r[on_] for r in rows)}]

        return self.map_groups(_sum, batch_format="rows")

    def mean(self, on: str) -> Dataset:
        key = self._key
        on_ = on

        def _mean(batch):
            rows = _batch_rows(batch)
            k = rows[0][key] if not callable(key) else key(rows[0])
            return [{"key": k,
                     "mean": sum(r[on_] for r in rows) / len(rows)}]

        return self.map_groups(_mean, batch_format="rows")


def _batch_rows(batch):
    if isinstance(batch, list):
        return batch
    return list(BlockAccessor.for_block(
        BlockAccessor.batch_to_block(batch)).iter_rows())
