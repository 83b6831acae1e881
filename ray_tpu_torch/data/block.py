"""Blocks — the unit of distributed data.

Reference analogue: `python/ray/data/block.py` (Block/BlockAccessor over
Arrow or pandas).  TPU-first redesign: the canonical block is a **columnar
dict of numpy arrays** — the format a JAX host feed wants (zero conversion
before `jnp.asarray` / host-to-device transfer, and a natural fit for the
object store's zero-copy numpy path).  Rows of arbitrary Python objects are
supported via a secondary list-block kind.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Union

import numpy as np

# A block is either a columnar table (dict of equal-length numpy arrays) or
# a plain list of rows.
Block = Union[Dict[str, np.ndarray], List[Any]]

#: Column name used when tabular data has a single unnamed column
#: (e.g. ``range(n)`` / ``from_numpy``).
VALUE_COL = "value"


class BlockMetadata:
    """Sidecar facts the scheduler/splitter needs without fetching the
    block (reference: `python/ray/data/block.py` BlockMetadata)."""

    __slots__ = ("num_rows", "size_bytes", "schema")

    def __init__(self, num_rows: int, size_bytes: int, schema):
        self.num_rows = num_rows
        self.size_bytes = size_bytes
        self.schema = schema

    def __repr__(self):
        return (f"BlockMetadata(num_rows={self.num_rows}, "
                f"size_bytes={self.size_bytes}, schema={self.schema})")


class BlockAccessor:
    """Uniform view over the two block kinds."""

    def __init__(self, block: Block):
        self._block = block
        self._is_table = isinstance(block, dict)

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    # ------------------------------------------------------------- facts

    @property
    def is_table(self) -> bool:
        return self._is_table

    def num_rows(self) -> int:
        if self._is_table:
            if not self._block:
                return 0
            return len(next(iter(self._block.values())))
        return len(self._block)

    def size_bytes(self) -> int:
        if self._is_table:
            return int(sum(a.nbytes if isinstance(a, np.ndarray)
                           else len(str(a)) for a in self._block.values()))
        # rough estimate for list rows
        import sys

        return int(sum(sys.getsizeof(r) for r in self._block))

    def schema(self):
        if self._is_table:
            return {k: (str(v.dtype) if isinstance(v, np.ndarray) else "object")
                    for k, v in self._block.items()}
        for r in self._block:
            return type(r).__name__
        return None

    def metadata(self) -> BlockMetadata:
        return BlockMetadata(self.num_rows(), self.size_bytes(), self.schema())

    # ------------------------------------------------------------- access

    def slice(self, start: int, end: int) -> Block:
        if self._is_table:
            return {k: v[start:end] for k, v in self._block.items()}
        return self._block[start:end]

    def take_rows(self, indices) -> Block:
        if self._is_table:
            return {k: np.asarray(v)[indices] for k, v in self._block.items()}
        return [self._block[i] for i in indices]

    def iter_rows(self) -> Iterator[Any]:
        if self._is_table:
            cols = list(self._block.items())
            for i in range(self.num_rows()):
                yield {k: v[i] for k, v in cols}
        else:
            yield from iter(self._block)

    def to_batch(self, batch_format: str = "numpy"):
        """Materialize the whole block in the requested batch format."""
        if batch_format in ("numpy", "default"):
            if self._is_table:
                return dict(self._block)
            return self._block
        if batch_format == "pandas":
            import pandas as pd

            if self._is_table:
                return pd.DataFrame(
                    {k: list(v) if getattr(v, "ndim", 1) > 1 else v
                     for k, v in self._block.items()})
            return pd.DataFrame(self._block)
        if batch_format == "pyarrow":
            import pyarrow as pa

            if self._is_table:
                return pa.table({k: pa.array(v)
                                 for k, v in self._block.items()})
            return pa.table({VALUE_COL: pa.array(self._block)})
        raise ValueError(f"unknown batch_format {batch_format!r}")

    # ------------------------------------------------------------- build

    @staticmethod
    def batch_to_block(batch) -> Block:
        """Normalize a user-returned batch into a block."""
        if batch is None:
            return []
        if isinstance(batch, dict):
            return {k: np.asarray(v) for k, v in batch.items()}
        try:
            import pandas as pd

            if isinstance(batch, pd.DataFrame):
                return {c: batch[c].to_numpy() for c in batch.columns}
        except ImportError:
            pass
        try:
            import pyarrow as pa

            if isinstance(batch, pa.Table):
                return {c: batch[c].to_numpy(zero_copy_only=False)
                        for c in batch.column_names}
        except ImportError:
            pass
        if isinstance(batch, np.ndarray):
            return {VALUE_COL: batch}
        if isinstance(batch, list):
            return BlockAccessor.rows_to_block(batch)
        raise TypeError(
            f"map_batches must return dict/DataFrame/Table/ndarray/list, "
            f"got {type(batch)}")

    @staticmethod
    def rows_to_block(rows: List[Any]) -> Block:
        """Build a block from Python rows; dict rows become a table."""
        if rows and all(isinstance(r, dict) for r in rows):
            keys = list(rows[0].keys())
            if all(list(r.keys()) == keys for r in rows):
                out = {}
                for k in keys:
                    vals = [r[k] for r in rows]
                    try:
                        arr = np.asarray(vals)
                        if arr.dtype == object:
                            raise ValueError
                        out[k] = arr
                    except (ValueError, TypeError):
                        out[k] = np.asarray(vals, dtype=object)
                return out
        return list(rows)

    @staticmethod
    def concat(blocks: List[Block]) -> Block:
        blocks = [b for b in blocks if BlockAccessor(b).num_rows() > 0]
        if not blocks:
            return []
        if all(isinstance(b, dict) for b in blocks):
            keys = blocks[0].keys()
            return {k: np.concatenate([np.asarray(b[k]) for b in blocks])
                    for k in keys}
        out: List[Any] = []
        for b in blocks:
            if isinstance(b, dict):
                out.extend(BlockAccessor(b).iter_rows())
            else:
                out.extend(b)
        return out
