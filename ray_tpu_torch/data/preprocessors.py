"""Preprocessors: fit statistics over a Dataset, transform batches.

Reference analogue: `python/ray/data/preprocessors/` (Preprocessor base
`preprocessor.py`, StandardScaler/MinMaxScaler `scaler.py`, LabelEncoder/
OneHotEncoder `encoder.py`, Concatenator `concatenator.py`, BatchMapper
`batch_mapper.py`, Chain `chain.py`).

TPU-first framing: transforms operate on columnar numpy blocks (the
native block format, zero-copy into the host feed), and ``fit`` runs as
distributed map tasks whose per-block partials are combined on the driver
— the dataset is never collected.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

__all__ = [
    "Preprocessor", "BatchMapper", "Chain", "Concatenator", "LabelEncoder",
    "MinMaxScaler", "OneHotEncoder", "StandardScaler",
]


class Preprocessor:
    """fit(ds) computes state; transform(ds) maps batches lazily;
    transform_batch applies to one columnar batch (for serving)."""

    _is_fittable = True

    def __init__(self):
        self._fitted = False

    # ------------------------------------------------------------ protocol

    def _fit(self, ds) -> None:
        raise NotImplementedError

    def _transform_batch(self, batch: Dict[str, np.ndarray]) -> dict:
        raise NotImplementedError

    # ---------------------------------------------------------------- api

    def fit(self, ds) -> "Preprocessor":
        if self._is_fittable:
            self._fit(ds)
        self._fitted = True
        return self

    def transform(self, ds):
        self._check_fitted()
        return ds.map_batches(self._transform_batch)

    def fit_transform(self, ds):
        return self.fit(ds).transform(ds)

    def transform_batch(self, batch: Dict[str, np.ndarray]) -> dict:
        self._check_fitted()
        return self._transform_batch(dict(batch))

    def _check_fitted(self):
        if self._is_fittable and not self._fitted:
            raise RuntimeError(
                f"{type(self).__name__} must be fit() before transform")


def _column_partials(ds, partial_fn: Callable):
    """Run ``partial_fn(block) -> partial`` over every block as tasks and
    return the partials (driver-side combine stays tiny)."""
    import ray_tpu_torch

    @ray_tpu_torch.remote
    def compute(block):
        return partial_fn(block)

    refs = [compute.remote(eb.ref) for eb in ds._stream()]
    return ray_tpu_torch.get(refs, timeout=300)


class StandardScaler(Preprocessor):
    """(x - mean) / std per column (reference: `scaler.py` StandardScaler);
    mean/std from a single distributed pass (count/sum/sumsq partials)."""

    def __init__(self, columns: List[str]):
        super().__init__()
        self.columns = list(columns)
        self.stats_: Dict[str, tuple] = {}

    def _fit(self, ds):
        cols = self.columns

        def partial(block):
            return {c: (len(block[c]),
                        float(np.sum(block[c], dtype=np.float64)),
                        float(np.sum(np.square(block[c], dtype=np.float64))))
                    for c in cols}

        partials = _column_partials(ds, partial)
        for c in cols:
            n = sum(p[c][0] for p in partials)
            s = sum(p[c][1] for p in partials)
            ss = sum(p[c][2] for p in partials)
            mean = s / max(n, 1)
            var = max(ss / max(n, 1) - mean ** 2, 0.0)
            self.stats_[c] = (mean, float(np.sqrt(var)))

    def _transform_batch(self, batch):
        for c in self.columns:
            mean, std = self.stats_[c]
            batch[c] = (np.asarray(batch[c], np.float64) - mean) \
                / (std if std > 0 else 1.0)
        return batch


class MinMaxScaler(Preprocessor):
    """(x - min) / (max - min) per column (reference: `scaler.py`)."""

    def __init__(self, columns: List[str]):
        super().__init__()
        self.columns = list(columns)
        self.stats_: Dict[str, tuple] = {}

    def _fit(self, ds):
        cols = self.columns

        def partial(block):
            return {c: (float(np.min(block[c])), float(np.max(block[c])))
                    for c in cols}

        partials = _column_partials(ds, partial)
        for c in cols:
            lo = min(p[c][0] for p in partials)
            hi = max(p[c][1] for p in partials)
            self.stats_[c] = (lo, hi)

    def _transform_batch(self, batch):
        for c in self.columns:
            lo, hi = self.stats_[c]
            span = (hi - lo) if hi > lo else 1.0
            batch[c] = (np.asarray(batch[c], np.float64) - lo) / span
        return batch


class LabelEncoder(Preprocessor):
    """Categorical -> ordinal int (reference: `encoder.py` LabelEncoder)."""

    def __init__(self, label_column: str):
        super().__init__()
        self.label_column = label_column
        self.stats_: Dict[Any, int] = {}

    def _fit(self, ds):
        col = self.label_column

        def partial(block):
            return np.unique(np.asarray(block[col]))

        partials = _column_partials(ds, partial)
        values = sorted(set().union(*[set(p.tolist()) for p in partials]))
        self.stats_ = {v: i for i, v in enumerate(values)}

    def _transform_batch(self, batch):
        mapping = self.stats_
        values = np.asarray(batch[self.label_column]).tolist()
        unseen = sorted({v for v in values if v not in mapping})
        if unseen:
            raise ValueError(
                f"LabelEncoder({self.label_column!r}): values {unseen!r} "
                "were not present at fit time")
        batch[self.label_column] = np.asarray(
            [mapping[v] for v in values], np.int64)
        return batch

    def inverse_transform_batch(self, batch):
        inv = {i: v for v, i in self.stats_.items()}
        batch = dict(batch)
        batch[self.label_column] = np.asarray(
            [inv[int(v)] for v in batch[self.label_column]])
        return batch


class OneHotEncoder(Preprocessor):
    """Categorical -> one-hot columns ``<col>_<value>`` (reference:
    `encoder.py` OneHotEncoder)."""

    def __init__(self, columns: List[str]):
        super().__init__()
        self.columns = list(columns)
        self.stats_: Dict[str, list] = {}

    def _fit(self, ds):
        cols = self.columns

        def partial(block):
            return {c: np.unique(np.asarray(block[c])) for c in cols}

        partials = _column_partials(ds, partial)
        for c in cols:
            self.stats_[c] = sorted(
                set().union(*[set(p[c].tolist()) for p in partials]))

    def _transform_batch(self, batch):
        for c in self.columns:
            values = np.asarray(batch.pop(c))
            for v in self.stats_[c]:
                batch[f"{c}_{v}"] = (values == v).astype(np.int64)
        return batch


class Concatenator(Preprocessor):
    """Merge feature columns into one 2-D float array column — the shape a
    model feed wants (reference: `concatenator.py`)."""

    _is_fittable = False

    def __init__(self, output_column_name: str = "concat_out",
                 include: Optional[List[str]] = None,
                 exclude: Optional[List[str]] = None,
                 dtype=np.float32):
        super().__init__()
        self.output_column_name = output_column_name
        self.include = include
        self.exclude = set(exclude or ())
        self.dtype = dtype
        self._fitted = True

    def _transform_batch(self, batch):
        cols = (self.include if self.include is not None
                else [c for c in batch if c not in self.exclude])
        arrays = [np.asarray(batch.pop(c), self.dtype) for c in cols]
        arrays = [a.reshape(a.shape[0], -1) for a in arrays]
        batch[self.output_column_name] = np.concatenate(arrays, axis=1)
        return batch


class BatchMapper(Preprocessor):
    """Arbitrary user function over batches (reference:
    `batch_mapper.py`)."""

    _is_fittable = False

    def __init__(self, fn: Callable[[dict], dict]):
        super().__init__()
        self.fn = fn
        self._fitted = True

    def _transform_batch(self, batch):
        return self.fn(batch)


class Chain(Preprocessor):
    """Sequential preprocessors; fit runs each stage on the PREVIOUS
    stages' transformed data (reference: `chain.py`)."""

    def __init__(self, *preprocessors: Preprocessor):
        super().__init__()
        self.preprocessors = list(preprocessors)

    def _fit(self, ds):
        for p in self.preprocessors:
            p.fit(ds)
            ds = p.transform(ds)

    def _transform_batch(self, batch):
        for p in self.preprocessors:
            batch = p.transform_batch(batch)
        return batch
