"""SklearnTrainer: fit a scikit-learn estimator on Dataset shards.

Reference analogue: `python/ray/train/sklearn/sklearn_trainer.py`
(SklearnTrainer — single remote fit with optional cross-validation,
result metrics + a checkpoint carrying the fitted estimator).

TPU framing: sklearn is the CPU tabular path; the fit runs as ONE remote
task (sklearn estimators are not distributed), fed from the Dataset's
columnar numpy blocks with zero conversion.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.result import Result

__all__ = ["SklearnTrainer"]

_MODEL_KEY = "sklearn_estimator"


def _collect_xy(dataset, label_column: str, feature_columns):
    rows = dataset.take_all()
    if not rows:
        raise ValueError("empty dataset")
    cols = feature_columns or [c for c in rows[0] if c != label_column]
    X = np.asarray([[r[c] for c in cols] for r in rows], np.float64)
    y = np.asarray([r[label_column] for r in rows])
    return X, y, cols


def _fit_task(estimator_blob: bytes, datasets_rows: dict,
              cv: Optional[int], scoring: Optional[str]):
    import pickle
    import time

    from ray_tpu_torch._vendor import cloudpickle

    estimator = cloudpickle.loads(estimator_blob)
    X, y, cols = datasets_rows["train"]
    t0 = time.perf_counter()
    estimator.fit(X, y)
    fit_time = time.perf_counter() - t0
    metrics: Dict[str, Any] = {"fit_time": fit_time}
    if cv:
        from sklearn.model_selection import cross_val_score

        fresh = cloudpickle.loads(estimator_blob)
        scores = cross_val_score(fresh, X, y, cv=cv, scoring=scoring)
        metrics["cv/mean_test_score"] = float(np.mean(scores))
        metrics["cv/std_test_score"] = float(np.std(scores))
    for name, (Xv, yv, _) in datasets_rows.items():
        metrics[f"{name}/score"] = float(estimator.score(Xv, yv))
    return metrics, pickle.dumps(estimator, protocol=5), cols


class SklearnTrainer:
    """``SklearnTrainer(estimator, label_column=..., datasets={"train": ds,
    "valid": ds2}).fit()`` -> Result with per-dataset scores and a
    checkpoint holding the fitted estimator."""

    def __init__(self, estimator, *, label_column: str,
                 datasets: Dict[str, Any],
                 feature_columns: Optional[List[str]] = None,
                 cv: Optional[int] = None,
                 scoring: Optional[str] = None,
                 num_cpus: float = 1):
        assert "train" in datasets, "datasets must include 'train'"
        self._estimator = estimator
        self._label = label_column
        self._datasets = datasets
        self._features = feature_columns
        self._cv = cv
        self._scoring = scoring
        self._num_cpus = num_cpus

    def fit(self) -> Result:
        from ray_tpu_torch._vendor import cloudpickle

        import ray_tpu_torch

        # Column order is inferred ONCE from the train split and applied
        # to every other split — per-dataset inference could silently
        # permute valid/test feature matrices.
        train_xy = _collect_xy(self._datasets["train"], self._label,
                               self._features)
        train_cols = train_xy[2]
        rows = {"train": train_xy}
        rows.update({
            name: _collect_xy(ds, self._label, train_cols)
            for name, ds in self._datasets.items() if name != "train"
        })
        fit_remote = ray_tpu_torch.remote(num_cpus=self._num_cpus)(_fit_task)
        metrics, model_blob, cols = ray_tpu_torch.get(
            fit_remote.remote(cloudpickle.dumps(self._estimator), rows,
                              self._cv, self._scoring),
            timeout=600)
        ckpt = Checkpoint.from_dict({
            _MODEL_KEY: model_blob,
            "feature_columns": cols,
            "label_column": self._label,
        })
        return Result(metrics=metrics, checkpoint=ckpt)

    @staticmethod
    def get_model(checkpoint: Checkpoint):
        """Unpack the fitted estimator from a trainer checkpoint."""
        import pickle

        return pickle.loads(checkpoint.to_dict()[_MODEL_KEY])
