"""ray_tpu_torch.tune — hyperparameter search over trial actors.

Reference analogues: `python/ray/tune/__init__.py` + `tune/tuner.py`
(``Tuner``) + `tune/tune.py:293` (``tune.run``).  Architecture notes in
`ray_tpu_torch/tune/tune_controller.py`.

Reporting from inside a trainable reuses `ray_tpu_torch.train.session` (the
reference shares one session layer between Train and Tune the same way):
``tune.report(...)`` == ``train.session.report(...)``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ray_tpu_torch.air.config import RunConfig
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train.session import get_checkpoint, report
from ray_tpu_torch.tune.schedulers import (
    ASHAScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
    TrialScheduler,
)
from ray_tpu_torch.tune.search import (
    AskTellSearcher,
    BasicVariantGenerator,
    Searcher,
    TPESearcher,
    choice,
    generate_variants,
    grid_search,
    loguniform,
    randint,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.trainable import Trainable
from ray_tpu_torch.tune.tune_controller import TuneController

__all__ = [
    "Tuner", "TuneConfig", "TuneError", "ResultGrid", "run", "report",
    "get_checkpoint", "Trainable", "with_parameters", "with_resources",
    "grid_search", "uniform", "loguniform", "randint", "choice",
    "sample_from", "generate_variants", "TrialScheduler", "FIFOScheduler",
    "ASHAScheduler", "MedianStoppingRule", "PopulationBasedTraining",
    "AskTellSearcher", "Searcher", "BasicVariantGenerator", "TPESearcher",
]


class TuneError(RuntimeError):
    pass


@dataclass
class TuneConfig:
    """Reference analogue: `python/ray/tune/tune_config.py`."""

    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    scheduler: Optional[TrialScheduler] = None
    search_alg: Optional["Searcher"] = None
    resources_per_trial: Optional[Dict[str, float]] = None
    stop: Optional[Dict[str, float]] = None
    time_budget_s: Optional[float] = None
    seed: Optional[int] = None

    def __post_init__(self):
        if self.mode not in ("max", "min"):
            raise ValueError("mode must be 'max' or 'min'")


class ResultGrid:
    """Reference analogue: `python/ray/tune/result_grid.py`."""

    def __init__(self, results: List[Result], metric: Optional[str],
                 mode: str):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> Result:
        return self._results[i]

    def __iter__(self):
        return iter(self._results)

    @property
    def errors(self):
        return [r.error for r in self._results if r.error is not None]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise TuneError("no metric given to get_best_result")
        scored = [r for r in self._results
                  if r.metrics and metric in r.metrics]
        if not scored:
            raise TuneError(f"no trial reported metric {metric!r}")
        key = lambda r: r.metrics[metric]  # noqa: E731
        return max(scored, key=key) if mode == "max" else min(scored, key=key)

    def get_dataframe(self):
        import pandas as pd

        rows = []
        for r in self._results:
            row = dict(r.metrics or {})
            for k, v in (r.config or {}).items():
                row[f"config/{k}"] = v
            rows.append(row)
        return pd.DataFrame(rows)


class Tuner:
    """Reference analogue: `python/ray/tune/tuner.py` (``Tuner.fit``)."""

    def __init__(self, trainable=None, *, param_space: Optional[dict] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None):
        if trainable is None:
            raise ValueError("Tuner needs a trainable (function, Trainable "
                             "subclass, or trainer.as_trainable())")
        # Trainer objects convert themselves (reference BaseTrainer.fit
        # routes through Tune the same way).
        if hasattr(trainable, "as_trainable"):
            trainable = trainable.as_trainable()
        import copy

        self._trainable = trainable
        self._param_space = param_space or {}
        self._tune_config = tune_config or TuneConfig()
        # copy: assigning the generated name onto the caller's RunConfig
        # would silently alias a reused config's experiment directory.
        self._run_config = copy.copy(run_config) if run_config else RunConfig()
        if self._run_config.name is None:
            import time as _t

            self._run_config.name = f"tune_{_t.strftime('%Y%m%d-%H%M%S')}"

    def fit(self) -> ResultGrid:
        controller = TuneController(
            self._trainable, self._param_space,
            self._tune_config, self._run_config)
        controller.run()
        return ResultGrid(controller.results(), self._tune_config.metric,
                          self._tune_config.mode)

    @staticmethod
    def can_restore(path: str) -> bool:
        return os.path.exists(os.path.join(path, "experiment_state.json"))

    @classmethod
    def restore(cls, path: str, trainable, *,
                tune_config: Optional[TuneConfig] = None) -> "RestoredTuner":
        """``path`` may be a local experiment dir or a storage URI
        (file://... — reference `tune/syncer.py`): URIs sync down to the
        local staging area first, so an experiment started anywhere
        restores anywhere the storage is reachable."""
        if "://" in path:
            import hashlib

            from ray_tpu_torch.tune.syncer import get_syncer

            # stage keyed by the FULL URI: two buckets with same-named
            # experiments must not merge into one local dir
            digest = hashlib.sha1(path.encode()).hexdigest()[:10]
            local = os.path.join(
                os.path.expanduser("~"), "ray_tpu_torch_results", "_synced",
                f"{path.rstrip('/').rsplit('/', 1)[-1]}-{digest}")
            get_syncer(path).sync_down(path, local)
            path = local
        return RestoredTuner(path, trainable, tune_config)


class RestoredTuner:
    """Resume an interrupted experiment: TERMINATED trials keep their
    recorded results; unfinished ones restart from their latest
    checkpoint (reference: ``Tuner.restore`` + experiment checkpointing).
    """

    def __init__(self, path: str, trainable,
                 tune_config: Optional[TuneConfig] = None):
        with open(os.path.join(path, "experiment_state.json")) as f:
            self._state = json.load(f)
        self._path = path
        self._trainable = trainable
        tc = self._state.get("tune_config", {})
        self._tune_config = tune_config or TuneConfig(
            metric=tc.get("metric"), mode=tc.get("mode") or "max",
            num_samples=tc.get("num_samples", 1))

    def fit(self) -> ResultGrid:
        from ray_tpu_torch.air.checkpoint_manager import CheckpointManager
        from ray_tpu_torch.air.config import CheckpointConfig
        from ray_tpu_torch.tune.tune_controller import (
            PENDING,
            TERMINATED,
            Trial,
            TuneController,
        )

        cc_state = self._state.get("checkpoint_config") or {}
        ckpt_config = CheckpointConfig(**cc_state) if cc_state else \
            CheckpointConfig()
        run_config = RunConfig(name=os.path.basename(self._path),
                               storage_path=os.path.dirname(self._path),
                               checkpoint_config=ckpt_config)
        controller = TuneController(self._trainable, None, self._tune_config,
                                    run_config)
        trials = []
        for summary in self._state["trials"]:
            t = Trial(summary["trial_id"], summary["config"] or {},
                      self._path)
            t.ckpt_manager = CheckpointManager.restore(t.dir, ckpt_config)
            t.last_result = summary.get("last_result")
            t.iteration = summary.get("iteration", 0)
            if summary["state"] == TERMINATED:
                t.state = TERMINATED
            else:
                t.state = PENDING
                if t.ckpt_manager.latest is not None:
                    t.restore_checkpoint = \
                        t.ckpt_manager.latest.checkpoint.to_dict()
            trials.append(t)
        controller.trials = trials
        controller.run()
        return ResultGrid(controller.results(), self._tune_config.metric,
                          self._tune_config.mode)


def with_parameters(trainable, **kwargs):
    """Bind constant (possibly large) objects to a trainable
    (reference: `tune/trainable/util.py` ``with_parameters``)."""
    import functools

    if isinstance(trainable, type):
        class _Bound(trainable):  # type: ignore[misc]
            def setup(self, config):
                super().setup({**config, **kwargs})
        _Bound.__name__ = trainable.__name__
        return _Bound

    @functools.wraps(trainable)
    def wrapped(config):
        return trainable(config, **kwargs)

    return wrapped


def with_resources(trainable, resources: Dict[str, float]):
    """Attach per-trial resources (consumed by TuneConfig if unset)."""
    trainable.__tune_resources__ = dict(resources)
    return trainable


def run(trainable, *, config: Optional[dict] = None, num_samples: int = 1,
        metric: Optional[str] = None, mode: str = "max",
        scheduler: Optional[TrialScheduler] = None,
        stop: Optional[Dict[str, float]] = None,
        resources_per_trial: Optional[Dict[str, float]] = None,
        name: Optional[str] = None,
        storage_path: Optional[str] = None,
        max_concurrent_trials: Optional[int] = None,
        time_budget_s: Optional[float] = None,
        seed: Optional[int] = None) -> ResultGrid:
    """Legacy-style entry point (reference: `tune/tune.py:293`)."""
    resources = resources_per_trial or getattr(
        trainable, "__tune_resources__", None)
    tuner = Tuner(
        trainable,
        param_space=config,
        tune_config=TuneConfig(
            metric=metric, mode=mode, num_samples=num_samples,
            scheduler=scheduler, stop=stop,
            resources_per_trial=resources,
            max_concurrent_trials=max_concurrent_trials,
            time_budget_s=time_budget_s, seed=seed,
        ),
        run_config=RunConfig(name=name, storage_path=storage_path),
    )
    return tuner.fit()
