"""Trial schedulers: FIFO, ASHA, PBT.

Reference analogues: `python/ray/tune/schedulers/trial_scheduler.py`
(decision protocol), `async_hyperband.py` (ASHA rungs + quantile cutoff),
`pbt.py` (exploit bottom quantile from top quantile + explore by
perturbation).
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"
# PBT: restart this trial with (new_config, donor_checkpoint)
EXPLOIT = "EXPLOIT"


class TrialScheduler:
    def on_result(self, trial, result: Dict[str, Any]) -> str:
        return CONTINUE

    def on_trial_complete(self, trial):
        pass

    # PBT fills these on EXPLOIT decisions
    exploit_config: Optional[dict] = None
    exploit_checkpoint: Optional[dict] = None
    exploit_donor_id: Optional[str] = None


class FIFOScheduler(TrialScheduler):
    """No early stopping (reference: `trial_scheduler.py` FIFOScheduler)."""


class ASHAScheduler(TrialScheduler):
    """Asynchronous successive halving (reference:
    `async_hyperband.py` ``AsyncHyperBandScheduler``).

    Rungs at grace_period * reduction_factor^k.  When a trial reaches a
    rung, its score joins the rung's history; trials below the top
    1/reduction_factor quantile of that rung stop.
    """

    def __init__(self, metric: str = "score", mode: str = "max",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: float = 3.0,
                 time_attr: str = "training_iteration"):
        assert mode in ("max", "min")
        self.metric, self.mode = metric, mode
        self.max_t, self.grace_period = max_t, grace_period
        self.rf = reduction_factor
        self.time_attr = time_attr
        # rung milestone -> list of recorded scores (sign-normalized: max)
        self.rungs: Dict[int, List[float]] = {}
        m = grace_period
        while m < max_t:
            self.rungs[int(m)] = []
            m *= reduction_factor

    def _norm(self, v: float) -> float:
        return v if self.mode == "max" else -v

    def on_result(self, trial, result):
        t = result.get(self.time_attr)
        v = result.get(self.metric)
        if t is None or v is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        milestone = None
        for m in sorted(self.rungs, reverse=True):
            if t >= m:
                milestone = m
                break
        if milestone is None:  # still inside the grace period
            return CONTINUE
        if milestone not in trial.rungs_recorded:
            trial.rungs_recorded.add(milestone)
            self.rungs[milestone].append(self._norm(v))
        # Evaluate against the rung cutoff on EVERY report (not only at
        # recording time): under lockstep arrival a bad trial can reach a
        # rung before any competitor has recorded there and would
        # otherwise never face a populated cutoff.  Async semantics are
        # preserved — no event ever waits for stragglers.
        scores = self.rungs[milestone]
        if len(scores) >= self.rf:
            cutoff_idx = int(len(scores) / self.rf)
            cutoff = sorted(scores, reverse=True)[max(cutoff_idx - 1, 0)]
            if self._norm(v) < cutoff:
                return STOP
        return CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference: `pbt.py` ``PopulationBasedTraining``):
    every ``perturbation_interval`` steps, a bottom-quantile trial
    EXPLOITs a top-quantile trial (clone config + checkpoint) and
    EXPLOREs by perturbing mutated hyperparameters (x1.2 / x0.8, or
    resample with ``resample_probability``).
    """

    def __init__(self, metric: str = "score", mode: str = "max",
                 perturbation_interval: int = 5,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 time_attr: str = "training_iteration",
                 seed: Optional[int] = None):
        assert mode in ("max", "min")
        assert 0 < quantile_fraction <= 0.5
        self.metric, self.mode = metric, mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_p = resample_probability
        self.time_attr = time_attr
        self.rng = random.Random(seed)
        # trial_id -> (last score, config, latest checkpoint data)
        self.population: Dict[str, dict] = {}
        self.num_perturbations = 0

    def _norm(self, v: float) -> float:
        return v if self.mode == "max" else -v

    def _quantiles(self):
        ranked = sorted(self.population.items(),
                        key=lambda kv: kv[1]["score"])
        n = len(ranked)
        k = max(1, int(math.ceil(n * self.quantile)))
        if n < 2 or k >= n:
            return [], []
        bottom = [tid for tid, _ in ranked[:k]]
        top = [tid for tid, _ in ranked[-k:]]
        return bottom, top

    def _perturb(self, config: dict) -> dict:
        from ray_tpu_torch.tune.search import Domain

        out = dict(config)
        for key, spec in self.mutations.items():
            if key not in out:
                continue
            if self.rng.random() < self.resample_p:
                if isinstance(spec, Domain):
                    out[key] = spec.sample(self.rng)
                elif isinstance(spec, list):
                    out[key] = self.rng.choice(spec)
                elif callable(spec):
                    out[key] = spec()
            elif isinstance(out[key], (int, float)) and not isinstance(
                    out[key], bool):
                factor = 1.2 if self.rng.random() > 0.5 else 0.8
                out[key] = type(out[key])(out[key] * factor)
            elif isinstance(spec, list):
                out[key] = self.rng.choice(spec)
        return out

    def on_result(self, trial, result):
        t = result.get(self.time_attr)
        v = result.get(self.metric)
        if t is None or v is None:
            return CONTINUE
        self.population[trial.trial_id] = {
            "score": self._norm(v),
            "config": dict(trial.config),
            "checkpoint": trial.latest_checkpoint_data,
            "time": t,
        }
        if t - trial.last_perturbation_time < self.interval:
            return CONTINUE
        trial.last_perturbation_time = t
        bottom, top = self._quantiles()
        if trial.trial_id not in bottom:
            return CONTINUE
        donor_id = self.rng.choice(top)
        donor = self.population[donor_id]
        if donor["checkpoint"] is None:
            return CONTINUE  # nothing to exploit yet
        self.exploit_config = self._perturb(donor["config"])
        self.exploit_checkpoint = donor["checkpoint"]
        self.exploit_donor_id = donor_id
        self.num_perturbations += 1
        return EXPLOIT


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose best result so far is worse than the median of
    the other trials' RUNNING-AVERAGE results at the same step (reference:
    `tune/schedulers/median_stopping_rule.py`, from Google Vizier)."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 grace_period: int = 4, min_samples_required: int = 3,
                 time_attr: str = "training_iteration"):
        assert mode in ("max", "min")
        self.metric, self.mode = metric, mode
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self.time_attr = time_attr
        # trial_id -> list of normalized results (in report order)
        self._results: Dict[str, List[float]] = {}

    def _norm(self, v: float) -> float:
        return v if self.mode == "max" else -v

    def on_result(self, trial, result):
        t = result.get(self.time_attr)
        v = result.get(self.metric)
        if t is None or v is None:
            return CONTINUE
        hist = self._results.setdefault(trial.trial_id, [])
        hist.append(self._norm(v))
        if t < self.grace_period:
            return CONTINUE
        # running average of every OTHER trial up to this step count
        others = [sum(h[:len(hist)]) / min(len(h), len(hist))
                  for tid, h in self._results.items()
                  if tid != trial.trial_id and h]
        if len(others) < self.min_samples:
            return CONTINUE
        others.sort()
        median = others[len(others) // 2]
        if max(hist) < median:
            return STOP
        return CONTINUE
