"""TuneController — the trial-driving event loop.

Reference analogue: `python/ray/tune/execution/tune_controller.py:49`
(``step`` :267 — start what fits, process one event, apply scheduler
decision) + `ray_trial_executor.py` (actor lifecycle).

Each trial runs in a `_TrialActor` (`ray_tpu_torch/tune/trainable.py`); the
controller keeps one outstanding ``next_result`` call per running trial
and multiplexes on ``ray_tpu_torch.wait`` — the actor fan-out IS the
parallelism, trial resources gate scheduling through the core raylet
(a pending trial actor simply waits in the ready queue).
"""

from __future__ import annotations

import json
import os
import time
import traceback
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.checkpoint_manager import CheckpointManager
from ray_tpu_torch.air.config import RunConfig
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.tune.schedulers import (
    EXPLOIT,
    STOP,
    FIFOScheduler,
    TrialScheduler,
)
from ray_tpu_torch.tune.trainable import ERROR, FINISHED, REPORT, _TrialActor

PENDING = "PENDING"
RUNNING = "RUNNING"
TERMINATED = "TERMINATED"
ERRORED = "ERROR"


class Trial:
    def __init__(self, trial_id: str, config: dict, exp_dir: str):
        self.trial_id = trial_id
        self.config = config
        self.state = PENDING
        self.actor = None
        self.last_result: Optional[dict] = None
        self.iteration = 0
        self.error: Optional[str] = None
        self.dir = os.path.join(exp_dir, trial_id)
        self.ckpt_manager: Optional[CheckpointManager] = None
        self.latest_checkpoint_data: Optional[dict] = None
        self.restore_checkpoint: Optional[dict] = None
        # scheduler bookkeeping
        self.rungs_recorded: set = set()
        self.last_perturbation_time: int = 0
        self.num_restarts = 0

    def summary(self) -> dict:
        return {
            "trial_id": self.trial_id,
            "config": self.config,
            "state": self.state,
            "last_result": self.last_result,
            "iteration": self.iteration,
            "error": self.error,
        }


class TuneController:
    def __init__(self, trainable, param_space: Optional[dict],
                 tune_config: "TuneConfig", run_config: RunConfig):
        from ray_tpu_torch.tune.search import generate_variants

        self.trainable = trainable
        self.tc = tune_config
        self.rc = run_config
        self.scheduler: TrialScheduler = tune_config.scheduler or FIFOScheduler()
        self.searcher = getattr(tune_config, "search_alg", None)
        self._search_budget = 0
        self.exp_dir = run_config.resolved_storage_path()
        os.makedirs(self.exp_dir, exist_ok=True)
        # URI storage (reference: tune/syncer.py): mirror the experiment
        # dir to the remote target with every state save + at run end
        self._sync_uri = (run_config.storage_uri()
                          if hasattr(run_config, "storage_uri") else None)
        if param_space is None:
            # restore path: the caller installs a pre-built trial list
            self.trials: List[Trial] = []
        elif self.searcher is not None:
            # Pluggable searcher (reference: `tune/search/searcher.py`):
            # trials are SUGGESTED lazily as capacity frees up, so later
            # suggestions see earlier results (bayesian search).
            self.searcher.set_search_properties(
                tune_config.metric, tune_config.mode, param_space)
            self.trials = []
            # Match the pre-materialized path's semantics: grids expand to
            # grid_size x num_samples trials, so every grid point runs.
            from ray_tpu_torch.tune.search import grid_size

            self._search_budget = (tune_config.num_samples
                                   * grid_size(param_space))
        else:
            configs = generate_variants(param_space,
                                        num_samples=tune_config.num_samples,
                                        seed=tune_config.seed)
            self.trials = [
                Trial(f"trial_{i:05d}", cfg, self.exp_dir)
                for i, cfg in enumerate(configs)
            ]
            for t in self.trials:
                t.ckpt_manager = CheckpointManager(
                    t.dir, run_config.checkpoint_config)
        self._inflight: Dict[Any, Trial] = {}  # next_result ref -> trial
        self._last_state_save = 0.0

    # ------------------------------------------------------------ lifecycle

    def _actor_cls(self):
        res = dict(self.tc.resources_per_trial or {"CPU": 1})
        num_cpus = res.pop("CPU", 1)
        num_tpus = res.pop("TPU", 0)
        # max_concurrency=2: stop() must be deliverable while a
        # next_result() call is blocked on the session queue.
        return ray_tpu_torch.remote(
            num_cpus=num_cpus, num_tpus=num_tpus,
            resources=res or None, max_restarts=0, max_concurrency=2,
        )(_TrialActor)

    def _start_trial(self, trial: Trial):
        trial.actor = self._actor_cls().remote(
            self.trainable, trial.config, trial.trial_id,
            self.rc.name or "", trial.restore_checkpoint,
        )
        trial.restore_checkpoint = None
        trial.state = RUNNING
        ref = trial.actor.next_result.remote()
        self._inflight[ref] = trial

    def _stop_trial(self, trial: Trial, state: str, error: str = None):
        trial.state = state
        trial.error = error
        if trial.actor is not None:
            try:
                # Graceful first: runs Trainable.cleanup() / finishes the
                # session thread.  The kill then reclaims the worker.
                ray_tpu_torch.get(trial.actor.stop.remote(), timeout=2)
            except Exception:  # noqa: BLE001
                pass
            try:
                ray_tpu_torch.kill(trial.actor)
            except Exception:  # noqa: BLE001
                pass
            trial.actor = None

    # ------------------------------------------------------------ event loop

    def _maybe_suggest(self, n_active: int, max_conc: int):
        """Ask the searcher for new trials while capacity and budget
        remain."""
        while (self.searcher is not None and self._search_budget > 0
               and n_active < max_conc):
            trial_id = f"trial_{len(self.trials):05d}"
            config = self.searcher.suggest(trial_id)
            if config is None:
                return
            trial = Trial(trial_id, config, self.exp_dir)
            trial.ckpt_manager = CheckpointManager(
                trial.dir, self.rc.checkpoint_config)
            self.trials.append(trial)
            self._search_budget -= 1
            n_active += 1

    def run(self) -> List[Trial]:
        # Concurrency defaults: the pre-materialized path runs all trials
        # in parallel, but a model-based searcher with unbounded
        # concurrency degenerates to random sampling (every suggestion is
        # made before any result lands, so the model never sees history).
        # Default the searcher path to its warmup width (n_initial_points,
        # else 8) — the random phase parallelizes freely, then suggestions
        # serialize enough for the model to learn.  max_concurrent_trials
        # overrides either way; sequential bayesian search is
        # max_concurrent_trials=1.
        warmup = (getattr(self.searcher, "n_initial", None)
                  if self.searcher is not None else None)
        if warmup:
            # model-based searcher (has a warmup phase): cap concurrency
            default_conc = min(self._search_budget, warmup)
        elif self.searcher is not None:
            # non-model searcher (random/grid): full-budget parallelism
            default_conc = self._search_budget
        else:
            default_conc = len(self.trials)
        max_conc = self.tc.max_concurrent_trials or max(default_conc, 1)
        start_time = time.monotonic()
        while True:
            running = [t for t in self.trials if t.state == RUNNING]
            pending = [t for t in self.trials if t.state == PENDING]
            self._maybe_suggest(len(running) + len(pending), max_conc)
            pending = [t for t in self.trials if t.state == PENDING]
            if not running and not pending:
                break
            if (self.tc.time_budget_s is not None
                    and time.monotonic() - start_time > self.tc.time_budget_s):
                for t in running:
                    self._stop_trial(t, TERMINATED)
                for t in pending:
                    t.state = TERMINATED
                break
            while pending and len(running) < max_conc:
                t = pending.pop(0)
                self._start_trial(t)
                running.append(t)
            if not self._inflight:
                break
            ready, _ = ray_tpu_torch.wait(list(self._inflight.keys()),
                                    num_returns=1, timeout=30.0)
            if not ready:
                continue
            ref = ready[0]
            trial = self._inflight.pop(ref)
            try:
                kind, payload = ray_tpu_torch.get(ref)
            except Exception:  # noqa: BLE001 (actor/worker death)
                kind, payload = ERROR, traceback.format_exc()
            self._process_event(trial, kind, payload)
            # Throttled: full-state JSON per report is O(trials) disk I/O
            # in the event loop; terminal transitions always snapshot.
            if kind != REPORT or \
                    time.time() - self._last_state_save > 2.0:
                self._save_experiment_state()
        self._save_experiment_state()
        return self.trials

    def _process_event(self, trial: Trial, kind: str, payload):
        if kind == ERROR:
            max_failures = self.rc.failure_config.max_failures
            if max_failures < 0 or trial.num_restarts < max_failures:
                trial.num_restarts += 1
                trial.restore_checkpoint = trial.latest_checkpoint_data
                self._stop_trial(trial, PENDING)
                return
            self._stop_trial(trial, ERRORED, error=str(payload))
            if self.searcher is not None:
                self.searcher.on_trial_complete(trial.trial_id, None)
            return
        if kind == FINISHED:
            self._stop_trial(trial, TERMINATED)
            self.scheduler.on_trial_complete(trial)
            if self.searcher is not None:
                self.searcher.on_trial_complete(trial.trial_id,
                                                trial.last_result)
            return
        metrics, ckpt_data = payload
        trial.iteration += 1
        metrics.setdefault("training_iteration", trial.iteration)
        metrics.setdefault("trial_id", trial.trial_id)
        trial.last_result = metrics
        if ckpt_data is not None:
            trial.latest_checkpoint_data = ckpt_data
            trial.ckpt_manager.register(
                Checkpoint.from_dict(ckpt_data), metrics)
        if self.searcher is not None:
            self.searcher.on_trial_result(trial.trial_id, metrics)
        if self._met_stop_criteria(metrics):
            self._stop_trial(trial, TERMINATED)
            self.scheduler.on_trial_complete(trial)
            if self.searcher is not None:
                self.searcher.on_trial_complete(trial.trial_id, metrics)
            return
        decision = self.scheduler.on_result(trial, metrics)
        if decision == STOP:
            self._stop_trial(trial, TERMINATED)
            self.scheduler.on_trial_complete(trial)
            if self.searcher is not None:
                self.searcher.on_trial_complete(trial.trial_id, metrics)
        elif decision == EXPLOIT:
            # PBT: restart from the donor's checkpoint with the perturbed
            # config (reference `pbt.py` _exploit; actor reuse via
            # reset_config is an optimization we skip — restart is always
            # correct).
            self._stop_trial(trial, PENDING)
            trial.config = dict(self.scheduler.exploit_config)
            trial.restore_checkpoint = self.scheduler.exploit_checkpoint
        else:
            ref = trial.actor.next_result.remote()
            self._inflight[ref] = trial

    def _met_stop_criteria(self, metrics: dict) -> bool:
        stop = self.tc.stop or {}
        for key, bound in stop.items():
            v = metrics.get(key)
            if v is not None and v >= bound:
                return True
        return False

    # ------------------------------------------------------------ state

    def _save_experiment_state(self):
        cc = self.rc.checkpoint_config
        state = {
            "time": time.time(),
            "trials": [t.summary() for t in self.trials],
            "tune_config": {
                "metric": self.tc.metric, "mode": self.tc.mode,
                "num_samples": self.tc.num_samples,
            },
            "checkpoint_config": {
                "num_to_keep": cc.num_to_keep,
                "checkpoint_score_attribute": cc.checkpoint_score_attribute,
                "checkpoint_score_order": cc.checkpoint_score_order,
            },
        }
        tmp = os.path.join(self.exp_dir, ".experiment_state.tmp")
        with open(tmp, "w") as f:
            json.dump(state, f, indent=1, default=str)
        os.replace(tmp, os.path.join(self.exp_dir, "experiment_state.json"))
        self._last_state_save = time.time()
        if self._sync_uri:
            from ray_tpu_torch.tune.syncer import get_syncer

            try:
                get_syncer(self._sync_uri).sync_up(self.exp_dir,
                                                   self._sync_uri)
            except Exception:  # noqa: BLE001 — sync failures must not
                import traceback  # kill the run; next save retries

                traceback.print_exc()

    def results(self) -> List[Result]:
        out = []
        for t in self.trials:
            best = t.ckpt_manager.best if t.ckpt_manager else None
            out.append(Result(
                metrics=t.last_result,
                checkpoint=best.checkpoint if best else None,
                error=RuntimeError(t.error) if t.error else None,
                path=t.dir,
                config=t.config,
            ))
        return out
