"""Trainables — the unit Tune runs, and the actor that hosts one trial.

Reference analogues: `python/ray/tune/trainable/trainable.py:334`
(class ``Trainable.train()`` step protocol),
`python/ray/tune/trainable/function_trainable.py` (function trainables
reporting through a session), `python/ray/tune/execution/ray_trial_executor.py`
(the actor wrapper).

One trial = one ``_TrialActor``.  Function trainables run on a session
thread (reusing `ray_tpu_torch.train.session`, so ``session.report`` /
``get_checkpoint`` work identically under Train and Tune — the reference
shares this machinery the same way).  Class trainables are stepped
explicitly, which is what lets schedulers pause/perturb them (PBT).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

REPORT = "report"
FINISHED = "finished"
ERROR = "error"


class Trainable:
    """Subclass API: override setup/step/save_checkpoint/load_checkpoint.

    ``step()`` returns a metrics dict; Tune calls it repeatedly
    (reference: `trainable.py:334` ``train()``).
    """

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        self.config = dict(config or {})
        self.iteration = 0
        self.setup(self.config)

    # -- override points -------------------------------------------------
    def setup(self, config: Dict[str, Any]):
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self) -> Optional[Dict[str, Any]]:
        return None

    def load_checkpoint(self, data: Dict[str, Any]):
        pass

    def cleanup(self):
        pass

    # -- driver protocol -------------------------------------------------
    def train(self) -> Dict[str, Any]:
        result = self.step()
        self.iteration += 1
        result.setdefault("training_iteration", self.iteration)
        return result

    def reset_config(self, new_config: Dict[str, Any]) -> bool:
        """Return True if the trainable supports in-place config swap
        (PBT uses this to avoid actor restarts)."""
        return False


class _TrialActor:
    """Hosts one trial: either a function trainable on a session thread
    or a class trainable stepped on demand."""

    def __init__(self, trainable, config: Optional[dict], trial_id: str,
                 experiment_name: str = "",
                 checkpoint_data: Optional[dict] = None):
        from ray_tpu_torch.air.checkpoint import Checkpoint
        from ray_tpu_torch.train.session import (
            TrainContext,
            _init_session,
            _TrainSession,
        )

        self._config = dict(config or {})
        self._is_class = isinstance(trainable, type) and issubclass(
            trainable, Trainable)
        self._session = None
        self._instance: Optional[Trainable] = None
        ckpt = (Checkpoint.from_dict(checkpoint_data)
                if checkpoint_data is not None else None)
        if self._is_class:
            self._instance = trainable(self._config)
            if checkpoint_data is not None:
                data = dict(checkpoint_data)
                # iteration travels with the checkpoint so restarts (retry,
                # PBT exploit, restore) keep training_iteration monotonic
                self._instance.iteration = data.pop("__tune_iteration__", 0)
                self._instance.load_checkpoint(data)
        else:
            ctx = TrainContext(experiment_name=experiment_name,
                               trial_id=trial_id)
            self._session = _TrainSession(trainable, self._config, ctx, ckpt)
            _init_session(self._session)
            self._session.start()

    def next_result(self):
        """Block until the next (kind, payload) event.

        report payload: (metrics, checkpoint_dict_or_None).
        """
        if self._is_class:
            try:
                metrics = self._instance.train()
                # Collect the checkpoint every step: PBT exploitation and
                # failure recovery need trial.latest_checkpoint_data
                # populated (reference checkpoints class trainables at
                # checkpoint_frequency; a per-step dict is cheap here).
                ckpt = self._instance.save_checkpoint()
                if ckpt is not None:
                    ckpt = dict(ckpt)
                    ckpt["__tune_iteration__"] = self._instance.iteration
            except Exception as e:  # noqa: BLE001
                import traceback

                return ERROR, f"{e}\n{traceback.format_exc()}"
            return REPORT, (metrics, ckpt)
        kind, payload = self._session.get_next()
        if kind == ERROR:
            e, tb = payload
            return ERROR, f"{e}\n{tb}"
        if kind == REPORT:
            metrics, ckpt = payload
            return REPORT, (metrics,
                            ckpt.to_dict() if ckpt is not None else None)
        return FINISHED, None

    def save(self) -> Optional[dict]:
        """On-demand checkpoint (class trainables; PBT exploitation)."""
        if self._is_class:
            return self._instance.save_checkpoint()
        return None

    def reset(self, new_config: dict) -> bool:
        """In-place config swap if supported (class trainables only)."""
        if self._is_class and self._instance.reset_config(dict(new_config)):
            self._instance.config = dict(new_config)
            return True
        return False

    def stop(self):
        if self._is_class and self._instance is not None:
            self._instance.cleanup()
        if self._session is not None:
            self._session.finish(timeout=1)
        return True
