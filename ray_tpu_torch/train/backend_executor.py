"""BackendExecutor — owns the worker group + backend lifecycle and the
restart-on-failure loop.

Reference analogue: `python/ray/train/_internal/backend_executor.py:45`
(``start :104``, ``start_training :342``, ``get_next_results``,
``_restart :625`` — tear down and recreate the worker group, resuming from
the latest checkpoint, up to ``max_failures``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.core.exceptions import (
    ActorDiedError,
    TaskError,
    WorkerCrashedError,
)
from ray_tpu_torch.train import session as session_mod
from ray_tpu_torch.train.backend import BackendConfig
from ray_tpu_torch.train.session import TrainContext
from ray_tpu_torch.train.worker_group import WorkerGroup


class TrainingWorkerError(RuntimeError):
    """A worker failed in a way that warrants a worker-group restart."""


class TrainBackendError(RuntimeError):
    pass


class BackendExecutor:
    def __init__(
        self,
        backend_config: BackendConfig,
        num_workers: int,
        resources_per_worker: Dict[str, float],
        experiment_name: str = "",
        trial_id: str = "",
    ):
        self._backend_config = backend_config
        self._backend = backend_config.backend_cls()
        self._num_workers = num_workers
        self._resources_per_worker = resources_per_worker
        self._experiment_name = experiment_name
        self._trial_id = trial_id
        self.worker_group: Optional[WorkerGroup] = None
        # Stashed so _restart can re-launch training transparently.
        self._train_fn: Optional[Callable] = None
        self._train_config: Optional[dict] = None
        self._dataset_splitter: Optional[Callable] = None

    # ------------------------------------------------------------------

    def start(self):
        env_vars = None
        worker_env = getattr(self._backend_config, "worker_env", None)
        if worker_env is not None:
            env_vars = worker_env() or None
        self.worker_group = WorkerGroup(
            self._num_workers, self._resources_per_worker, env_vars=env_vars
        )
        self._backend.on_start(self.worker_group, self._backend_config)

    def start_training(self, train_fn: Callable, config: Optional[dict],
                       checkpoint: Optional[Checkpoint] = None,
                       dataset_splitter: Optional[Callable] = None):
        """Kick off the user loop on every worker (non-blocking)."""
        if self.worker_group is None:
            raise TrainBackendError("call start() first")
        self._train_fn = train_fn
        self._train_config = config
        self._dataset_splitter = dataset_splitter
        self._backend.on_training_start(self.worker_group,
                                        self._backend_config)
        shards_per_rank: List[Optional[Dict[str, Any]]] = [None] * len(
            self.worker_group)
        if dataset_splitter is not None:
            shards_per_rank = dataset_splitter(len(self.worker_group))
        futures = []
        for rank, w in enumerate(self.worker_group.workers):
            ctx = TrainContext(
                world_rank=rank,
                world_size=len(self.worker_group),
                local_rank=0,
                local_world_size=1,
                node_rank=rank,
                experiment_name=self._experiment_name,
                trial_id=self._trial_id,
            )
            futures.append(w.start_session.remote(
                train_fn, config, ctx, checkpoint, shards_per_rank[rank]
            ))
        try:
            ray_tpu_torch.get(futures, timeout=120)
        except (ActorDiedError, WorkerCrashedError) as e:
            raise TrainingWorkerError(str(e)) from e

    def get_next_results(self) -> Optional[List[Dict[str, Any]]]:
        """One lockstep round: an event from every worker.

        Returns the list of reported (metrics, checkpoint) dicts, or None
        once every worker finished.  Raises TrainingWorkerError on worker
        death (caller restarts) and re-raises user exceptions as-is.
        """
        if self.worker_group is None:
            raise TrainBackendError("not started")
        futures = [w.get_next.remote() for w in self.worker_group.workers]
        try:
            events = ray_tpu_torch.get(futures)
        except (ActorDiedError, WorkerCrashedError) as e:
            raise TrainingWorkerError(str(e)) from e
        kinds = {k for k, _ in events}
        if kinds == {session_mod.FINISHED}:
            return None
        for kind, payload in events:
            if kind == session_mod.ERROR:
                exc, tb = payload
                raise TaskError("train_loop_per_worker", tb, exc)
        if kinds != {session_mod.REPORT}:
            raise TrainBackendError(
                f"workers out of lockstep: mixed events {kinds} — every "
                "worker must call session.report() the same number of times"
            )
        return [{"metrics": m, "checkpoint": c} for _, (m, c) in events]

    # ------------------------------------------------------------------

    def restart(self):
        """Tear down and recreate the worker group (reference
        ``_restart :625``); the caller re-invokes start_training with the
        resume checkpoint."""
        self.shutdown(graceful=False)
        self.start()

    def finish_sessions(self):
        if self.worker_group is not None:
            try:
                ray_tpu_torch.get([w.end_session.remote()
                             for w in self.worker_group.workers], timeout=30)
            except Exception:  # noqa: BLE001
                pass

    def shutdown(self, graceful: bool = True):
        if self.worker_group is None:
            return
        if graceful:
            self.finish_sessions()
            try:
                self._backend.on_shutdown(self.worker_group,
                                          self._backend_config)
            except Exception:  # noqa: BLE001
                pass
        self.worker_group.shutdown()
        self.worker_group = None
