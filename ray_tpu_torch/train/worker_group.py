"""Actor-based worker group for distributed training.

Reference analogue: `python/ray/train/_internal/worker_group.py:100`
(``WorkerGroup`` fans N ``RayTrainWorker`` actors out over the cluster and
``execute``s functions on all of them).
"""

from __future__ import annotations

import os
import socket
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.train.session import (
    TrainContext,
    _TrainSession,
    _init_session,
    _shutdown_session,
)


class RayTrainWorker:
    """The actor hosting one training worker (reference:
    `worker_group.py:34` ``RayTrainWorker``)."""

    def __init__(self):
        self._session: Optional[_TrainSession] = None

    # generic remote execution (backend setup runs through this)
    def execute(self, fn: Callable, *args, **kwargs):
        return fn(*args, **kwargs)

    def node_info(self) -> Dict[str, Any]:
        return {"pid": os.getpid(), "hostname": socket.gethostname()}

    # ---------------------------------------------------------------- session

    def start_session(self, train_fn: Callable, config: Optional[dict],
                      context: TrainContext,
                      checkpoint: Optional[Checkpoint],
                      dataset_shards: Optional[Dict[str, Any]] = None):
        if self._session is not None:
            raise RuntimeError("a train session is already running")
        self._session = _TrainSession(train_fn, config, context, checkpoint)
        if dataset_shards:
            self._session._dataset_shards = dict(dataset_shards)
        _init_session(self._session)
        self._session.start()
        return True

    def get_next(self):
        """Block until the session produces its next event. Checkpoints are
        returned as (kind, payload) — see session.REPORT/FINISHED/ERROR."""
        if self._session is None:
            raise RuntimeError("no train session")
        return self._session.get_next()

    def end_session(self):
        s = self._session
        self._session = None
        _shutdown_session()
        if s is not None:
            s.finish()
        return True


class WorkerGroup:
    """N RayTrainWorker actors with per-worker resources and runtime env."""

    def __init__(self, num_workers: int,
                 resources_per_worker: Dict[str, float],
                 env_vars: Optional[Dict[str, str]] = None,
                 placement_strategy: str = "PACK"):
        self.num_workers = num_workers
        runtime_env = {"env_vars": dict(env_vars)} if env_vars else None
        opts = dict(resources_per_worker)
        # The actor's request must equal its PG bundle exactly (a bundle
        # without CPU must not gain an implicit CPU:1, or it never fits).
        num_cpus = opts.pop("CPU", 0)
        num_tpus = opts.pop("TPU", 0)
        # Reserve all worker slots atomically in one placement group
        # (reference gang-schedules train workers the same way), so a
        # half-started group can't deadlock against another job.
        from ray_tpu_torch.core.placement_group import placement_group
        from ray_tpu_torch.util.scheduling_strategies import (
            PlacementGroupSchedulingStrategy,
        )

        self._pg = placement_group(
            [dict(resources_per_worker) for _ in range(num_workers)],
            strategy=placement_strategy,
        )
        ray_tpu_torch.get(self._pg.ready(), timeout=120)
        actor_cls = ray_tpu_torch.remote(RayTrainWorker)
        self.workers = [
            actor_cls.options(
                num_cpus=num_cpus,
                num_tpus=num_tpus,
                resources=opts or None,
                runtime_env=runtime_env,
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    placement_group=self._pg,
                    placement_group_bundle_index=rank,
                ),
            ).remote()
            for rank in range(num_workers)
        ]
        # Fail fast if any worker can't come up.
        ray_tpu_torch.get([w.node_info.remote() for w in self.workers], timeout=120)

    def __len__(self):
        return self.num_workers

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        """Run ``fn(*args)`` on every worker, return all results."""
        return ray_tpu_torch.get(
            [w.execute.remote(fn, *args, **kwargs) for w in self.workers]
        )

    def execute_async(self, fn: Callable, *args, **kwargs):
        return [w.execute.remote(fn, *args, **kwargs) for w in self.workers]

    def execute_single(self, rank: int, fn: Callable, *args, **kwargs) -> Any:
        return ray_tpu_torch.get(self.workers[rank].execute.remote(fn, *args, **kwargs))

    def shutdown(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w, no_restart=True)
            except Exception:  # noqa: BLE001
                pass
        self.workers = []
        if self._pg is not None:
            from ray_tpu_torch.core.placement_group import remove_placement_group

            try:
                remove_placement_group(self._pg)
            except Exception:  # noqa: BLE001
                pass
            self._pg = None
