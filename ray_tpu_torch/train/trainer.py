"""Trainers: DataParallelTrainer (``TorchTrainer`` in ``train/torch.py``).

Reference analogues: `python/ray/train/base_trainer.py:570` (``fit``),
`python/ray/train/data_parallel_trainer.py:58,432` (worker fan-out +
``training_loop``), `python/ray/train/trainer.py:41` (``TrainingIterator``
draining result rounds, restarting on failure).

The reference routes every Trainer through Tune; here ``fit()`` runs
standalone (Tune wraps a trainer as a trainable instead — the dependency
points the other way, which keeps the stack usable without Tune).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.checkpoint_manager import CheckpointManager
from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train.backend import BackendConfig
from ray_tpu_torch.train.backend_executor import (
    BackendExecutor,
    TrainingWorkerError,
)


class TrainingFailedError(RuntimeError):
    pass


class DataParallelTrainer:
    """SPMD training: the same ``train_loop_per_worker`` on N workers.

    With a TorchConfig backend the workers form ONE torch process group,
    so "data parallel" here covers every layout the loop chooses —
    dp/fsdp/tp/sp/ep/pp are all expressible inside the loop via
    ShardingConfig over the group's ranks.
    """

    _default_backend_config: BackendConfig = BackendConfig()

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        backend_config: Optional[BackendConfig] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        self._train_loop = train_loop_per_worker
        self._train_loop_config = train_loop_config
        self._backend_config = backend_config or self._default_backend_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig(
            name=f"train_{time.strftime('%Y%m%d-%H%M%S')}"
        )
        if self.run_config.name is None:
            self.run_config.name = f"train_{time.strftime('%Y%m%d-%H%M%S')}"
        self._datasets = datasets or {}
        self._resume_from_checkpoint = resume_from_checkpoint

    # ------------------------------------------------------------------

    def _dataset_splitter(self):
        """Returns a callable that splits registered datasets into
        per-rank shard dicts (ray_tpu_torch.data integration)."""
        if not self._datasets:
            return None
        datasets = self._datasets

        def split(world_size: int):
            from ray_tpu_torch.data.dataset import Dataset
            from ray_tpu_torch.data.iterator import DataIterator

            shards_per_rank = [dict() for _ in range(world_size)]
            for name, ds in datasets.items():
                if hasattr(ds, "streaming_split"):
                    # disjoint STREAMED shards — blocks are claimed from a
                    # coordinator as each worker consumes, never sliced up
                    # front (reference: stream_split_iterator.py, the
                    # reference's default Train ingest).  NOTE the shard is
                    # a consume-style iterator: count()/materialize() are
                    # unavailable on it (its share is decided by the pull
                    # loop) — loops needing a static count should count the
                    # dataset before passing it in.
                    try:
                        parts = ds.streaming_split(world_size)
                    except ValueError:  # actor-compute chain: static split
                        parts = ds.split(world_size)
                elif hasattr(ds, "split"):
                    parts = ds.split(world_size)
                else:  # plain list/iterable: round-robin
                    parts = [ds] * world_size
                for rank in range(world_size):
                    shard = parts[rank]
                    if isinstance(shard, Dataset):
                        # workers consume shards through the iterator API
                        # (reference: session.get_dataset_shard returns a
                        # DataIterator, `python/ray/data/iterator.py`)
                        shard = DataIterator(shard)
                    shards_per_rank[rank][name] = shard
            return shards_per_rank

        return split

    def fit(self) -> Result:
        sc = self.scaling_config
        rc = self.run_config
        exp_dir = rc.resolved_storage_path()
        ckpt_mgr = CheckpointManager(exp_dir, rc.checkpoint_config)

        if sc.devices_per_worker is not None:
            # XLA's virtual devices have no counterpart: a rank is one
            # process with one device
            raise ValueError(
                "ScalingConfig.devices_per_worker is not supported: each "
                "worker is one rank of the process group")

        executor = BackendExecutor(
            self._backend_config,
            num_workers=sc.num_workers,
            resources_per_worker=sc._resources_per_worker_not_none,
            experiment_name=rc.name or "",
        )
        max_failures = rc.failure_config.max_failures
        failures = 0
        latest_checkpoint: Optional[Checkpoint] = self._resume_from_checkpoint
        metrics_history = []
        last_metrics: Optional[dict] = None
        error: Optional[BaseException] = None

        executor.start()
        started = False
        try:
            while True:
                try:
                    if not started:
                        executor.start_training(
                            self._train_loop, self._train_loop_config,
                            checkpoint=latest_checkpoint,
                            dataset_splitter=self._dataset_splitter(),
                        )
                        started = True
                    round_results = executor.get_next_results()
                except TrainingWorkerError as e:
                    failures += 1
                    if max_failures >= 0 and failures > max_failures:
                        error = TrainingFailedError(
                            f"worker group failed {failures}x "
                            f"(max_failures={max_failures}): {e}"
                        )
                        break
                    # Restart from the latest checkpoint (reference
                    # `backend_executor.py:625`).
                    latest_checkpoint = (ckpt_mgr.latest.checkpoint
                                         if ckpt_mgr.latest
                                         else latest_checkpoint)
                    executor.restart()
                    started = False
                    continue
                if round_results is None:
                    break
                # rank-0's metrics are canonical (reference takes worker 0)
                rank0 = round_results[0]
                last_metrics = rank0["metrics"]
                metrics_history.append(last_metrics)
                ckpt = next((r["checkpoint"] for r in round_results
                             if r["checkpoint"] is not None), None)
                if ckpt is not None:
                    tracked = ckpt_mgr.register(ckpt, last_metrics)
                    latest_checkpoint = tracked.checkpoint
        except BaseException as e:  # noqa: BLE001 - user loop error
            error = e
        finally:
            executor.shutdown(graceful=error is None)

        result = Result(
            metrics=last_metrics,
            checkpoint=ckpt_mgr.latest.checkpoint if ckpt_mgr.latest
            else latest_checkpoint,
            error=error,
            metrics_history=metrics_history,
            path=exp_dir,
        )
        if error is not None and not isinstance(error, TrainingFailedError):
            raise error
        return result

    # Tune integration: a trainer is convertible to a trainable function.
    def as_trainable(self) -> Callable:
        trainer = self

        def trainable(config: Optional[dict] = None):
            from ray_tpu_torch.train import session as tune_session

            merged = dict(trainer._train_loop_config or {})
            if config:
                merged.update(config)
            trainer2 = trainer.__class__(
                trainer._train_loop,
                train_loop_config=merged,
                backend_config=trainer._backend_config,
                scaling_config=trainer.scaling_config,
                run_config=trainer.run_config,
                datasets=trainer._datasets,
                resume_from_checkpoint=tune_session.get_checkpoint(),
            )
            result = trainer2.fit()
            if result.metrics is not None:
                tune_session.report(result.metrics)

        trainable.__name__ = f"{type(self).__name__}_trainable"
        return trainable

