"""ray_tpu_torch.train — distributed training orchestration.

Reference analogue: `python/ray/train/` (`BaseTrainer.fit`
`base_trainer.py:570`, `DataParallelTrainer` `data_parallel_trainer.py:58`,
`BackendExecutor` `_internal/backend_executor.py:45`, `WorkerGroup`
`_internal/worker_group.py:100`, session `_internal/session.py:84`).  The
JAX package's ``JaxTrainer`` bootstraps one multi-process jax runtime across
the worker group; here ``TorchTrainer`` takes its role and joins the workers
to one torch process group (nccl where each worker holds a card of its own,
gloo where workers share one or hold none; `ray_tpu_torch/train/torch.py`),
and every parallelism strategy is a mesh over that group's ranks.
"""

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train.backend import Backend, BackendConfig
from ray_tpu_torch.train.backend_executor import BackendExecutor, TrainingWorkerError
from ray_tpu_torch.train.session import (
    get_checkpoint,
    get_context,
    get_dataset_shard,
    get_local_rank,
    get_world_rank,
    get_world_size,
    report,
)
from ray_tpu_torch.train.trainer import (
    DataParallelTrainer,
    TrainingFailedError,
)
from ray_tpu_torch.train.sklearn import SklearnTrainer
from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer
from ray_tpu_torch.train.worker_group import WorkerGroup

__all__ = [
    "Backend", "BackendConfig", "BackendExecutor", "Checkpoint",
    "CheckpointConfig", "DataParallelTrainer", "FailureConfig",
    "Result", "RunConfig", "ScalingConfig",
    "SklearnTrainer", "TorchConfig", "TorchTrainer",
    "TrainingFailedError", "TrainingWorkerError", "WorkerGroup",
    "get_checkpoint", "get_context", "get_dataset_shard", "get_local_rank",
    "get_world_rank", "get_world_size", "report",
]
