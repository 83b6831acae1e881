"""AIR-common layer: Checkpoint, run/scaling/failure configs, Result.

Reference analogues: `python/ray/air/checkpoint.py:66`,
`python/ray/air/config.py:524`, `python/ray/air/result.py` — shared by the
Train and Tune layers.
"""

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.checkpoint_manager import CheckpointManager, TrackedCheckpoint
from ray_tpu_torch.air.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.air.result import Result

__all__ = [
    "Checkpoint",
    "CheckpointConfig",
    "CheckpointManager",
    "TrackedCheckpoint",
    "FailureConfig",
    "RunConfig",
    "Result",
    "ScalingConfig",
]
