"""Result of a training/tuning run (reference: `python/ray/air/result.py`)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint


@dataclass
class Result:
    metrics: Optional[Dict[str, Any]]
    checkpoint: Optional[Checkpoint]
    error: Optional[BaseException] = None
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)
    path: Optional[str] = None
    config: Optional[Dict[str, Any]] = None  # trial config (Tune results)

    @property
    def best_checkpoints(self):
        return [self.checkpoint] if self.checkpoint else []
