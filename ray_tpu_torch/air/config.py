"""Run/scaling/failure/checkpoint configs.

Reference analogue: `python/ray/air/config.py` (`ScalingConfig`, `RunConfig`,
`FailureConfig :524`, `CheckpointConfig`).  TPU-native addition:
``ScalingConfig.sharding`` carries a `ray_tpu_torch.parallel.ShardingConfig` so the
parallelism strategy (dp/fsdp/tp/pp/sp/ep) is declared where the reference
declares ``use_gpu`` — the worker count scales hosts, the sharding scales
chips within and across them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class ScalingConfig:
    """How many training workers, and what each one needs.

    ``use_tpu``: workers request chips, the key ``"TPU"``, one card each
    (``resources_per_worker`` may override the exact count, a share of a
    card included).  ``devices_per_worker`` has no counterpart here (a
    rank is one process with one device): the trainer raises
    ``ValueError`` when it is set.
    """

    num_workers: int = 1
    use_tpu: bool = False
    resources_per_worker: Optional[Dict[str, float]] = None
    devices_per_worker: Optional[int] = None
    placement_strategy: str = "PACK"
    # TPU-native: the parallelism strategy for the global device mesh.
    sharding: Optional[Any] = None  # ray_tpu_torch.parallel.sharding.ShardingConfig

    @property
    def _resources_per_worker_not_none(self) -> Dict[str, float]:
        if self.resources_per_worker is not None:
            return dict(self.resources_per_worker)
        return {"CPU": 1.0, "TPU": 1.0} if self.use_tpu else {"CPU": 1.0}

    def as_placement_group_bundles(self):
        return [self._resources_per_worker_not_none
                for _ in range(self.num_workers)]


@dataclass
class FailureConfig:
    """max_failures: worker-group restarts before giving up (-1 = infinite)."""

    max_failures: int = 0


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"  # "max" | "min"

    def __post_init__(self):
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be 'max' or 'min'")


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    verbose: int = 1

    def resolved_storage_path(self) -> str:
        """The LOCAL working directory.  A URI storage_path (file://,
        gs://, ... — reference: `tune/syncer.py`) stages locally and the
        controller mirrors it to the URI via the registered Syncer."""
        sp = self.storage_path or ""
        if "://" in sp:
            base = os.path.join(os.path.expanduser("~"),
                                "ray_tpu_torch_results", "_synced")
            # never stage at the SHARED _synced root: an unnamed run would
            # sync every other staged experiment into its own URI
            return os.path.join(base, self.name or "default")
        base = sp or os.path.join(os.path.expanduser("~"),
                                  "ray_tpu_torch_results")
        return os.path.join(base, self.name) if self.name else base

    def storage_uri(self) -> Optional[str]:
        """The remote mirror target (None for plain local paths)."""
        sp = self.storage_path or ""
        if "://" not in sp:
            return None
        return sp.rstrip("/") + "/" + (self.name or "default")
