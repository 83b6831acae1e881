"""Checkpoint bookkeeping: persist, rank, prune.

Reference analogue: `python/ray/air/_internal/checkpoint_manager.py:251`
(`_CheckpointManager` ranks by score and prunes to ``num_to_keep``).
"""

from __future__ import annotations

import os
import pickle
import shutil
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import CheckpointConfig


@dataclass
class TrackedCheckpoint:
    checkpoint: Checkpoint
    metrics: Dict[str, Any] = field(default_factory=dict)
    index: int = 0
    path: Optional[str] = None


class CheckpointManager:
    """Persists reported checkpoints under ``directory`` and keeps the best
    ``num_to_keep`` by ``checkpoint_score_attribute`` (latest always kept)."""

    def __init__(self, directory: str, config: Optional[CheckpointConfig] = None):
        self.directory = directory
        self.config = config or CheckpointConfig()
        self._index = 0
        self._tracked: List[TrackedCheckpoint] = []
        self.latest: Optional[TrackedCheckpoint] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------

    def register(self, checkpoint: Checkpoint,
                 metrics: Optional[Dict[str, Any]] = None) -> TrackedCheckpoint:
        path = os.path.join(self.directory, f"checkpoint_{self._index:06d}")
        checkpoint.to_directory(path)
        tracked = TrackedCheckpoint(
            checkpoint=Checkpoint.from_directory(path),
            metrics=dict(metrics or {}),
            index=self._index,
            path=path,
        )
        self._index += 1
        self._tracked.append(tracked)
        self.latest = tracked
        self._prune()
        self._write_manifest()
        return tracked

    def _score(self, t: TrackedCheckpoint):
        attr = self.config.checkpoint_score_attribute
        if attr is None or attr not in t.metrics:
            return None
        v = t.metrics[attr]
        return v if self.config.checkpoint_score_order == "max" else -v

    def _prune(self):
        keep = self.config.num_to_keep
        if keep is None or len(self._tracked) <= keep:
            return
        # Latest is always kept; others ranked by score (unscored = oldest
        # first) and the worst dropped.
        candidates = [t for t in self._tracked if t is not self.latest]
        candidates.sort(key=lambda t: (self._score(t) is not None,
                                       self._score(t) or 0, t.index))
        while len(self._tracked) > keep and candidates:
            victim = candidates.pop(0)
            self._tracked.remove(victim)
            if victim.path and os.path.isdir(victim.path):
                shutil.rmtree(victim.path, ignore_errors=True)

    def _write_manifest(self):
        manifest = {
            "time": time.time(),
            "latest": self.latest.path if self.latest else None,
            "tracked": [
                {"path": t.path, "metrics": t.metrics, "index": t.index}
                for t in self._tracked
            ],
            "next_index": self._index,
        }
        tmp = os.path.join(self.directory, ".manifest.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(manifest, f)
        os.replace(tmp, os.path.join(self.directory, "manifest.pkl"))

    # ------------------------------------------------------------------

    @property
    def best(self) -> Optional[TrackedCheckpoint]:
        scored = [t for t in self._tracked if self._score(t) is not None]
        if not scored:
            return self.latest
        return max(scored, key=self._score)

    @classmethod
    def restore(cls, directory: str,
                config: Optional[CheckpointConfig] = None) -> "CheckpointManager":
        """Rebuild manager state from a prior run's manifest (resume path)."""
        mgr = cls(directory, config)
        manifest_path = os.path.join(directory, "manifest.pkl")
        if os.path.exists(manifest_path):
            with open(manifest_path, "rb") as f:
                manifest = pickle.load(f)
            mgr._index = manifest.get("next_index", 0)
            for entry in manifest.get("tracked", []):
                if entry["path"] and os.path.isdir(entry["path"]):
                    t = TrackedCheckpoint(
                        checkpoint=Checkpoint.from_directory(entry["path"]),
                        metrics=entry["metrics"], index=entry["index"],
                        path=entry["path"],
                    )
                    mgr._tracked.append(t)
                    if manifest.get("latest") == entry["path"]:
                        mgr.latest = t
            if mgr.latest is None and mgr._tracked:
                mgr.latest = max(mgr._tracked, key=lambda t: t.index)
        return mgr
