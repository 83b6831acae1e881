"""Replay buffers: uniform ring buffer + proportional prioritized replay.

Reference analogue: `rllib/utils/replay_buffers/replay_buffer.py` and
`prioritized_replay_buffer.py` (segment-tree proportional sampling, PER
from Schaul et al. 2015).  TPU-first framing: buffers live host-side
(numpy) on the learner; sampled batches are handed to the jitted update as
device arrays — the buffer itself never touches the chip.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["ReplayBuffer", "PrioritizedReplayBuffer"]


class ReplayBuffer:
    """Uniform FIFO ring over dict-of-arrays transitions."""

    def __init__(self, capacity: int = 100_000, seed: int = 0):
        self.capacity = int(capacity)
        self._storage: Dict[str, np.ndarray] = {}
        self._size = 0
        self._next_idx = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """Append a batch of transitions (every value shares axis-0 length).
        Returns the buffer indices written (used by PER add)."""
        keys = list(batch.keys())
        n = len(batch[keys[0]])
        if not self._storage:
            for k in keys:
                arr = np.asarray(batch[k])
                self._storage[k] = np.zeros((self.capacity,) + arr.shape[1:],
                                            arr.dtype)
        idx = (self._next_idx + np.arange(n)) % self.capacity
        for k in keys:
            self._storage[k][idx] = np.asarray(batch[k])[:len(idx)]
        self._next_idx = int((self._next_idx + n) % self.capacity)
        self._size = min(self._size + n, self.capacity)
        return idx

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, size=batch_size)
        out = {k: v[idx] for k, v in self._storage.items()}
        out["batch_indexes"] = idx
        return out


class _SumTree:
    """Flat-array binary segment tree: O(log n) update + prefix-sum query
    (reference: `rllib/execution/segment_tree.py`)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        size = 1
        while size < capacity:
            size *= 2
        self._leaf0 = size
        self._tree = np.zeros(2 * size, np.float64)

    def set(self, idx: np.ndarray, values: np.ndarray):
        pos = np.asarray(idx, np.int64) + self._leaf0
        self._tree[pos] = values
        pos = np.unique(pos // 2)
        while True:
            self._tree[pos] = self._tree[2 * pos] + self._tree[2 * pos + 1]
            if pos[0] == 1:
                break
            pos = np.unique(pos // 2)

    def total(self) -> float:
        return float(self._tree[1])

    def prefix_index(self, prefix: np.ndarray) -> np.ndarray:
        """For each prefix sum, the leaf index whose cumulative range
        contains it."""
        prefix = np.asarray(prefix, np.float64).copy()
        pos = np.ones(len(prefix), np.int64)
        while pos[0] < self._leaf0:
            left = 2 * pos
            left_sum = self._tree[left]
            go_right = prefix > left_sum
            prefix = np.where(go_right, prefix - left_sum, prefix)
            pos = np.where(go_right, left + 1, left)
        return pos - self._leaf0


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional PER: P(i) ∝ p_i^alpha; importance weights
    w_i = (N * P(i))^-beta / max w (reference:
    `rllib/utils/replay_buffers/prioritized_replay_buffer.py`)."""

    def __init__(self, capacity: int = 100_000, alpha: float = 0.6,
                 beta: float = 0.4, eps: float = 1e-6, seed: int = 0):
        super().__init__(capacity, seed)
        assert alpha >= 0
        self.alpha = alpha
        self.beta = beta
        self.eps = eps
        self._tree = _SumTree(self.capacity)
        self._max_priority = 1.0

    def add(self, batch: Dict[str, np.ndarray],
            priorities: Optional[np.ndarray] = None) -> np.ndarray:
        idx = super().add(batch)
        if priorities is None:
            prios = np.full(len(idx), self._max_priority)
        else:
            prios = np.asarray(priorities, np.float64) + self.eps
            self._max_priority = max(self._max_priority, float(prios.max()))
        self._tree.set(idx, prios ** self.alpha)
        return idx

    def sample(self, batch_size: int,
               beta: Optional[float] = None) -> Dict[str, np.ndarray]:
        beta = self.beta if beta is None else beta
        total = self._tree.total()
        # stratified: one uniform draw per equal-mass segment
        seg = total / batch_size
        targets = (np.arange(batch_size) + self._rng.random(batch_size)) * seg
        idx = self._tree.prefix_index(targets)
        idx = np.clip(idx, 0, self._size - 1)
        mass = self._tree._tree[idx + self._tree._leaf0]
        probs = mass / max(total, 1e-12)
        weights = (self._size * np.maximum(probs, 1e-12)) ** (-beta)
        weights = weights / weights.max()
        out = {k: v[idx] for k, v in self._storage.items()}
        out["batch_indexes"] = idx
        out["weights"] = weights.astype(np.float32)
        return out

    def update_priorities(self, idx: np.ndarray, priorities: np.ndarray):
        prios = np.asarray(priorities, np.float64) + self.eps
        self._max_priority = max(self._max_priority, float(prios.max()))
        self._tree.set(np.asarray(idx, np.int64), prios ** self.alpha)
