"""SampleBatch — columnar rollout data.

A copy of ``ray_tpu/rllib/sample_batch.py`` (numpy only): the column
names and ``SampleBatch``, a dict of parallel arrays with concat and
shuffled-minibatch helpers.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np

OBS = "obs"
ACTIONS = "actions"
REWARDS = "rewards"
DONES = "dones"
NEXT_OBS = "next_obs"
LOGPS = "logps"
VALUES = "values"
ADVANTAGES = "advantages"
TARGETS = "value_targets"


class SampleBatch(dict):
    """dict[str, np.ndarray] with equal leading dims."""

    @property
    def count(self) -> int:
        for v in self.values():
            return len(v)
        return 0

    @staticmethod
    def concat(batches: List["SampleBatch"]) -> "SampleBatch":
        keys = batches[0].keys()
        return SampleBatch({
            k: np.concatenate([b[k] for b in batches]) for k in keys
        })

    def shuffled_minibatches(self, minibatch_size: int,
                             rng: np.random.Generator
                             ) -> Iterator["SampleBatch"]:
        n = self.count
        perm = rng.permutation(n)
        for start in range(0, n - minibatch_size + 1, minibatch_size):
            idx = perm[start:start + minibatch_size]
            yield SampleBatch({k: v[idx] for k, v in self.items()})
