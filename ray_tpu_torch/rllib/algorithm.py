"""AlgorithmConfig — the RLlib configuration, without the Algorithm.

Counterpart of ``ray_tpu/rllib/algorithm.py:16-61``.  ``Algorithm`` is a
``tune.Trainable`` that spawns ``EnvRunner`` actors; it comes with the
runtime (ROADMAP.md §A7), so ``build()`` raises here and in every
subclass.  The learners' update functions (``ppo``, ``impala``, ``dqn``,
``sac``, ``bc``) run without it.
"""

from __future__ import annotations

from typing import Dict, Optional

_NOT_PORTED = ("{name}.build() needs Algorithm, a tune.Trainable driving "
               "EnvRunner actors, which comes with the runtime (ROADMAP.md "
               "§A7); call the learner's update function directly")


class AlgorithmConfig:
    """Fluent config (reference: `rllib/algorithms/algorithm_config.py`)."""

    def __init__(self):
        self.env_creator = None
        self.num_env_runners = 2
        self.num_envs_per_runner = 4
        self.rollout_length = 64
        self.lr = 3e-4
        self.gamma = 0.99
        self.seed = 0
        self.runner_resources: Dict[str, float] = {"CPU": 1}

    # fluent setters (subset of the reference's sections)
    def environment(self, env_creator) -> "AlgorithmConfig":
        self.env_creator = env_creator
        return self

    def env_runners(self, num_env_runners: Optional[int] = None,
                    num_envs_per_runner: Optional[int] = None,
                    rollout_length: Optional[int] = None) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_runner is not None:
            self.num_envs_per_runner = num_envs_per_runner
        if rollout_length is not None:
            self.rollout_length = rollout_length
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise TypeError(f"unknown training option {k!r}")
            setattr(self, k, v)
        return self

    def debugging(self, seed: Optional[int] = None) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    def build(self):
        raise NotImplementedError(_NOT_PORTED.format(
            name=type(self).__name__))

    def to_dict(self) -> dict:
        return {k: v for k, v in self.__dict__.items()}
