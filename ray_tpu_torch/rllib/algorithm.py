"""Algorithm — the RLlib training driver, a Tune Trainable.

Reference analogue: `rllib/algorithms/algorithm.py:191` (``Algorithm``
is a Tune ``Trainable``; ``step`` :813 delegates to ``training_step``)
+ `rllib/evaluation/worker_set.py:80` (actor fan-out).

Counterpart of ``ray_tpu/rllib/algorithm.py``: the rollout actors are kept
off the card (``CUDA_VISIBLE_DEVICES=""``), and the learner lives on the
device ``AlgorithmConfig.learner_device`` names, the card unless the config
says ``"cpu"``; ``Algorithm.learner_device()`` raises where no card is
visible rather than fall back to the CPU.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.tune.trainable import Trainable


def to_learner(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """A dict of numpy arrays as tensors on the learner's ``device``, dtypes
    kept (uint8 frames stay uint8; the policy scales them).  An array read
    from the object store is read-only and is copied first."""
    import numpy as np
    import torch

    def tensor(v):
        v = np.asarray(v)
        if not (v.flags.writeable and v.flags.c_contiguous):
            v = np.array(v)
        return torch.from_numpy(v).to(device)

    return {k: tensor(v) for k, v in batch.items()}


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
        # the learner's torch device: the card unless a caller names "cpu"
        self.learner_device = "cuda"

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
        raise NotImplementedError("use a concrete config (e.g. PPOConfig)")

    def to_dict(self) -> dict:
        return {k: v for k, v in self.__dict__.items()}


class Algorithm(Trainable):
    """Drives EnvRunner actors + a local jitted learner.

    ``train()`` (inherited) calls ``step`` -> ``training_step`` and
    appends iteration bookkeeping, matching the reference layering.
    """

    _config_cls = AlgorithmConfig

    def __init__(self, config=None):
        if isinstance(config, AlgorithmConfig):
            self._algo_config = config
            config = config.to_dict()
        else:
            self._algo_config = None
        super().__init__(config or {})

    def setup(self, config: Dict[str, Any]):
        import ray_tpu_torch

        cfg = self._algo_config
        if cfg is None:
            cfg = self._config_cls()
            for k, v in (config or {}).items():
                if hasattr(cfg, k):
                    setattr(cfg, k, v)
        self.algo_config = cfg
        assert cfg.env_creator is not None, "config.environment(...) missing"
        res = dict(cfg.runner_resources)
        # Env runners are the CPU plane: keep the card hidden from them
        # so N runner processes never contend for the learner's chip
        # (SURVEY §7: CPU env actors feed the accelerator learner).
        runner_cls = ray_tpu_torch.remote(
            num_cpus=res.get("CPU", 1), max_restarts=1,
            runtime_env={"env_vars": {"CUDA_VISIBLE_DEVICES": ""}},
        )(self.runner_class())
        self.env_runners = [
            runner_cls.remote(*self.runner_args(cfg, i),
                              **self.runner_kwargs())
            for i in range(cfg.num_env_runners)
        ]
        self._total_env_steps = 0
        self._episode_returns: List[float] = []
        self.build_learner()
        self.sync_weights()

    # ---- override points -----------------------------------------------

    def runner_class(self):
        """The rollout-actor class (multi-agent algorithms override)."""
        from ray_tpu_torch.rllib.env_runner import EnvRunner

        return EnvRunner

    def runner_args(self, cfg, i: int) -> tuple:
        """Positional args for the i-th runner actor."""
        return (cfg.env_creator, cfg.num_envs_per_runner,
                cfg.rollout_length, None, cfg.seed + i)

    def runner_kwargs(self) -> Dict[str, Any]:
        """Extra EnvRunner kwargs (e.g. DQN's epsilon-greedy action_fn)."""
        return {}

    def learner_device(self):
        """The learner's ``torch.device``, from ``learner_device``; the card
        raises where none is visible (no fall back to the CPU)."""
        import torch

        device = torch.device(self.algo_config.learner_device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{type(self).__name__}'s learner needs a CUDA card and none "
                "is visible; set learner_device='cpu' in the config (e.g. "
                "config.training(learner_device='cpu')) to learn on the CPU")
        return device

    def build_learner(self):
        raise NotImplementedError

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def get_weights(self):
        raise NotImplementedError

    def set_weights(self, weights):
        raise NotImplementedError

    # ---- shared plumbing -----------------------------------------------

    def sync_weights(self):
        """Broadcast learner weights to all runners (reference:
        ``WorkerSet.sync_weights``)."""
        import ray_tpu_torch

        w = self.get_weights()
        ray_tpu_torch.get([r.set_weights.remote(w) for r in self.env_runners],
                    timeout=60)

    def synchronous_parallel_sample(self) -> List[dict]:
        """Reference: `rllib/execution/rollout_ops.py:21`."""
        import ray_tpu_torch

        rollouts = ray_tpu_torch.get(
            [r.sample.remote() for r in self.env_runners], timeout=300)
        for ro in rollouts:
            self._total_env_steps += ro["metrics"]["env_steps"]
            self._episode_returns.extend(
                ep[0] for ep in ro["metrics"]["episodes"])
        return rollouts

    def step(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        info = self.training_step()
        dt = time.perf_counter() - t0
        recent = self._episode_returns[-100:]
        out = {
            "episode_reward_mean": (sum(recent) / len(recent)
                                    if recent else float("nan")),
            "num_env_steps_sampled": self._total_env_steps,
            "env_steps_per_sec": (info.pop("_steps_this_iter", 0) / dt
                                  if dt > 0 else 0.0),
        }
        out.update(info)
        return out

    def save_checkpoint(self) -> Optional[dict]:
        return {"weights": self.get_weights(),
                "total_env_steps": self._total_env_steps}

    def load_checkpoint(self, data: dict):
        self.set_weights(data["weights"])
        self._total_env_steps = data.get("total_env_steps", 0)
        self.sync_weights()

    def cleanup(self):
        import ray_tpu_torch

        for r in self.env_runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:  # noqa: BLE001
                pass

    def stop(self):
        self.cleanup()
