"""Multi-agent RL: the MultiAgentEnv contract, a multi-agent rollout
actor, and multi-agent PPO with per-policy sample batches.

Reference analogues: `rllib/env/multi_agent_env.py:1` (dict-keyed
obs/action/reward protocol with the "__all__" done key),
`rllib/evaluation/rollout_worker.py` (policy_mapping_fn routing agents to
policies), `rllib/policy/sample_batch.py:MultiAgentBatch`.

Scope: simultaneous-move envs (every agent acts every step — the common
cooperative/competitive matrix and gridworld cases).  Each policy gets
its own params/optimizer and its own time-major SampleBatch assembled
from the streams of all agents mapped to it; updates reuse PPO's jitted
minibatch-epoch program per policy.

Counterpart of ``ray_tpu/rllib/multi_agent.py``: the runner samples with
the port's ``sample_action`` and a ``torch.Generator`` seeded from
``seed``; each policy has its own generator for its initial parameters
(``seed + 101 + i``, the reference's keys) and one for its minibatch
order (``seed + 1 + i``), in place of ``jax.random``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm, to_learner
from ray_tpu_torch.rllib.ppo import PPOConfig, _make_update_fn, compute_gae
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS, ADVANTAGES, DONES, LOGPS, OBS, REWARDS, TARGETS, VALUES,
    SampleBatch,
)

__all__ = ["MultiAgentEnv", "MultiAgentEnvRunner", "MultiAgentPPO",
           "MultiAgentPPOConfig"]


class MultiAgentEnv:
    """Dict-keyed env protocol (reference: `rllib/env/multi_agent_env.py`).

    * ``agents``: list of agent ids (static for the episode).
    * ``reset() -> (obs_dict, info_dict)``
    * ``step(action_dict) -> (obs, rewards, terminateds, truncateds,
      infos)`` — dicts keyed by agent id; ``terminateds["__all__"]`` /
      ``truncateds["__all__"]`` end the episode for everyone.
    """

    agents: List[str] = []

    def reset(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        raise NotImplementedError

    def step(self, action_dict: Dict[str, Any]):
        raise NotImplementedError

    def close(self):
        pass


class MultiAgentEnvRunner:
    """Rollout actor for MultiAgentEnv: steps one env, batching each
    policy's agents through one jitted forward per step, and returns a
    per-POLICY time-major SampleBatch."""

    def __init__(self, env_creator, rollout_length: int,
                 policy_mapping_fn, seed: int = 0):
        from ray_tpu_torch.rllib.models import sample_action

        self._env: MultiAgentEnv = env_creator()
        self._T = rollout_length
        self._map = policy_mapping_fn
        self._agents = list(self._env.agents)
        # stable per-policy agent grouping (simultaneous-move assumption)
        self._groups: Dict[str, List[str]] = {}
        for a in self._agents:
            self._groups.setdefault(self._map(a), []).append(a)
        self._weights: Optional[Dict[str, Any]] = None
        self._generator = torch.Generator().manual_seed(seed)
        self._fwd = sample_action
        obs, _ = self._env.reset()
        self._obs = obs
        self._ep_return = 0.0
        self._completed: list = []

    def set_weights(self, weights: Dict[str, Any]):
        from ray_tpu_torch.rllib.models import params_from_numpy

        self._weights = params_from_numpy(weights, device="cpu")
        return True

    def sample(self) -> Dict[str, Any]:
        assert self._weights is not None, "set_weights before sample"
        T = self._T
        bufs = {
            pid: {
                OBS: [], ACTIONS: [], LOGPS: [], VALUES: [],
                REWARDS: [], DONES: [],
            } for pid in self._groups
        }
        for _ in range(T):
            act_dict: Dict[str, Any] = {}
            step_rows: Dict[str, tuple] = {}
            for pid, agents in self._groups.items():
                obs_b = np.stack([np.asarray(self._obs[a], np.float32)
                                  for a in agents])
                a, logp, value = self._fwd(self._weights[pid],
                                           torch.from_numpy(obs_b),
                                           self._generator)
                a, logp, value = a.numpy(), logp.numpy(), value.numpy()
                for i, ag in enumerate(agents):
                    act_dict[ag] = int(a[i])
                step_rows[pid] = (obs_b, a, np.asarray(logp),
                                  np.asarray(value))
            obs, rewards, terms, truncs, _ = self._env.step(act_dict)
            done = bool(terms.get("__all__")) or bool(truncs.get("__all__"))
            for pid, agents in self._groups.items():
                obs_b, a, logp, value = step_rows[pid]
                bufs[pid][OBS].append(obs_b)
                bufs[pid][ACTIONS].append(a)
                bufs[pid][LOGPS].append(logp)
                bufs[pid][VALUES].append(value)
                bufs[pid][REWARDS].append(np.asarray(
                    [rewards.get(ag, 0.0) for ag in agents], np.float32))
                bufs[pid][DONES].append(
                    np.full(len(agents), float(done), np.float32))
            self._ep_return += float(sum(rewards.values()))
            if done:
                self._completed.append((self._ep_return, 0))
                self._ep_return = 0.0
                obs, _ = self._env.reset()
            self._obs = obs

        batches: Dict[str, SampleBatch] = {}
        t_shapes: Dict[str, tuple] = {}
        last_values: Dict[str, np.ndarray] = {}
        env_steps = 0
        for pid, agents in self._groups.items():
            B = len(agents)
            cols = {k: np.stack(v) for k, v in bufs[pid].items()}  # (T,B,..)
            obs_b = np.stack([np.asarray(self._obs[a], np.float32)
                              for a in agents])
            _, _, last_v = self._fwd(self._weights[pid],
                                     torch.from_numpy(obs_b),
                                     self._generator)
            batches[pid] = SampleBatch({
                k: v.reshape((T * B,) + v.shape[2:]) for k, v in cols.items()
            })
            t_shapes[pid] = (T, B)
            last_values[pid] = last_v.numpy().astype(np.float32)
            env_steps += T * B
        completed, self._completed = self._completed, []
        return {
            "batches": batches,
            "t_shape": t_shapes,
            "last_values": last_values,
            "metrics": {"env_steps": env_steps,
                        "episodes": completed},
        }


class MultiAgentPPOConfig(PPOConfig):
    """PPO over per-policy batches.  ``multi_agent(policies=...,
    policy_mapping_fn=...)`` declares the policy map (reference:
    `AlgorithmConfig.multi_agent`)."""

    def __init__(self):
        super().__init__()
        # policy_id -> (obs_dim, num_actions)
        self.policies: Dict[str, Tuple[int, int]] = {}
        self.policy_mapping_fn: Callable[[str], str] = lambda aid: aid

    def multi_agent(self, policies: Dict[str, Tuple[int, int]],
                    policy_mapping_fn: Optional[Callable] = None
                    ) -> "MultiAgentPPOConfig":
        self.policies = dict(policies)
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        return self

    def build(self) -> "MultiAgentPPO":
        return MultiAgentPPO(self)


class MultiAgentPPO(Algorithm):
    _config_cls = MultiAgentPPOConfig

    def runner_class(self):
        return MultiAgentEnvRunner

    def runner_args(self, cfg, i: int) -> tuple:
        return (cfg.env_creator, cfg.rollout_length,
                cfg.policy_mapping_fn, cfg.seed + i)

    def build_learner(self):
        from ray_tpu_torch.rllib.models import init_mlp_policy
        from ray_tpu_torch.rllib.optim import adam

        cfg: MultiAgentPPOConfig = self.algo_config
        assert cfg.policies, "config.multi_agent(policies=...) missing"
        device = self.learner_device()
        self._params: Dict[str, Any] = {}
        self._updates: Dict[str, Any] = {}
        self._generators: Dict[str, torch.Generator] = {}
        for i, (pid, (obs_dim, n_act)) in enumerate(
                sorted(cfg.policies.items())):
            self._params[pid] = init_mlp_policy(
                torch.Generator(device=device).manual_seed(
                    cfg.seed + 101 + i), obs_dim, n_act, cfg.hidden,
                device=device)
            self._updates[pid] = _make_update_fn(
                cfg, adam(self._params[pid], cfg.lr))
            self._generators[pid] = torch.Generator(
                device=device).manual_seed(cfg.seed + 1 + i)

    def get_weights(self):
        from ray_tpu_torch.rllib.models import params_to_numpy

        return {pid: params_to_numpy(p) for pid, p in self._params.items()}

    def set_weights(self, weights):
        from ray_tpu_torch.rllib.models import load_params

        for pid, w in weights.items():
            load_params(self._params[pid], w)

    def training_step(self) -> Dict[str, Any]:
        cfg: MultiAgentPPOConfig = self.algo_config
        rollouts = self.synchronous_parallel_sample()
        # assemble one train batch PER POLICY across runners
        per_policy: Dict[str, List[SampleBatch]] = {}
        for ro in rollouts:
            for pid, b in ro["batches"].items():
                T, B = ro["t_shape"][pid]
                adv, targets = compute_gae(
                    b[REWARDS].reshape(T, B), b[VALUES].reshape(T, B),
                    b[DONES].reshape(T, B), ro["last_values"][pid],
                    cfg.gamma, cfg.gae_lambda)
                b[ADVANTAGES] = adv.reshape(T * B).astype(np.float32)
                b[TARGETS] = targets.reshape(T * B).astype(np.float32)
                per_policy.setdefault(pid, []).append(b)
        metrics: Dict[str, Any] = {}
        for pid, batches in per_policy.items():
            tb = SampleBatch.concat(batches)
            learn = {
                OBS: tb[OBS], ACTIONS: tb[ACTIONS], LOGPS: tb[LOGPS],
                VALUES: tb[VALUES], ADVANTAGES: tb[ADVANTAGES],
                TARGETS: tb[TARGETS],
            }
            gen = self._generators[pid]
            m = self._updates[pid](self._params[pid],
                                   to_learner(learn, gen.device), gen)
            metrics[f"{pid}/policy_loss"] = float(m["policy_loss"])
            metrics[f"{pid}/entropy"] = float(m["entropy"])
        steps = sum(ro["metrics"]["env_steps"] for ro in rollouts)
        metrics["_steps_this_iter"] = steps
        self.sync_weights()
        return metrics
