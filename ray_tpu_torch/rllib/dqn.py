"""DQN's learner — counterpart of ``ray_tpu/rllib/dqn.py``.

``dqn_action_fn`` (epsilon-greedy over Q-values) and ``dqn_update``, the
update JAX defines inside ``DQN.build_learner`` (``dqn.py:105-133``):
the double-Q target, the Huber TD loss under importance weights, one
Adam step; it returns |td| for the prioritized replay.  ``DQN`` is the
Algorithm around it (``dqn.py:70-210``): epsilon-greedy runners, the
copied replay buffers (``replay_buffers.py``, host-side numpy) and the
target network.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import (Algorithm, AlgorithmConfig,
                                           to_learner)
from ray_tpu_torch.rllib.models import (init_mlp_policy, load_params,
                                        params_to_numpy, policy_forward)
from ray_tpu_torch.rllib.optim import (adam, apply_gradients, grads_of,
                                       tree_map)
from ray_tpu_torch.rllib.sample_batch import (ACTIONS, DONES, NEXT_OBS, OBS,
                                              REWARDS)

__all__ = ["DQNConfig", "DQN", "dqn_action_fn", "dqn_update"]


@torch.no_grad()
def dqn_action_fn(weights, obs, generator: Optional[torch.Generator] = None,
                  noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Epsilon-greedy over Q-values -> (action, zeros, zeros), the
    EnvRunner action_fn contract; epsilon rides in ``weights``.  The
    random action and the uniform draw that decides exploring come from
    ``generator``, or are given as ``noise`` = (actions (B,), uniform
    (B,))."""
    q, _ = policy_forward(weights["params"], obs)
    greedy = torch.argmax(q, dim=-1)
    if noise is None:
        dev = generator.device
        noise = (torch.randint(0, q.shape[-1], greedy.shape,
                               generator=generator, device=dev),
                 torch.rand(greedy.shape, generator=generator, device=dev))
    rand, u = (x.to(q.device) for x in noise)
    explore = u < weights["epsilon"]
    action = torch.where(explore, rand.long(), greedy)
    zeros = torch.zeros(greedy.shape, dtype=torch.float32, device=q.device)
    return action, zeros, zeros


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.buffer_size = 50_000
        self.train_batch_size = 64
        self.learning_starts = 1_000
        self.num_updates_per_iter = 32
        self.target_network_update_freq = 500   # env steps
        self.double_q = True
        self.prioritized_replay = True
        self.per_alpha = 0.6
        self.per_beta = 0.4
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_anneal_steps = 10_000
        self.hidden = (64, 64)

    def build(self) -> "DQN":
        return DQN(self)


def dqn_update(cfg: DQNConfig, params, target_params,
               optimizer: torch.optim.Optimizer, batch):
    """One step on ``batch`` (OBS, ACTIONS, REWARDS, NEXT_OBS, DONES and
    the importance ``weights``): ``params`` change in place through
    ``optimizer`` (Adam over ``tree_leaves(params)``); returns (loss,
    |td|).  With ``cfg.double_q`` the online net picks the next action
    and the target net values it."""
    q_all, _ = policy_forward(params, batch[OBS])
    q = q_all.gather(-1, batch[ACTIONS].long()[:, None])[:, 0]
    with torch.no_grad():
        qt_all, _ = policy_forward(target_params, batch[NEXT_OBS])
        if cfg.double_q:
            qn_all, _ = policy_forward(params, batch[NEXT_OBS])
            a_star = torch.argmax(qn_all, dim=-1)
        else:
            a_star = torch.argmax(qt_all, dim=-1)
        q_next = qt_all.gather(-1, a_star[:, None])[:, 0]
        target = batch[REWARDS] + cfg.gamma * (1.0 - batch[DONES]) * q_next
    td = q - target
    huber = torch.where(torch.abs(td) <= 1.0, 0.5 * td ** 2,
                        torch.abs(td) - 0.5)
    loss = torch.mean(batch["weights"] * huber)
    apply_gradients(optimizer, params, grads_of(loss, params))
    return loss.detach(), torch.abs(td).detach()


def _copy(params):
    """A detached copy of a parameter tree (the target network)."""
    return tree_map(lambda p: p.detach().clone(), params)


class DQN(Algorithm):
    _config_cls = DQNConfig

    def runner_kwargs(self) -> Dict[str, Any]:
        return {"action_fn": dqn_action_fn, "store_next_obs": True}

    # ------------------------------------------------------------- learner

    def build_learner(self):
        from ray_tpu_torch.rllib.replay_buffers import (
            PrioritizedReplayBuffer, ReplayBuffer,
        )

        cfg = self.algo_config
        device = self.learner_device()
        env = cfg.env_creator()
        obs_dim = int(np.prod(env.observation_space.shape))
        num_actions = int(env.action_space.n)
        env.close()

        self.params = init_mlp_policy(
            torch.Generator(device=device).manual_seed(cfg.seed), obs_dim,
            num_actions, cfg.hidden, device=device)
        self.target_params = _copy(self.params)
        self._opt = adam(self.params, cfg.lr)
        self.buffer = (
            PrioritizedReplayBuffer(cfg.buffer_size, cfg.per_alpha,
                                    cfg.per_beta, seed=cfg.seed)
            if cfg.prioritized_replay
            else ReplayBuffer(cfg.buffer_size, seed=cfg.seed))
        self._steps_since_target_sync = 0
        self._device = device

    # ---------------------------------------------------------------- step

    def epsilon(self) -> float:
        cfg = self.algo_config
        frac = min(1.0, self._total_env_steps
                   / max(1, cfg.epsilon_anneal_steps))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final
                                             - cfg.epsilon_initial)

    def get_weights(self):
        return {"params": params_to_numpy(self.params),
                "epsilon": np.float32(self.epsilon())}

    def set_weights(self, weights):
        load_params(self.params, weights["params"])
        load_params(self.target_params,
                    weights.get("target_params", weights["params"]))
        # a fresh optimizer state, as the reference's ``_opt.init``
        self._opt = adam(self.params, self.algo_config.lr)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        rollouts = self.synchronous_parallel_sample()
        steps_this_iter = 0
        for ro in rollouts:
            b = ro["batch"]
            n = len(b[REWARDS])
            steps_this_iter += n
            self.buffer.add({
                OBS: b[OBS], ACTIONS: b[ACTIONS], REWARDS: b[REWARDS],
                NEXT_OBS: b[NEXT_OBS], DONES: b[DONES],
            })
        self._steps_since_target_sync += steps_this_iter

        losses = []
        if len(self.buffer) >= cfg.learning_starts:
            for _ in range(cfg.num_updates_per_iter):
                sample = self.buffer.sample(cfg.train_batch_size)
                if "weights" not in sample:
                    sample["weights"] = np.ones(
                        cfg.train_batch_size, np.float32)
                idx = sample.pop("batch_indexes")
                loss, td_abs = dqn_update(
                    cfg, self.params, self.target_params, self._opt,
                    to_learner(sample, self._device))
                losses.append(float(loss))
                if hasattr(self.buffer, "update_priorities"):
                    self.buffer.update_priorities(idx, td_abs.cpu().numpy())
            if self._steps_since_target_sync \
                    >= cfg.target_network_update_freq:
                self.target_params = _copy(self.params)
                self._steps_since_target_sync = 0
        self.sync_weights()
        return {
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "epsilon": self.epsilon(),
            "buffer_size": len(self.buffer),
            "_steps_this_iter": steps_this_iter,
        }

    def save_checkpoint(self):
        return {
            "weights": {
                "params": params_to_numpy(self.params),
                "target_params": params_to_numpy(self.target_params),
            },
            "total_env_steps": self._total_env_steps,
        }
