"""DQN's learner — counterpart of ``ray_tpu/rllib/dqn.py``.

``dqn_action_fn`` (epsilon-greedy over Q-values) and ``dqn_update``, the
update JAX defines inside ``DQN.build_learner`` (``dqn.py:105-133``):
the double-Q target, the Huber TD loss under importance weights, one
Adam step; it returns |td| for the prioritized replay.
``DQNConfig.build()`` raises: the ``DQN`` Algorithm, its replay buffers
and runners need the runtime (ROADMAP.md §A7).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ray_tpu_torch.rllib.algorithm import AlgorithmConfig
from ray_tpu_torch.rllib.models import policy_forward
from ray_tpu_torch.rllib.optim import apply_gradients, grads_of
from ray_tpu_torch.rllib.sample_batch import (ACTIONS, DONES, NEXT_OBS, OBS,
                                              REWARDS)

__all__ = ["DQNConfig", "dqn_action_fn", "dqn_update"]


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
