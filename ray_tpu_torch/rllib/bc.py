"""BC's learner — counterpart of ``ray_tpu/rllib/bc.py``.

``bc_update`` is the update JAX defines inside ``BC.build_learner``
(``bc.py:71-83``): the mean negative log-likelihood of the dataset's
actions under the policy, one Adam step.  ``BCConfig.build()`` raises:
the ``BC`` Algorithm (its offline dataset and evaluation runners) needs
the runtime (ROADMAP.md §A7).
"""

from __future__ import annotations

import torch

from ray_tpu_torch.rllib.algorithm import AlgorithmConfig
from ray_tpu_torch.rllib.models import policy_forward
from ray_tpu_torch.rllib.optim import apply_gradients, grads_of

__all__ = ["BCConfig", "bc_update"]


class BCConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.train_batch_size = 256
        self.num_updates_per_iter = 64
        self.hidden = (64, 64)
        self.dataset = None  # {"obs": ..., "actions": ...}

    def offline_data(self, dataset) -> "BCConfig":
        self.dataset = dataset
        return self


def bc_update(params, optimizer: torch.optim.Optimizer, obs, actions):
    """One step of cross-entropy on (obs, actions); ``params`` change in
    place through ``optimizer`` (Adam over ``tree_leaves(params)``).
    Returns the loss before the step."""
    logits, _ = policy_forward(params, obs)
    logp = torch.log_softmax(logits, dim=-1)
    loss = torch.mean(-logp.gather(-1, actions.long()[:, None])[:, 0])
    apply_gradients(optimizer, params, grads_of(loss, params))
    return loss.detach()
