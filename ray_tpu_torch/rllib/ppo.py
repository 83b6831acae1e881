"""PPO's learner — counterpart of ``ray_tpu/rllib/ppo.py``.

``compute_gae`` is a copy of the numpy function; ``_make_update_fn`` is
the clipped-surrogate update with GAE advantages, run as a loop over
``num_epochs`` x ``num_mb`` shuffled minibatches where JAX scans them in
one program.  ``PPOConfig.build()`` raises: the ``PPO`` Algorithm needs
the runtime (ROADMAP.md §A7).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import AlgorithmConfig
from ray_tpu_torch.rllib.models import mlp_forward
from ray_tpu_torch.rllib.optim import (apply_gradients, clip_by_global_norm,
                                       grads_of)
from ray_tpu_torch.rllib.sample_batch import (ACTIONS, ADVANTAGES, LOGPS,
                                              OBS, TARGETS, VALUES)


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.gae_lambda = 0.95
        self.clip_param = 0.2
        self.vf_clip_param = 10.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.num_epochs = 4
        self.minibatch_size = 512
        self.grad_clip = 0.5
        self.hidden = (64, 64)


def compute_gae(rewards, values, dones, last_values, gamma, lam):
    """Time-major (T, B) numpy GAE (reference:
    `rllib/evaluation/postprocessing.py` ``compute_advantages``)."""
    T = rewards.shape[0]
    adv = np.zeros_like(rewards)
    gae = np.zeros_like(last_values)
    next_value = last_values
    for t in range(T - 1, -1, -1):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        gae = delta + gamma * lam * nonterminal * gae
        adv[t] = gae
        next_value = values[t]
    targets = adv + values
    return adv, targets


def minibatch_indices(n: int, cfg: PPOConfig,
                      generator: torch.Generator) -> torch.Tensor:
    """(num_epochs * num_mb, mb_size) row indices: each epoch a fresh
    permutation of the n rows, cut to num_mb = max(n // minibatch_size,
    1) minibatches of n // num_mb rows."""
    num_mb = max(n // cfg.minibatch_size, 1)
    mb_size = n // num_mb
    idx = torch.cat([torch.randperm(n, generator=generator,
                                    device=generator.device)
                     [:num_mb * mb_size] for _ in range(cfg.num_epochs)])
    return idx.reshape(cfg.num_epochs * num_mb, mb_size)


def _make_update_fn(cfg: PPOConfig, optimizer: torch.optim.Optimizer):
    """Returns ``update(params, batch, generator=None, idx=None) ->
    metrics``: SGD over ``idx``'s minibatches (``minibatch_indices`` from
    ``generator`` when not given), ``optimizer`` (over
    ``tree_leaves(params)``) stepping the leaves in place; the metrics are
    the last minibatch's, before its step."""

    def loss_fn(params, mb):
        logits, value = mlp_forward(params, mb[OBS])
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = logp_all.gather(-1, mb[ACTIONS].long()[:, None])[:, 0]
        ratio = torch.exp(logp - mb[LOGPS])
        adv = mb[ADVANTAGES]
        # jnp.std is the population std
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        surr = torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - cfg.clip_param, 1 + cfg.clip_param) * adv)
        policy_loss = -surr.mean()
        # clipped value loss (reference PPO `vf_clip_param`)
        vf_err = torch.square(value - mb[TARGETS])
        vf_clipped = mb[VALUES] + torch.clamp(
            value - mb[VALUES], -cfg.vf_clip_param, cfg.vf_clip_param)
        vf_err2 = torch.square(vf_clipped - mb[TARGETS])
        vf_loss = 0.5 * torch.maximum(vf_err, vf_err2).mean()
        entropy = -torch.sum(torch.exp(logp_all) * logp_all, dim=-1).mean()
        total = (policy_loss + cfg.vf_loss_coeff * vf_loss
                 - cfg.entropy_coeff * entropy)
        kl = (mb[LOGPS] - logp).mean()
        return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                       "entropy": entropy, "kl": kl}

    def update(params, batch, generator: Optional[torch.Generator] = None,
               idx: Optional[torch.Tensor] = None):
        if idx is None:
            idx = minibatch_indices(batch[OBS].shape[0], cfg, generator)
        idx = idx.to(batch[OBS].device)
        for rows in idx:
            mb = {k: v[rows] for k, v in batch.items()}
            total, metrics = loss_fn(params, mb)
            grads = grads_of(total, params)
            if cfg.grad_clip:
                grads = clip_by_global_norm(grads, cfg.grad_clip)
            apply_gradients(optimizer, params, grads)
        return {k: v.detach() for k, v in metrics.items()}

    return update
