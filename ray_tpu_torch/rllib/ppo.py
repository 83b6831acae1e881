"""PPO's learner — counterpart of ``ray_tpu/rllib/ppo.py``.

``compute_gae`` is a copy of the numpy function; ``_make_update_fn`` is
the clipped-surrogate update with GAE advantages, run as a loop over
``num_epochs`` x ``num_mb`` shuffled minibatches where JAX scans them in
one program.  ``PPO`` is the Algorithm around it (``ppo.py:119-194``): the
minibatch order comes from the learner's generator, seeded with
``seed + 1``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import (Algorithm, AlgorithmConfig,
                                           to_learner)
from ray_tpu_torch.rllib.models import (init_mlp_policy, load_params,
                                        mlp_forward, params_to_numpy)
from ray_tpu_torch.rllib.optim import (adam, apply_gradients,
                                       clip_by_global_norm, grads_of)
from ray_tpu_torch.rllib.sample_batch import (ACTIONS, ADVANTAGES, DONES,
                                              LOGPS, OBS, REWARDS, TARGETS,
                                              VALUES, SampleBatch)


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

    def build(self) -> "PPO":
        return PPO(self)


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


class PPO(Algorithm):
    _config_cls = PPOConfig

    def build_learner(self):
        cfg: PPOConfig = self.algo_config
        device = self.learner_device()
        probe_env = cfg.env_creator()
        obs_dim = int(np.prod(probe_env.observation_space.shape))
        num_actions = int(probe_env.action_space.n)
        probe_env.close()
        self._params = init_mlp_policy(
            torch.Generator(device=device).manual_seed(cfg.seed), obs_dim,
            num_actions, cfg.hidden, device=device)
        self._optimizer = adam(self._params, cfg.lr)
        self._update = _make_update_fn(cfg, self._optimizer)
        self._generator = torch.Generator(device=device).manual_seed(
            cfg.seed + 1)

    def get_weights(self):
        return params_to_numpy(self._params)

    def set_weights(self, weights):
        load_params(self._params, weights)

    def training_step(self) -> Dict[str, Any]:
        """sample -> GAE -> minibatch-epoch update -> broadcast
        (reference `ppo.py:420`)."""
        cfg: PPOConfig = self.algo_config
        rollouts = self.synchronous_parallel_sample()
        batches: List[SampleBatch] = []
        for ro in rollouts:
            b = ro["batch"]
            T, B = ro["t_shape"]
            adv, targets = compute_gae(
                b[REWARDS].reshape(T, B), b[VALUES].reshape(T, B),
                b[DONES].reshape(T, B), ro["last_values"],
                cfg.gamma, cfg.gae_lambda)
            b[ADVANTAGES] = adv.reshape(T * B).astype(np.float32)
            b[TARGETS] = targets.reshape(T * B).astype(np.float32)
            batches.append(b)
        train_batch = SampleBatch.concat(batches)
        learn_batch = {k: train_batch[k] for k in (
            OBS, ACTIONS, LOGPS, VALUES, ADVANTAGES, TARGETS)}
        metrics = self._update(
            self._params, to_learner(learn_batch, self._generator.device),
            self._generator)
        self.sync_weights()
        out = {k: float(v) for k, v in metrics.items()}
        out["_steps_this_iter"] = train_batch.count
        return out
