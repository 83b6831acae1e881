"""IMPALA's learner — counterpart of ``ray_tpu/rllib/impala.py``.

V-trace (Espeholt et al. 2018) as a loop over T in reverse where JAX
runs a reverse ``lax.scan``; the loss with V-trace's inputs detached
exactly where JAX calls ``stop_gradient`` (the target logps and values
going in, ``pg_adv`` and ``vs`` coming out); the gradient and its
application kept apart (``_make_grad_apply``), since a learner group
all-reduces between the two.  The optimizer is optax's RMSprop at
eps = 0.1 (``optim.RMSprop``).  ``ImpalaConfig.build()`` raises: the
``Impala`` Algorithm and its ``LearnerGroup`` need the runtime
(ROADMAP.md §A7).
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import AlgorithmConfig
from ray_tpu_torch.rllib.models import (init_cnn_policy, init_mlp_policy,
                                        policy_forward)
from ray_tpu_torch.rllib.optim import (RMSprop, apply_gradients,
                                       clip_by_global_norm, grads_of,
                                       tree_leaves)
from ray_tpu_torch.rllib.sample_batch import (ACTIONS, DONES, LOGPS, OBS,
                                              REWARDS)


class ImpalaConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.vtrace_rho_bar = 1.0
        self.vtrace_c_bar = 1.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.grad_clip = 40.0
        self.hidden = (64, 64)
        self.cnn = False  # Nature-CNN torso for (H, W, C) pixel obs
        self.max_inflight_per_runner = 1
        # >1: data-parallel learner replicas (LearnerGroup, with the runtime)
        self.num_learners = 1


def make_vtrace_fn():
    """Returns vtrace(target_logps, behavior_logps, rewards, dones, values,
    bootstrap, gamma, rho_bar, c_bar) -> (vs, pg_adv), all time-major
    (T, B), by the recurrence in reverse over t:

        vs_t = V(x_t) + dt_t + gamma_t * c_t * (vs_{t+1} - V(x_{t+1}))
        dt_t = rho_t (r_t + gamma_t V(x_{t+1}) - V(x_t))
    """

    def vtrace(target_logps, behavior_logps, rewards, dones, values,
               bootstrap, gamma, rho_bar, c_bar):
        rhos = torch.exp(target_logps - behavior_logps)
        clipped_rho = torch.clamp(rhos, max=rho_bar)
        clipped_c = torch.clamp(rhos, max=c_bar)
        discounts = gamma * (1.0 - dones)
        next_values = torch.cat([values[1:], bootstrap[None]], dim=0)
        deltas = clipped_rho * (rewards + discounts * next_values - values)
        carry = torch.zeros_like(bootstrap)
        dvs = [None] * deltas.shape[0]
        for t in range(deltas.shape[0] - 1, -1, -1):
            carry = deltas[t] + discounts[t] * clipped_c[t] * carry
            dvs[t] = carry
        vs = values + torch.stack(dvs)
        next_vs = torch.cat([vs[1:], bootstrap[None]], dim=0)
        pg_adv = clipped_rho * (rewards + discounts * next_vs - values)
        return vs, pg_adv

    return vtrace


def _make_loss_fn(cfg: ImpalaConfig):
    vtrace = make_vtrace_fn()

    def loss_fn(params, batch):
        # batch arrays are time-major (T, B, ...)
        T, B = batch[REWARDS].shape
        obs = batch[OBS].reshape((T * B,) + tuple(batch[OBS].shape[2:]))
        logits, values = policy_forward(params, obs)
        logits = logits.reshape(T, B, -1)
        values = values.reshape(T, B)
        logp_all = torch.log_softmax(logits, dim=-1)
        target_logps = logp_all.gather(
            -1, batch[ACTIONS].long()[..., None])[..., 0]
        vs, pg_adv = vtrace(
            target_logps.detach(), batch[LOGPS], batch[REWARDS],
            batch[DONES], values.detach(), batch["bootstrap"], cfg.gamma,
            cfg.vtrace_rho_bar, cfg.vtrace_c_bar)
        pg_loss = -torch.mean(target_logps * pg_adv.detach())
        vf_loss = 0.5 * torch.mean(torch.square(values - vs.detach()))
        entropy = -torch.mean(
            torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
        total = (pg_loss + cfg.vf_loss_coeff * vf_loss
                 - cfg.entropy_coeff * entropy)
        return total, {"pg_loss": pg_loss, "vf_loss": vf_loss,
                       "entropy": entropy}

    return loss_fn


def _make_grad_apply(cfg: ImpalaConfig, optimizer: torch.optim.Optimizer):
    """(grad_fn, apply_fn): ``grad_fn(params, batch) -> (grads, metrics)``
    with the global-norm clip, ``apply_fn(params, grads)`` one optimizer
    step in place.  A learner group all-reduces between the two; the
    local path composes them."""
    loss_fn = _make_loss_fn(cfg)

    def grad_fn(params, batch):
        total, metrics = loss_fn(params, batch)
        grads = grads_of(total, params)
        if cfg.grad_clip:
            grads = clip_by_global_norm(grads, cfg.grad_clip)
        return grads, {k: v.detach() for k, v in metrics.items()}

    def apply_fn(params, grads):
        apply_gradients(optimizer, params, grads)

    return grad_fn, apply_fn


def _init_params_and_opt(cfg: ImpalaConfig, obs_shape, num_actions,
                         device="cuda"):
    """The parameters (from a generator seeded with ``cfg.seed``, on
    ``device``) and their optimizer, optax's RMSprop(lr, decay=0.99,
    eps=0.1): one construction for the local learner and every
    replica."""
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    if cfg.cnn:
        params = init_cnn_policy(gen, obs_shape, num_actions, device=device)
    else:
        params = init_mlp_policy(gen, int(np.prod(obs_shape)), num_actions,
                                 cfg.hidden, device=device)
    return params, make_optimizer(cfg, params)


def make_optimizer(cfg: ImpalaConfig, params) -> RMSprop:
    """``optax.rmsprop(cfg.lr, decay=0.99, eps=0.1)`` over ``params``."""
    return RMSprop(tree_leaves(params), cfg.lr, decay=0.99, eps=0.1)


def _make_update_fn(cfg: ImpalaConfig, optimizer: torch.optim.Optimizer):
    """``update(params, batch) -> metrics``: one V-trace step in place."""
    grad_fn, apply_fn = _make_grad_apply(cfg, optimizer)

    def update(params, batch):
        grads, metrics = grad_fn(params, batch)
        apply_fn(params, grads)
        return metrics

    return update
