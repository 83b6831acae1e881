"""IMPALA's learner — counterpart of ``ray_tpu/rllib/impala.py``.

V-trace (Espeholt et al. 2018) as a loop over T in reverse where JAX
runs a reverse ``lax.scan``; the loss with V-trace's inputs detached
exactly where JAX calls ``stop_gradient`` (the target logps and values
going in, ``pg_adv`` and ``vs`` coming out); the gradient and its
application kept apart (``_make_grad_apply``), since a learner group
all-reduces between the two.  The optimizer is optax's RMSprop at
eps = 0.1 (``optim.RMSprop``).  ``Impala`` is the Algorithm around it
(``impala.py:182-290``): the runners sample continuously, and each
training step consumes whatever rollouts are ready, one V-trace update
each, on the learner or across a ``LearnerGroup``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import (Algorithm, AlgorithmConfig,
                                           to_learner)
from ray_tpu_torch.rllib.models import (init_cnn_policy, init_mlp_policy,
                                        load_params, params_to_numpy,
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
        # >1: data-parallel learner replicas (LearnerGroup) — each update's
        # batch shards across them and gradients allreduce-average
        # (reference: `rllib/core/learner/learner_group.py:61`)
        self.num_learners = 1

    def build(self) -> "Impala":
        return Impala(self)


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


def time_major(ro: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A runner's rollout as the update's time-major (T, B, ...) arrays
    (``impala.py:252-260``)."""
    b = ro["batch"]
    T, B = ro["t_shape"]
    return {
        OBS: b[OBS].reshape((T, B) + b[OBS].shape[1:]),
        ACTIONS: b[ACTIONS].reshape(T, B),
        LOGPS: b[LOGPS].reshape(T, B),
        REWARDS: b[REWARDS].reshape(T, B).astype(np.float32),
        DONES: b[DONES].reshape(T, B).astype(np.float32),
        "bootstrap": ro["last_values"].astype(np.float32),
    }


class Impala(Algorithm):
    _config_cls = ImpalaConfig

    def build_learner(self):
        cfg: ImpalaConfig = self.algo_config
        probe_env = cfg.env_creator()
        num_actions = int(probe_env.action_space.n)
        obs_shape = probe_env.observation_space.shape
        probe_env.close()
        self._learner_group = None
        if cfg.num_learners > 1:
            from ray_tpu_torch.rllib.learner_group import LearnerGroup

            # the replicas run the SAME init (same seed/optimizer) on the
            # CPU, as the reference's replicas run with JAX on the CPU
            def factory(cfg=cfg, obs_shape=obs_shape,
                        num_actions=num_actions):
                params, opt = _init_params_and_opt(
                    cfg, obs_shape, num_actions, device="cpu")
                grad_fn, apply_fn = _make_grad_apply(cfg, opt)
                return {"params": params, "grad_fn": grad_fn,
                        "apply_fn": apply_fn}

            self._learner_group = LearnerGroup(factory, cfg.num_learners)
        else:
            self._params, self._optimizer = _init_params_and_opt(
                cfg, obs_shape, num_actions, device=self.learner_device())
            self._update = _make_update_fn(cfg, self._optimizer)
        self._inflight: Dict[Any, Any] = {}  # ref -> runner

    def get_weights(self):
        if self._learner_group is not None:
            return self._learner_group.get_weights()
        return params_to_numpy(self._params)

    def set_weights(self, weights):
        if self._learner_group is not None:
            # checkpoint restore must reach the replicas
            self._learner_group.set_weights(weights)
        else:
            load_params(self._params, weights)

    def _ensure_sampling(self):
        """Keep every runner busy (the async pipeline of the reference's
        rollout queue)."""
        busy = set(self._inflight.values())
        for r in self.env_runners:
            if r not in busy:
                self._inflight[r.sample.remote()] = r

    def training_step(self) -> Dict[str, Any]:
        import ray_tpu_torch

        self._ensure_sampling()
        # consume whatever is ready (at least one)
        refs = list(self._inflight.keys())
        ready, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=120)
        # opportunistically grab more finished rollouts
        more, _ = ray_tpu_torch.wait(
            [r for r in refs if r not in ready],
            num_returns=max(1, len(refs) - 1), timeout=0) \
            if len(refs) > 1 else ([], None)
        metrics = {}
        steps = 0
        for ref in list(ready) + list(more):
            runner = self._inflight.pop(ref)
            ro = ray_tpu_torch.get(ref)
            self._total_env_steps += ro["metrics"]["env_steps"]
            self._episode_returns.extend(
                ep[0] for ep in ro["metrics"]["episodes"])
            tm = time_major(ro)
            if self._learner_group is not None:
                # time-major arrays shard on the env axis (1); bootstrap
                # values are (B,) and shard on 0
                m = self._learner_group.update(
                    tm, axis_map={OBS: 1, ACTIONS: 1, LOGPS: 1,
                                  REWARDS: 1, DONES: 1, "bootstrap": 0})
            else:
                m = self._update(self._params,
                                 to_learner(tm, self.learner_device()))
            metrics = {k: float(v) for k, v in m.items()}
            steps += int(np.prod(ro["t_shape"]))
            # restart sampling on the freed runner with FRESH weights
            runner.set_weights.remote(self.get_weights())
            self._inflight[runner.sample.remote()] = runner
        metrics["_steps_this_iter"] = steps
        metrics["num_inflight"] = len(self._inflight)
        return metrics

    def cleanup(self):
        if self._learner_group is not None:
            self._learner_group.shutdown()
        super().cleanup()

    def synchronous_parallel_sample(self):  # not used by IMPALA
        raise NotImplementedError
