"""SAC's learner — counterpart of ``ray_tpu/rllib/sac.py``.

Twin Q critics, a tanh-squashed Gaussian actor and an automatic entropy
temperature: the nets (``_mlp_init``, ``_mlp_apply``, ``init_sac_nets``),
``actor_dist``, ``sample_squashed``, ``sac_action_fn``, and ``sac_update``,
the update JAX defines inside ``SAC.build_learner`` (``sac.py:173-234``).
Its two normal draws (the next action's for the critic target, the
action's for the actor loss) are the caller's, drawn with
``sac_noise`` from a generator or given.  ``SACConfig.build()`` raises:
the ``SAC`` Algorithm needs the runtime (ROADMAP.md §A7).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.algorithm import AlgorithmConfig
from ray_tpu_torch.rllib.models import _normal, _zeros
from ray_tpu_torch.rllib.optim import apply_gradients, grads_of, tree_map
from ray_tpu_torch.rllib.sample_batch import (ACTIONS, DONES, NEXT_OBS, OBS,
                                              REWARDS)

__all__ = ["SACConfig", "init_sac_nets", "sac_action_fn", "sac_noise",
           "sac_update", "sample_squashed"]

_LOG_STD_MIN, _LOG_STD_MAX = -20.0, 2.0


def _mlp_init(generator: torch.Generator, sizes, out_dim, out_scale=0.01,
              device="cuda") -> Dict[str, Any]:
    """tanh MLP: He-scaled normal hidden weights, normal output weights of
    std ``out_scale``, zero biases; leaves require grad."""
    dims = list(sizes)
    params = {}
    for i in range(len(dims) - 1):
        params[f"fc_{i}"] = {
            "w": _normal(generator, (dims[i], dims[i + 1]),
                         math.sqrt(2.0 / dims[i]), device),
            "b": _zeros(dims[i + 1], device)}
    params["out"] = {"w": _normal(generator, (dims[-1], out_dim), out_scale,
                                  device),
                     "b": _zeros(out_dim, device)}
    return params


def _mlp_apply(params, x):
    i = 0
    while f"fc_{i}" in params:
        p = params[f"fc_{i}"]
        x = torch.tanh(x @ p["w"] + p["b"])
        i += 1
    return x @ params["out"]["w"] + params["out"]["b"]


def init_sac_nets(generator: torch.Generator, obs_dim: int, act_dim: int,
                  hidden=(256, 256), device="cuda") -> Dict[str, Any]:
    sizes = [obs_dim, *hidden]
    qsizes = [obs_dim + act_dim, *hidden]
    return {
        "actor": _mlp_init(generator, sizes, 2 * act_dim, device=device),
        "q1": _mlp_init(generator, qsizes, 1, out_scale=1.0, device=device),
        "q2": _mlp_init(generator, qsizes, 1, out_scale=1.0, device=device),
    }


def actor_dist(actor_params, obs):
    """-> (mean, log_std) of the pre-squash Gaussian."""
    out = _mlp_apply(actor_params, obs.reshape(obs.shape[0], -1))
    mean, log_std = torch.chunk(out, 2, dim=-1)
    return mean, torch.clamp(log_std, _LOG_STD_MIN, _LOG_STD_MAX)


def sample_squashed(actor_params, obs,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None):
    """Reparameterized tanh-Gaussian sample -> (action in [-1, 1], logp);
    the standard normal draw comes from ``generator`` or is given as
    ``noise`` (B, act_dim)."""
    mean, log_std = actor_dist(actor_params, obs)
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator,
                            device=generator.device)
    std = torch.exp(log_std)
    z = mean + std * noise.to(mean.device)
    a = torch.tanh(z)
    # logp with tanh change-of-variables (numerically stable form)
    logp_z = -0.5 * (((z - mean) / std) ** 2 + 2 * log_std
                     + math.log(2 * math.pi))
    correction = 2.0 * (math.log(2.0) - z - F.softplus(-2.0 * z))
    logp = torch.sum(logp_z - correction, dim=-1)
    return a, logp


@torch.no_grad()
def sac_action_fn(weights, obs, generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None):
    """EnvRunner action seam: tanh-Gaussian sample scaled to the env's
    action range (low/high ride the weights payload) -> (action, logp,
    zeros)."""
    a, logp = sample_squashed(weights["params"]["actor"],
                              obs.to(torch.float32), generator, noise)
    low = torch.as_tensor(weights["act_low"], device=a.device)
    high = torch.as_tensor(weights["act_high"], device=a.device)
    action = low + (a + 1.0) * 0.5 * (high - low)
    return action, logp, torch.zeros(a.shape[0], device=a.device)


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.alpha_lr = 3e-4
        self.buffer_size = 100_000
        self.train_batch_size = 256
        self.learning_starts = 512
        self.num_updates_per_iter = 64
        self.tau = 0.005                 # polyak target coefficient
        self.target_entropy = None       # default: -act_dim
        self.hidden = (256, 256)


def sac_noise(batch_size: int, act_dim: int, generator: torch.Generator):
    """The update's two standard normal draws, (B, act_dim) each: the next
    action's (critic target), then the action's (actor loss)."""
    return tuple(torch.randn((batch_size, act_dim), generator=generator,
                             device=generator.device) for _ in range(2))


def _q_apply(qp, obs, act):
    x = torch.cat([obs.reshape(obs.shape[0], -1), act], -1)
    return _mlp_apply(qp, x)[..., 0]


def sac_update(cfg: SACConfig, params, target_params, log_alpha,
               optimizer: torch.optim.Optimizer,
               alpha_optimizer: torch.optim.Optimizer, batch, noise,
               act_low, act_high):
    """One SAC step in place: ``params`` ({actor, q1, q2}) through
    ``optimizer`` (one Adam over ``tree_leaves(params)``), the 0-d
    ``log_alpha`` through ``alpha_optimizer``, then the polyak
    ``target_params`` ({q1, q2}).  ``noise`` = ``sac_noise``'s pair;
    ``act_low``/``act_high`` the env's action range.  The critic's
    gradients update q1 and q2, the actor's the actor; the temperature
    loss takes the actor's logp under the parameters before the step, the
    target the alpha before it.  Returns {critic_loss, actor_loss,
    alpha}."""
    act_dim = act_low.shape[-1]
    target_entropy = (cfg.target_entropy if cfg.target_entropy is not None
                      else -act_dim)
    obs = batch[OBS].to(torch.float32)
    nobs = batch[NEXT_OBS].to(torch.float32)
    # env-scale actions -> [-1, 1] (the squashed policy's range)
    act = (batch[ACTIONS] - act_low) / (act_high - act_low) * 2.0 - 1.0
    alpha = torch.exp(log_alpha.detach())

    # ---- critic target
    with torch.no_grad():
        na, nlogp = sample_squashed(params["actor"], nobs, noise=noise[0])
        qt = torch.minimum(_q_apply(target_params["q1"], nobs, na),
                           _q_apply(target_params["q2"], nobs, na))
        target = batch[REWARDS] + cfg.gamma * (1.0 - batch[DONES]) * (
            qt - alpha * nlogp)

    critics = {"q1": params["q1"], "q2": params["q2"]}
    c_loss = (torch.mean((_q_apply(params["q1"], obs, act) - target) ** 2)
              + torch.mean((_q_apply(params["q2"], obs, act) - target) ** 2))
    a, logp = sample_squashed(params["actor"], obs, noise=noise[1])
    q = torch.minimum(_q_apply(params["q1"], obs, a),
                      _q_apply(params["q2"], obs, a))
    a_loss = torch.mean(alpha * logp - q)
    # critic grads update q nets; actor grads update the actor only
    grads = {"actor": grads_of(a_loss, params["actor"]),
             **grads_of(c_loss, critics)}
    apply_gradients(optimizer, params, grads)

    # ---- temperature
    al_loss = -torch.mean(torch.exp(log_alpha) * (logp + target_entropy)
                          .detach())
    apply_gradients(alpha_optimizer, log_alpha, grads_of(al_loss, log_alpha))

    # ---- polyak targets
    with torch.no_grad():
        tree_map(lambda t, o: t.copy_((1.0 - cfg.tau) * t + cfg.tau * o),
                 target_params, critics)
    return {"critic_loss": c_loss.detach(), "actor_loss": a_loss.detach(),
            "alpha": alpha}
