"""BC's learner — counterpart of ``ray_tpu/rllib/bc.py``.

``bc_update`` is the update JAX defines inside ``BC.build_learner``
(``bc.py:71-83``): the mean negative log-likelihood of the dataset's
actions under the policy, one Adam step.  ``BC`` is the Algorithm around
it (``bc.py:40-109``): minibatches drawn from
``np.random.default_rng(seed)`` as the reference draws them, and runners
that only evaluate the cloned policy.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.models import (init_mlp_policy, load_params,
                                        params_to_numpy, policy_forward)
from ray_tpu_torch.rllib.optim import adam, apply_gradients, grads_of
from ray_tpu_torch.rllib.sample_batch import ACTIONS, OBS

__all__ = ["BCConfig", "BC", "bc_update"]


class BCConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.train_batch_size = 256
        self.num_updates_per_iter = 64
        self.hidden = (64, 64)
        self.dataset = None  # ray_tpu_torch.data.Dataset | {"obs":..., "actions":...}

    def offline_data(self, dataset) -> "BCConfig":
        self.dataset = dataset
        return self

    def build(self) -> "BC":
        return BC(self)


def bc_update(params, optimizer: torch.optim.Optimizer, obs, actions):
    """One step of cross-entropy on (obs, actions); ``params`` change in
    place through ``optimizer`` (Adam over ``tree_leaves(params)``).
    Returns the loss before the step."""
    logits, _ = policy_forward(params, obs)
    logp = torch.log_softmax(logits, dim=-1)
    loss = torch.mean(-logp.gather(-1, actions.long()[:, None])[:, 0])
    apply_gradients(optimizer, params, grads_of(loss, params))
    return loss.detach()


class BC(Algorithm):
    _config_cls = BCConfig

    def build_learner(self):
        cfg = self.algo_config
        assert cfg.dataset is not None, "config.offline_data(...) missing"
        if hasattr(cfg.dataset, "take_all"):  # ray_tpu_torch.data.Dataset
            rows = cfg.dataset.take_all()
            obs = np.stack([r[OBS] for r in rows]).astype(np.float32)
            acts = np.asarray([r[ACTIONS] for r in rows], np.int64)
        else:
            obs = np.asarray(cfg.dataset[OBS], np.float32)
            acts = np.asarray(cfg.dataset[ACTIONS], np.int64)
        device = self.learner_device()
        self._obs = torch.from_numpy(obs).to(device)
        self._acts = torch.from_numpy(acts).to(device)

        env = cfg.env_creator()
        obs_dim = int(np.prod(env.observation_space.shape))
        num_actions = int(env.action_space.n)
        env.close()
        self.params = init_mlp_policy(
            torch.Generator(device=device).manual_seed(cfg.seed), obs_dim,
            num_actions, cfg.hidden, device=device)
        self._opt = adam(self.params, cfg.lr)
        self._rng = np.random.default_rng(cfg.seed)

    def get_weights(self):
        return params_to_numpy(self.params)

    def set_weights(self, weights):
        load_params(self.params, weights)
        # a fresh optimizer state, as the reference's ``_opt.init``
        self._opt = adam(self.params, self.algo_config.lr)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        losses = []
        n = len(self._obs)
        for _ in range(cfg.num_updates_per_iter):
            idx = torch.from_numpy(self._rng.integers(
                0, n, size=cfg.train_batch_size)).to(self._obs.device)
            loss = bc_update(self.params, self._opt, self._obs[idx],
                             self._acts[idx])
            losses.append(float(loss))
        # evaluation rollouts with the cloned policy (offline learning,
        # online EVALUATION — like the reference's evaluation workers)
        self.sync_weights()
        self.synchronous_parallel_sample()
        return {"loss": float(np.mean(losses)),
                "_steps_this_iter": 0}
