"""EnvRunner — an actor that rolls out a policy in vectorized CPU envs.

Reference analogues: `rllib/evaluation/rollout_worker.py:660`
(``RolloutWorker.sample`` — the env-step hot loop),
`rllib/env/env_runner.py:9` (the EnvRunner base).

The runner owns B gymnasium envs (SyncVectorEnv) and the current policy
weights; ``sample()`` steps T*B transitions with a jitted forward and
returns a SampleBatch (numpy — travels the object plane to the learner).

Counterpart of ``ray_tpu/rllib/env_runner.py``: the jitted
``sample_action`` and its PRNG key become the port's ``sample_action`` on
the CPU with a ``torch.Generator`` seeded from ``seed``.  Weights arrive
as the learner's host tree (``params_to_numpy``'s form, the JAX
package's) and are turned into CPU tensors once, in ``set_weights``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS,
    DONES,
    LOGPS,
    NEXT_OBS,
    OBS,
    REWARDS,
    VALUES,
    SampleBatch,
)


class EnvRunner:
    def __init__(self, env_creator, num_envs: int, rollout_length: int,
                 policy_init, seed: int = 0,
                 action_fn=None, store_next_obs: bool = False):
        """env_creator() -> gymnasium.Env; policy_init(rng, obs_dim,
        num_actions) -> params (only used for shape checks on the runner —
        weights always come from the learner via set_weights).

        ``action_fn(weights, obs, generator) -> (action, logp, value)``
        replaces
        the default categorical-policy sampler (e.g. DQN's epsilon-greedy;
        ``weights`` is whatever the learner ships via set_weights, so
        schedules like epsilon can ride along).  ``store_next_obs`` adds
        NEXT_OBS to the batch (off-policy learners need (s, a, r, s')
        transitions; on-policy GAE does not)."""
        import gymnasium as gym

        from ray_tpu_torch.rllib.models import sample_action

        if action_fn is not None:
            sample_action = action_fn
        self._store_next_obs = store_next_obs

        # SAME_STEP autoreset (classic semantics): a terminated env returns
        # the reset obs in the same step() call.  gymnasium >= 1.0 defaults
        # to NEXT_STEP, where the step after termination IGNORES the action
        # and yields reward 0 — recording that as a transition injects
        # garbage gradients (~1/ep_len of the batch).
        try:
            self._envs = gym.vector.SyncVectorEnv(
                [env_creator for _ in range(num_envs)],
                autoreset_mode=gym.vector.AutoresetMode.SAME_STEP)
        except TypeError:
            # No autoreset_mode kwarg.  Pre-1.0 gymnasium defaults to
            # SAME_STEP so the fallback is safe there; 1.0.x defaults to
            # NEXT_STEP but lacks the kwarg (AutoresetMode landed in 1.1),
            # so silently proceeding would record post-termination garbage.
            major, minor = (int(x) for x in gym.__version__.split(".")[:2])
            if (major, minor) >= (1, 0):
                raise RuntimeError(
                    f"gymnasium {gym.__version__} defaults to NEXT_STEP "
                    "autoreset but does not support requesting SAME_STEP "
                    "(added in 1.1) — upgrade gymnasium to >= 1.1"
                ) from None
            self._envs = gym.vector.SyncVectorEnv(
                [env_creator for _ in range(num_envs)])
        self._num_envs = num_envs
        self._T = rollout_length
        self._params = None
        self._generator = torch.Generator().manual_seed(seed)
        self._sample_action = sample_action
        obs, _ = self._envs.reset(seed=seed)
        # keep the env's native dtype: uint8 pixels stay uint8 (the CNN
        # normalizes /255 itself); float envs stay float32
        self._obs = np.asarray(obs)
        if self._obs.dtype != np.uint8:
            self._obs = self._obs.astype(np.float32)
        # per-env running episode returns (for episode_reward metrics)
        self._ep_return = np.zeros(num_envs, np.float64)
        self._ep_len = np.zeros(num_envs, np.int64)
        self._completed: list = []

    def set_weights(self, params):
        from ray_tpu_torch.rllib.models import params_from_numpy

        self._params = params_from_numpy(params, device="cpu")
        return True

    def sample(self) -> Dict[str, Any]:
        """Roll out T steps in all envs; returns {'batch': SampleBatch,
        'metrics': {...}} — the batch carries VALUES and NEXT_OBS so the
        learner can bootstrap GAE."""
        assert self._params is not None, "set_weights before sample"
        T, B = self._T, self._num_envs
        obs_buf = np.empty((T, B) + self._obs.shape[1:], self._obs.dtype)
        act_buf = None  # allocated from the first action (shape/dtype vary:
        # int64 (B,) for discrete policies, float32 (B, act_dim) for
        # continuous ones like SAC's tanh-Gaussian)
        logp_buf = np.empty((T, B), np.float32)
        val_buf = np.empty((T, B), np.float32)
        rew_buf = np.empty((T, B), np.float32)
        done_buf = np.empty((T, B), np.float32)
        next_obs_buf = (np.empty_like(obs_buf)
                        if self._store_next_obs else None)

        for t in range(T):
            action, logp, value = self._sample_action(
                self._params, torch.from_numpy(self._obs), self._generator)
            action = action.numpy()
            next_obs, reward, terminated, truncated, _ = self._envs.step(
                action)
            obs_buf[t] = self._obs
            if act_buf is None:
                act_buf = np.empty((T,) + action.shape, action.dtype)
            act_buf[t] = action
            logp_buf[t] = logp.numpy()
            val_buf[t] = value.numpy()
            rew_buf[t] = reward
            # GAE cuts only at TERMINATION; truncation (time limit) still
            # bootstraps — but SyncVectorEnv auto-resets, so the stored
            # next_obs after either is the reset obs and we conservatively
            # cut on both (standard for CartPole-scale tasks).
            done = np.logical_or(terminated, truncated)
            done_buf[t] = done.astype(np.float32)
            self._ep_return += reward
            self._ep_len += 1
            for i in np.nonzero(done)[0]:
                self._completed.append(
                    (float(self._ep_return[i]), int(self._ep_len[i])))
                self._ep_return[i] = 0.0
                self._ep_len[i] = 0
            if next_obs_buf is not None:
                # SAME_STEP autoreset returns the reset obs after a done;
                # that's fine for the Q target — done=1 masks the bootstrap.
                next_obs_buf[t] = np.asarray(next_obs).astype(
                    next_obs_buf.dtype)
            self._obs = np.asarray(next_obs)
            if self._obs.dtype != np.uint8:
                self._obs = self._obs.astype(np.float32)

        # bootstrap value for the final observation of each env
        _, _, last_value = self._sample_action(
            self._params, torch.from_numpy(self._obs), self._generator)

        batch = SampleBatch({
            # keep the native obs shape (CNN policies need (H, W, C));
            # MLP forward flattens for itself
            OBS: obs_buf.reshape((T * B,) + obs_buf.shape[2:]),
            ACTIONS: act_buf.reshape((T * B,) + act_buf.shape[2:]),
            LOGPS: logp_buf.reshape(T * B),
            VALUES: val_buf.reshape(T * B),
            REWARDS: rew_buf.reshape(T * B),
            DONES: done_buf.reshape(T * B),
        })
        if next_obs_buf is not None:
            batch[NEXT_OBS] = next_obs_buf.reshape(
                (T * B,) + next_obs_buf.shape[2:])
        completed, self._completed = self._completed, []
        return {
            "batch": batch,
            # time-major shape + bootstrap values for learner-side GAE
            "t_shape": (T, B),
            "last_values": last_value.numpy().astype(np.float32),
            "metrics": {
                "episodes": completed,
                "env_steps": T * B,
            },
        }
