"""RLlib on the port's runtime: the runtime cases of ``tests/test_rllib.py``
and ``tests/test_dqn.py`` with the learner on the CPU
(``learner_device="cpu"``), on this host's ``gymnasium``, on one port
runtime for the module (8 CPUs, under a session root of its own), ending
with the port's leak audit.

Each reference case keeps its marks (``slow``, ``flaky``).  ``test_dqn.py``'s
replay-buffer cases run on the port's copy of ``replay_buffers.py``.  The
port's own cases: every config's ``build()`` gives its ``Algorithm``, which
trains one iteration and reports the reference's result keys; a
``LearnerGroup`` of 2 learners (one flat f32 all-reduce of the gradients
through the host group) against one learner on the concatenated batch;
SAC's checkpoint (the optimizers' states included) restored into another
SAC; the learner refusing a missing card.
"""

import os
import shutil

import gymnasium
import numpy as np
import pytest
import torch
from test_torch_runtime_parity import assert_port_left_nothing

import ray_tpu_torch
from ray_tpu_torch import rllib
from ray_tpu_torch.rllib.replay_buffers import (PrioritizedReplayBuffer,
                                                ReplayBuffer, _SumTree)

# a LearnerGroup of 2 against one learner on the whole batch: the mean of
# the two shards' gradients is the whole batch's, summed in another order
# (f32); after 3 RMSprop steps the weights agree to
LEARNER_GROUP_RTOL, LEARNER_GROUP_ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def ray():
    """One port runtime for the module, under a session root of its own."""
    from ray_tpu_torch.session_root import new_session_root

    config = ray_tpu_torch.config
    default, config.temp_dir = config.temp_dir, new_session_root()
    try:
        ray_tpu_torch.init(num_cpus=8)
        yield ray_tpu_torch
        ray_tpu_torch.shutdown()
        assert_port_left_nothing([os.getpid()])
    finally:
        shutil.rmtree(config.temp_dir, ignore_errors=True)
        config.temp_dir = default


def _cartpole():
    return gymnasium.make("CartPole-v1")


def _pendulum():
    return gymnasium.make("Pendulum-v1")


# --------------------------------------------------------------- sum tree
# (tests/test_dqn.py's, on the port's copy)


def test_sum_tree_prefix_lookup():
    t = _SumTree(8)
    t.set(np.arange(8), np.array([1.0, 2, 3, 4, 0, 0, 0, 0]))
    assert t.total() == 10.0
    # prefix 0.5 -> leaf 0 (range (0,1]); 1.5 -> leaf 1 (1,3]; 9.9 -> leaf 3
    idx = t.prefix_index(np.array([0.5, 1.5, 3.5, 9.9]))
    np.testing.assert_array_equal(idx, [0, 1, 2, 3])


def test_sum_tree_update_propagates():
    t = _SumTree(4)
    t.set(np.array([0, 1, 2, 3]), np.array([1.0, 1, 1, 1]))
    t.set(np.array([2]), np.array([5.0]))
    assert t.total() == 8.0
    assert t.prefix_index(np.array([2.5]))[0] == 2


def test_replay_buffer_ring_and_sample():
    buf = ReplayBuffer(capacity=10, seed=0)
    buf.add({"x": np.arange(6), "y": np.arange(6) * 10.0})
    assert len(buf) == 6
    buf.add({"x": np.arange(6, 14), "y": np.arange(6, 14) * 10.0})
    assert len(buf) == 10  # wrapped
    s = buf.sample(32)
    assert s["x"].shape == (32,)
    # ring overwrote the oldest entries
    assert s["x"].min() >= 4
    np.testing.assert_array_equal(s["y"], s["x"] * 10.0)


def test_prioritized_buffer_prefers_high_priority():
    buf = PrioritizedReplayBuffer(capacity=64, alpha=1.0, seed=0)
    buf.add({"x": np.arange(64)})
    # make item 7 dominate
    buf.update_priorities(np.array([7]), np.array([1000.0]))
    s = buf.sample(256)
    frac = np.mean(s["x"] == 7)
    assert frac > 0.5
    # importance weights compensate: dominant item gets the SMALLEST weight
    w7 = s["weights"][s["x"] == 7]
    assert w7.max() <= s["weights"].max()
    assert np.isclose(s["weights"].max(), 1.0)


def test_prioritized_buffer_uniform_when_equal():
    buf = PrioritizedReplayBuffer(capacity=32, alpha=0.6, seed=1)
    buf.add({"x": np.arange(32)})
    s = buf.sample(512)
    counts = np.bincount(s["x"], minlength=32)
    assert counts.min() > 0  # everything gets sampled
    np.testing.assert_allclose(s["weights"], 1.0, atol=1e-5)


# ------------------------------------------------------------------- PPO
# (tests/test_rllib.py's)


@pytest.mark.slow
def test_ppo_single_iteration_shapes(ray):
    config = (rllib.PPOConfig()
              .environment(_cartpole)
              .env_runners(num_env_runners=2, num_envs_per_runner=2,
                           rollout_length=32)
              .training(learner_device="cpu")
              .debugging(seed=0))
    algo = config.build()
    result = algo.train()
    assert result["num_env_steps_sampled"] == 2 * 2 * 32
    assert "policy_loss" in result and "vf_loss" in result
    assert np.isfinite(result["policy_loss"])
    assert result["env_steps_per_sec"] > 0
    result2 = algo.train()
    assert result2["num_env_steps_sampled"] == 2 * 2 * 32 * 2
    assert result2["training_iteration"] == 2
    algo.stop()


@pytest.mark.slow
def test_ppo_checkpoint_roundtrip(ray):
    config = (rllib.PPOConfig()
              .environment(_cartpole)
              .env_runners(num_env_runners=1, num_envs_per_runner=2,
                           rollout_length=16)
              .training(learner_device="cpu"))
    algo = config.build()
    algo.train()
    ckpt = algo.save_checkpoint()
    assert "weights" in ckpt

    algo2 = (rllib.PPOConfig()
             .environment(_cartpole)
             .env_runners(num_env_runners=1, num_envs_per_runner=2,
                          rollout_length=16)
             .training(learner_device="cpu")).build()
    algo2.load_checkpoint(ckpt)
    w1 = algo.get_weights()
    w2 = algo2.get_weights()
    np.testing.assert_array_equal(w1["pi"]["w"], w2["pi"]["w"])
    algo.stop()
    algo2.stop()


@pytest.mark.slow
def test_ppo_learns_cartpole(ray):
    """CartPole-v1 to >=450 mean reward, as the reference's north-star
    learning test."""
    config = (rllib.PPOConfig()
              .environment(_cartpole)
              .env_runners(num_env_runners=4, num_envs_per_runner=8,
                           rollout_length=128)
              .training(lr=1e-3, num_epochs=10, minibatch_size=256,
                        entropy_coeff=0.0, gamma=0.99, learner_device="cpu")
              .debugging(seed=3))
    algo = config.build()
    best = -np.inf
    reached = False
    for i in range(80):
        result = algo.train()
        mean = result["episode_reward_mean"]
        if np.isfinite(mean):
            best = max(best, mean)
        if best >= 450:
            reached = True
            break
    algo.stop()
    assert reached, f"PPO did not reach 450 on CartPole (best={best:.1f})"


# ---------------------------------------------------------------- IMPALA


@pytest.mark.slow
@pytest.mark.flaky
def test_impala_learns_cartpole(ray):
    """As the reference's (slow and flaky there too): IMPALA consumes
    whichever rollouts are ready, so the update order depends on the
    actors' timing."""
    config = (rllib.ImpalaConfig()
              .environment(_cartpole)
              .env_runners(num_env_runners=2, num_envs_per_runner=4,
                           rollout_length=128)
              .training(lr=5e-3, entropy_coeff=0.005, learner_device="cpu")
              .debugging(seed=7))
    algo = config.build()
    best = -np.inf
    for i in range(80):
        result = algo.train()
        if np.isfinite(result["episode_reward_mean"]):
            best = max(best, result["episode_reward_mean"])
        if best >= 100.0:
            break
    algo.stop()
    assert best >= 100.0, f"IMPALA failed to learn: best={best}"
    assert result["env_steps_per_sec"] > 0


@pytest.mark.slow
@pytest.mark.flaky
def test_impala_learner_group_fanout(ray):
    """IMPALA with 2 data-parallel learner replicas: updates run, the
    replicas stay in lockstep and learning still happens."""
    config = (rllib.ImpalaConfig()
              .environment(_cartpole)
              .env_runners(num_env_runners=2, num_envs_per_runner=4,
                           rollout_length=128)
              .training(lr=5e-3, entropy_coeff=0.005, num_learners=2,
                        learner_device="cpu")
              .debugging(seed=7))
    algo = config.build()
    try:
        best = -float("inf")
        for _ in range(50):
            r = algo.train()
            assert np.isfinite(r.get("pg_loss", 0.0))
            if np.isfinite(r["episode_reward_mean"]):
                best = max(best, r["episode_reward_mean"])
            if best >= 120:
                break
        # replicas in lockstep after many updates
        w0, w1 = algo._learner_group.get_all_weights()
        for a, b in zip(_leaves(w0), _leaves(w1)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        assert best >= 100, f"learner-group IMPALA not learning: best={best}"
    finally:
        algo.stop()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _impala_factory(cfg):
    from ray_tpu_torch.rllib.impala import _init_params_and_opt, \
        _make_grad_apply

    params, opt = _init_params_and_opt(cfg, (4,), 2, device="cpu")
    grad_fn, apply_fn = _make_grad_apply(cfg, opt)
    return {"params": params, "grad_fn": grad_fn, "apply_fn": apply_fn}


def test_learner_group_allreduce_matches_one_learner(ray):
    """Two ``LearnerWorker`` replicas, each on its half of the envs, their
    gradients averaged by one flat f32 all-reduce through the host group,
    against one learner on the whole (T, B) batch: after 3 RMSprop steps
    the replicas are bit-equal to each other and within
    ``LEARNER_GROUP_RTOL``/``ATOL`` of the one learner (the clip at 40 is
    not reached)."""
    import functools

    from ray_tpu_torch.rllib.algorithm import to_learner
    from ray_tpu_torch.rllib.impala import (_init_params_and_opt,
                                            _make_update_fn)
    from ray_tpu_torch.rllib.models import params_to_numpy

    cfg = rllib.ImpalaConfig()
    cfg.hidden, cfg.lr = (16, 16), 1e-2
    group = rllib.LearnerGroup(functools.partial(_impala_factory, cfg), 2)
    params, opt = _init_params_and_opt(cfg, (4,), 2, device="cpu")
    update = _make_update_fn(cfg, opt)
    rng = np.random.default_rng(0)
    T, B = 8, 6
    try:
        for _ in range(3):
            logits = rng.standard_normal((T, B, 2))
            acts = rng.integers(0, 2, (T, B))
            tm = {"obs": rng.standard_normal((T, B, 4)).astype(np.float32),
                  "actions": acts,
                  "logps": np.take_along_axis(
                      logits - np.log(np.exp(logits).sum(-1, keepdims=True)),
                      acts[..., None], -1)[..., 0].astype(np.float32),
                  "rewards": rng.standard_normal((T, B)).astype(np.float32),
                  "dones": (rng.random((T, B)) < 0.1).astype(np.float32),
                  "bootstrap": rng.standard_normal(B).astype(np.float32)}
            m = group.update(tm, axis_map={"obs": 1, "actions": 1,
                                           "logps": 1, "rewards": 1,
                                           "dones": 1, "bootstrap": 0})
            assert set(m) == {"pg_loss", "vf_loss", "entropy"}
            update(params, to_learner(tm, "cpu"))
        w0, w1 = group.get_all_weights()
    finally:
        group.shutdown()
    one = params_to_numpy(params)
    for a, b, c in zip(_leaves(w0), _leaves(w1), _leaves(one)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, c, rtol=LEARNER_GROUP_RTOL,
                                   atol=LEARNER_GROUP_ATOL)


# -------------------------------------------------------------------- BC


def test_bc_clones_expert_policy(ray):
    """Offline RL: BC learns CartPole from a synthetic expert dataset;
    evaluation rollouts run the cloned policy online."""
    # Synthetic expert: push in the direction the pole is falling —
    # a known good CartPole controller (~mean reward well above random).
    env = gymnasium.make("CartPole-v1")
    obs_buf, act_buf = [], []
    obs, _ = env.reset(seed=0)
    for _ in range(4000):
        action = int(obs[2] + 0.5 * obs[3] > 0)
        obs_buf.append(obs)
        act_buf.append(action)
        obs, _, term, trunc, _ = env.step(action)
        if term or trunc:
            obs, _ = env.reset()
    env.close()

    config = (rllib.BCConfig()
              .environment(lambda: gymnasium.make("CartPole-v1"))
              .env_runners(num_env_runners=1, num_envs_per_runner=4,
                           rollout_length=200)
              .offline_data({"obs": np.stack(obs_buf),
                             "actions": np.asarray(act_buf)})
              .training(lr=1e-3, num_updates_per_iter=200,
                        learner_device="cpu")
              .debugging(seed=0))
    algo = config.build()
    best = -np.inf
    for _ in range(6):
        r = algo.train()
        if np.isfinite(r["episode_reward_mean"]):
            best = max(best, r["episode_reward_mean"])
    algo.stop()
    assert best >= 150, f"BC clone underperformed (best={best:.1f})"


# ------------------------------------------------------------------- SAC


@pytest.mark.slow
def test_sac_learns_pendulum(ray):
    """SAC improves Pendulum substantially from the random baseline
    (~-1200 avg return) within a small env-step budget."""
    config = (rllib.SACConfig()
              .environment(_pendulum)
              .env_runners(num_env_runners=1, num_envs_per_runner=4,
                           rollout_length=64)
              .training(lr=3e-4, num_updates_per_iter=256,
                        train_batch_size=256, learning_starts=500,
                        hidden=(128, 128), learner_device="cpu")
              .debugging(seed=7))
    algo = config.build()
    try:
        best = -float("inf")
        for i in range(45):
            r = algo.train()
            if np.isfinite(r["episode_reward_mean"]):
                best = max(best, r["episode_reward_mean"])
            if best > -500:
                break
        assert best > -800, f"SAC failed to learn Pendulum: best={best}"
    finally:
        algo.stop()


def test_sac_checkpoint_roundtrip(ray):
    """SAC's checkpoint (the reference's keys: params, target params,
    log_alpha, both optimizers' states, env steps) restores into another
    SAC: the same weights, temperature and Adam moments, held on the
    host."""
    make = (lambda: rllib.SACConfig().environment(_pendulum)
            .env_runners(num_env_runners=1, num_envs_per_runner=2,
                         rollout_length=16)
            .training(learning_starts=16, train_batch_size=16,
                      num_updates_per_iter=2, hidden=(32, 32),
                      learner_device="cpu"))
    algo = make().build()
    algo.train()
    ckpt = algo.save_checkpoint()
    assert set(ckpt) == {"params", "target_params", "log_alpha", "opt_state",
                         "alpha_opt_state", "total_env_steps"}
    algo2 = make().debugging(seed=1).build()
    algo2.load_checkpoint(ckpt)
    try:
        for a, b in zip(_leaves(algo.save_checkpoint()["params"]),
                        _leaves(algo2.save_checkpoint()["params"])):
            np.testing.assert_array_equal(a, b)
        assert float(algo2.log_alpha) == float(algo.log_alpha)
        assert algo2._total_env_steps == algo._total_env_steps == 32
        s1, s2 = algo._opt.state_dict(), algo2._opt.state_dict()
        for k in s1["state"]:
            assert torch.equal(s1["state"][k]["exp_avg"],
                               s2["state"][k]["exp_avg"])
    finally:
        algo.stop()
        algo2.stop()


# ------------------------------------------------------------ multi-agent


class _SignalMatch:
    """2-agent cooperative env: both see a random bit and are rewarded
    for playing it back; ep_len 8, optimal per-agent return 8."""

    agents = ["a0", "a1"]

    def __init__(self, seed=0):
        self._rng = np.random.default_rng(seed)
        self._t = 0
        self._bit = 0

    def _obs(self):
        o = np.array([1.0 - self._bit, float(self._bit)], np.float32)
        return {a: o for a in self.agents}

    def reset(self):
        self._t = 0
        self._bit = int(self._rng.integers(0, 2))
        return self._obs(), {}

    def step(self, actions):
        rew = {a: float(actions[a] == self._bit) for a in self.agents}
        self._t += 1
        done = self._t >= 8
        self._bit = int(self._rng.integers(0, 2))
        terms = {a: done for a in self.agents}
        terms["__all__"] = done
        truncs = {a: False for a in self.agents}
        truncs["__all__"] = False
        return self._obs(), rew, terms, truncs, {}

    def close(self):
        pass


def _signal_match_ppo():
    config = (rllib.MultiAgentPPOConfig()
              .environment(lambda: _SignalMatch())
              .env_runners(num_env_runners=2, rollout_length=64)
              .training(lr=3e-3, num_epochs=4, minibatch_size=64,
                        entropy_coeff=0.003, hidden=(32, 32),
                        learner_device="cpu")
              .debugging(seed=3))
    return config.multi_agent(
        policies={"p0": (2, 2), "p1": (2, 2)},
        policy_mapping_fn=lambda aid: {"a0": "p0", "a1": "p1"}[aid])


@pytest.mark.slow
def test_multi_agent_ppo_learns(ray):
    """Per-policy batches through the multi-agent runner: two separate
    policies each learn to echo the observed bit."""
    algo = _signal_match_ppo().build()
    try:
        best = -float("inf")
        for _ in range(25):
            r = algo.train()
            if np.isfinite(r["episode_reward_mean"]):
                best = max(best, r["episode_reward_mean"])
            if best > 14.5:  # both agents near-perfect (16 = 2 agents x 8)
                break
        assert best > 12.0, f"multi-agent PPO failed to learn: best={best}"
    finally:
        algo.stop()


# ------------------------------------------------------------------- DQN
# (tests/test_dqn.py's)


@pytest.mark.slow
def test_dqn_smoke_and_checkpoint(ray):
    config = (rllib.DQNConfig()
              .environment(_cartpole)
              .env_runners(num_env_runners=1, num_envs_per_runner=2,
                           rollout_length=16)
              .training(learning_starts=32, train_batch_size=32,
                        num_updates_per_iter=2, learner_device="cpu")
              .debugging(seed=0))
    algo = config.build()
    r = algo.train()
    assert r["buffer_size"] == 32
    assert 0 <= r["epsilon"] <= 1.0
    ckpt = algo.save_checkpoint()
    algo2 = (rllib.DQNConfig().environment(_cartpole)
             .env_runners(num_env_runners=1, num_envs_per_runner=2,
                          rollout_length=16)
             .training(learner_device="cpu")).build()
    algo2.load_checkpoint(ckpt)
    w1, w2 = algo.params, algo2.params
    np.testing.assert_array_equal(w1["pi"]["w"].detach().numpy(),
                                  w2["pi"]["w"].detach().numpy())
    algo.stop()
    algo2.stop()


@pytest.mark.slow
def test_dqn_learns_cartpole(ray):
    """DQN reaches >=150 mean reward on CartPole, the reference's bar."""
    config = (rllib.DQNConfig()
              .environment(_cartpole)
              .env_runners(num_env_runners=2, num_envs_per_runner=4,
                           rollout_length=32)
              .training(lr=5e-4, buffer_size=20_000, learning_starts=500,
                        train_batch_size=64, num_updates_per_iter=96,
                        target_network_update_freq=250,
                        epsilon_anneal_steps=3_000, learner_device="cpu")
              .debugging(seed=1))
    algo = config.build()
    best = -np.inf
    reached = False
    for _ in range(100):
        result = algo.train()
        mean = result["episode_reward_mean"]
        if np.isfinite(mean):
            best = max(best, mean)
        if best >= 150:
            reached = True
            break
    algo.stop()
    assert reached, f"DQN did not reach 150 on CartPole (best={best:.1f})"


# ---------------------------------------------- build() of every config


def _expert_data():
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((64, 4)).astype(np.float32)
    return {"obs": obs, "actions": (obs[:, 2] > 0).astype(np.int64)}


#: name -> (config builder, the keys ``training_step`` adds to
#: ``Algorithm.step``'s, from the reference's algorithm)
BUILDS = {
    "PPO": (lambda: rllib.PPOConfig().environment(_cartpole),
            {"policy_loss", "vf_loss", "entropy", "kl"}),
    "Impala": (lambda: rllib.ImpalaConfig().environment(_cartpole),
               {"pg_loss", "vf_loss", "entropy", "num_inflight"}),
    "DQN": (lambda: rllib.DQNConfig().environment(_cartpole).training(
        learning_starts=16, train_batch_size=16, num_updates_per_iter=2),
        {"loss", "epsilon", "buffer_size"}),
    "SAC": (lambda: rllib.SACConfig().environment(_pendulum).training(
        learning_starts=16, train_batch_size=16, num_updates_per_iter=2,
        hidden=(32, 32)), {"critic_loss", "actor_loss", "alpha",
                           "buffer_size"}),
    "BC": (lambda: rllib.BCConfig().environment(_cartpole).offline_data(
        _expert_data()).training(num_updates_per_iter=2,
                                 train_batch_size=16), {"loss"}),
    "MultiAgentPPO": (_signal_match_ppo,
                      {"p0/policy_loss", "p0/entropy", "p1/policy_loss",
                       "p1/entropy"}),
}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_build_gives_an_algorithm_that_trains(ray, name):
    """``build()`` of each config returns its ``Algorithm`` (a Tune
    ``Trainable``) on the port's runtime, which trains one iteration with
    the learner on the CPU and reports ``Algorithm.step``'s keys and the
    algorithm's, as the reference's; ``get_weights()`` is a host tree of
    numpy arrays, as the reference's."""
    from ray_tpu_torch.tune import Trainable

    make, keys = BUILDS[name]
    cfg = make().env_runners(num_env_runners=1, num_envs_per_runner=2,
                             rollout_length=16).training(
                                 learner_device="cpu")
    algo = cfg.build()
    try:
        assert type(algo) is getattr(rllib, name)
        assert isinstance(algo, Trainable)
        r = algo.train()
        assert set(r) == keys | {"episode_reward_mean",
                                 "num_env_steps_sampled",
                                 "env_steps_per_sec", "training_iteration"}
        assert r["training_iteration"] == 1
        w = algo.get_weights()
        leaves = _leaves(w)
        assert leaves and all(isinstance(x, (np.ndarray, np.floating))
                              for x in leaves)
    finally:
        algo.stop()


def test_learner_refuses_a_missing_card(ray, monkeypatch):
    """The learner's default device is the card; where none is visible
    ``build()`` raises (no fall back to the CPU) and names the config
    field."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = rllib.PPOConfig().environment(_cartpole).env_runners(
        num_env_runners=1, num_envs_per_runner=1, rollout_length=4)
    assert cfg.learner_device == "cuda"
    with pytest.raises(RuntimeError, match="learner_device='cpu'"):
        cfg.build()
