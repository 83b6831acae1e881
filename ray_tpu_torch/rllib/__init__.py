"""ray_tpu_torch.rllib — RL training: EnvRunner actors + learners on the
card, counterpart of ``ray_tpu/rllib/``.

``Algorithm`` (a Tune ``Trainable`` driving ``EnvRunner`` actors,
``algorithm.py``) and its subclasses ``PPO``, ``Impala``, ``DQN``, ``SAC``,
``BC`` and ``MultiAgentPPO``; ``LearnerGroup`` (data-parallel learner
replicas over the host collectives); the replay buffers; the policy nets
(``models.py``: the MLP, the Nature-CNN, ``sample_action``), optax's
optimizer steps (``optim.py``), ``SampleBatch``, and the update of each
learner: PPO (``compute_gae``, ``_make_update_fn``), IMPALA
(``make_vtrace_fn``, ``_make_grad_apply``), DQN (``dqn_action_fn``,
``dqn_update``), SAC (``sample_squashed``, ``sac_update``) and BC
(``bc_update``).  The learner lives on the card unless the config's
``learner_device`` is ``"cpu"``; the runners sample on the CPU.

Usage:
    config = (PPOConfig()
              .environment(lambda: gymnasium.make("CartPole-v1"))
              .env_runners(num_env_runners=4))
    algo = config.build()
    while algo.train()["episode_reward_mean"] < 450: pass
"""

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.bc import BC, BCConfig, bc_update
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig, dqn_action_fn, dqn_update
from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.impala import Impala, ImpalaConfig, make_vtrace_fn
from ray_tpu_torch.rllib.learner_group import LearnerGroup, LearnerWorker
from ray_tpu_torch.rllib.models import (cnn_forward, init_cnn_policy,
                                        init_mlp_policy, mlp_forward,
                                        params_from_numpy, params_to_numpy,
                                        policy_forward, sample_action)
from ray_tpu_torch.rllib.multi_agent import (MultiAgentEnv,
                                             MultiAgentEnvRunner,
                                             MultiAgentPPO,
                                             MultiAgentPPOConfig)
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig, compute_gae
from ray_tpu_torch.rllib.replay_buffers import (PrioritizedReplayBuffer,
                                                ReplayBuffer)
from ray_tpu_torch.rllib.sac import (SAC, SACConfig, sac_action_fn,
                                     sac_update, sample_squashed)
from ray_tpu_torch.rllib.sample_batch import SampleBatch

__all__ = [
    "Algorithm", "AlgorithmConfig", "BC", "BCConfig", "DQN", "DQNConfig",
    "EnvRunner",
    "Impala", "ImpalaConfig", "LearnerGroup", "LearnerWorker",
    "MultiAgentEnv", "MultiAgentEnvRunner", "MultiAgentPPO",
    "MultiAgentPPOConfig", "PPO", "PPOConfig",
    "PrioritizedReplayBuffer", "ReplayBuffer", "SAC", "SACConfig",
    "SampleBatch",
    "compute_gae", "cnn_forward", "init_cnn_policy", "init_mlp_policy",
    "make_vtrace_fn", "mlp_forward", "policy_forward", "sac_action_fn",
    "sample_action",
    # the port's own: the update functions and the host tree's conversions
    "bc_update", "dqn_action_fn", "dqn_update", "params_from_numpy",
    "params_to_numpy", "sac_update", "sample_squashed",
]
