"""ray_tpu_torch.rllib — the RL learners' device functions, counterpart of
``ray_tpu/rllib/`` without the runtime.

Policy nets (``models.py``: the MLP, the Nature-CNN, ``sample_action``),
optax's optimizer steps (``optim.py``), ``SampleBatch``, and the update
of each learner: PPO (``compute_gae``, ``_make_update_fn``), IMPALA
(``make_vtrace_fn``, ``_make_grad_apply``), DQN (``dqn_action_fn``,
``dqn_update``), SAC (``sample_squashed``, ``sac_update``) and BC
(``bc_update``).  The configs are here; their ``build()`` raises, since
``Algorithm``, ``EnvRunner``, ``LearnerGroup``, ``MultiAgentPPO`` and the
replay buffers need the runtime (ROADMAP.md §A7).  Nothing here imports
``tune``.
"""

from ray_tpu_torch.rllib.algorithm import AlgorithmConfig
from ray_tpu_torch.rllib.bc import BCConfig, bc_update
from ray_tpu_torch.rllib.dqn import DQNConfig, dqn_action_fn, dqn_update
from ray_tpu_torch.rllib.impala import ImpalaConfig, make_vtrace_fn
from ray_tpu_torch.rllib.models import (cnn_forward, init_cnn_policy,
                                        init_mlp_policy, mlp_forward,
                                        params_from_numpy, policy_forward,
                                        sample_action)
from ray_tpu_torch.rllib.ppo import PPOConfig, compute_gae
from ray_tpu_torch.rllib.sac import (SACConfig, sac_action_fn, sac_update,
                                     sample_squashed)
from ray_tpu_torch.rllib.sample_batch import SampleBatch

__all__ = [
    "AlgorithmConfig", "BCConfig", "DQNConfig", "ImpalaConfig", "PPOConfig",
    "SACConfig", "SampleBatch", "bc_update", "cnn_forward", "compute_gae",
    "dqn_action_fn", "dqn_update", "init_cnn_policy", "init_mlp_policy",
    "make_vtrace_fn", "mlp_forward", "params_from_numpy", "policy_forward",
    "sac_action_fn", "sac_update", "sample_action", "sample_squashed",
]
