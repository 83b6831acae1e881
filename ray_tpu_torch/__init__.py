"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

A package beside ``ray_tpu`` with the same module paths
(``ray_tpu_torch/ops/flash_attention.py`` is the counterpart of
``ray_tpu/ops/flash_attention.py``).  It imports ``torch`` and nothing of
JAX or of ``ray_tpu``; where it needs a pure-Python module of ``ray_tpu``
it keeps its own copy.  Every Pallas kernel on a ported path is a kernel
written by hand for ``sm_90a`` under ``csrc/``.

Sub-packages: ``ops`` (flash attention), ``native`` (the nvcc build of
``csrc``), ``models`` (GPT-2, Llama, the MNIST CNN), ``core`` (config flags,
exceptions), ``serve`` (the replica, batching, multiplexing),
``parallel`` (mesh, sharding rules, ring and Ulysses attention, the
pipeline, spawned ranks), ``collective`` (named-axis collectives over
process groups) and ``rllib`` (policy nets, optax's optimizer steps, the
PPO, IMPALA, DQN, SAC and BC updates).
No runtime is started on import.
"""

from ray_tpu_torch._version import __version__

__all__ = ["__version__", "collective", "core", "models", "native", "ops",
           "parallel", "rllib", "serve"]
