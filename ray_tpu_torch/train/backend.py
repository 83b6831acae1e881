"""Training backends — the tensor-plane bootstrap.

Reference analogue: `python/ray/train/backend.py` (``Backend``/
``BackendConfig``) + `python/ray/train/torch/config.py:69-170`
(``_setup_torch_process_group``: rank-0 address broadcast →
``dist.init_process_group(nccl|gloo)``).

The JAX package's ``JaxConfig``/``JaxBackend`` start ``jax.distributed``
across the worker group; their counterpart here is ``train/torch.py``'s
``TorchConfig`` backend, which joins every worker to one torch process
group (``ray_tpu_torch.parallel.mesh.init_process_group``).
"""

from __future__ import annotations

import socket

from ray_tpu_torch.train.worker_group import WorkerGroup


class BackendConfig:
    """Base config; subclasses name their backend class."""

    @property
    def backend_cls(self):
        return Backend


class Backend:
    def on_start(self, worker_group: WorkerGroup,
                 backend_config: BackendConfig):
        pass

    def on_training_start(self, worker_group: WorkerGroup,
                          backend_config: BackendConfig):
        pass

    def on_shutdown(self, worker_group: WorkerGroup,
                    backend_config: BackendConfig):
        pass


def _find_free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
