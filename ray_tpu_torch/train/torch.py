"""Torch training backend: process-group bootstrap + DDP helpers.

Reference analogue: `python/ray/train/torch/config.py:29` (``TorchConfig``),
``_TorchBackend.on_start :158`` → ``_setup_torch_process_group :69`` (rank-0
address broadcast, ``dist.init_process_group(nccl|gloo)``), and
`train/torch/train_loop_utils.py:75` (``prepare_model`` → DDP wrap,
``prepare_data_loader :116`` → DistributedSampler).

In the port this is the trainer on the card, in the JAX package's
``JaxTrainer``'s role: every worker joins one torch process group through
``ray_tpu_torch.parallel.mesh.init_process_group``, over nccl where each
worker holds a card of its own and over gloo where workers share one card
(``{"TPU": 0.5}``) or hold none; a backend given explicitly is honoured.
``get_device()`` is the worker's card where it holds a chip (the runtime's
chip profile) and the CPU where it holds none.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

from ray_tpu_torch.train.backend import Backend, BackendConfig, _find_free_port
from ray_tpu_torch.train.trainer import DataParallelTrainer
from ray_tpu_torch.train.worker_group import WorkerGroup

__all__ = ["TorchConfig", "TorchTrainer", "prepare_model",
           "prepare_data_loader", "get_device"]


@dataclass
class TorchConfig(BackendConfig):
    # None: "nccl" where every worker holds a card of its own, else "gloo"
    backend: Optional[str] = None
    init_port: Optional[int] = None
    timeout_s: float = 120.0

    @property
    def backend_cls(self):
        return _TorchBackend

    def worker_env(self):
        return {}


def _master_addr_port(port: Optional[int]):
    # the node's address in a multi-node cluster, else this host's loopback
    return (os.environ.get("RAY_TPU_NODE_IP") or "127.0.0.1",
            port or _find_free_port())


def _holds_chip() -> bool:
    """Whether this process is a runtime worker of the chip profile (a
    task or actor that asked for ``"TPU"``)."""
    return os.environ.get("RAY_TPU_WORKER_PROFILE", "").startswith("tpu")


def _worker_card(rank: int) -> Optional[str]:
    """The UUID of the card rank ``rank`` takes (``rank % cards``, as
    ``init_process_group`` takes it), or None where the worker holds no
    chip."""
    if not _holds_chip():
        return None
    import torch

    device = _card(rank)
    return str(torch.cuda.get_device_properties(device).uuid)


def _card(rank: int):
    """Card ``rank % cards`` of this process; raises where none is
    visible rather than falling back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "this worker holds a chip but sees no CUDA device "
            f"(CUDA_VISIBLE_DEVICES={os.environ.get('CUDA_VISIBLE_DEVICES')!r})")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _setup_torch_process_group(backend: str, device: str, master_addr: str,
                               master_port: int, rank: int,
                               world_size: int, timeout_s: float):
    """Runs inside each training worker (reference:
    `train/torch/config.py:69`)."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import init_process_group

    os.environ["MASTER_ADDR"] = master_addr
    os.environ["MASTER_PORT"] = str(master_port)
    os.environ["RANK"] = str(rank)
    os.environ["WORLD_SIZE"] = str(world_size)
    init_process_group(f"tcp://{master_addr}:{master_port}", world_size,
                       rank, backend=backend, device=device,
                       timeout_s=timeout_s)
    return dist.get_rank()


def _shutdown_torch_process_group():
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


class _TorchBackend(Backend):
    def on_start(self, worker_group: WorkerGroup,
                 backend_config: TorchConfig):
        if len(worker_group) <= 1:
            return
        addr, port = worker_group.execute_single(
            0, _master_addr_port, backend_config.init_port)
        import ray_tpu_torch

        cards = ray_tpu_torch.get([
            w.execute.remote(_worker_card, rank)
            for rank, w in enumerate(worker_group.workers)], timeout=300)
        backend = backend_config.backend or (
            "nccl" if None not in cards and len(set(cards)) == len(cards)
            else "gloo")
        futures = [
            w.execute.remote(
                _setup_torch_process_group, backend,
                "cpu" if card is None else "cuda",
                addr, port, rank, len(worker_group),
                backend_config.timeout_s)
            for rank, (w, card) in enumerate(zip(worker_group.workers, cards))
        ]
        ranks = ray_tpu_torch.get(futures, timeout=300)
        assert sorted(ranks) == list(range(len(worker_group)))

    def on_shutdown(self, worker_group: WorkerGroup,
                    backend_config: TorchConfig):
        try:
            worker_group.execute(_shutdown_torch_process_group)
        except Exception:  # noqa: BLE001
            pass


# ------------------------------------------------------------ loop utils


def get_device():
    """The device this worker should use (reference:
    ``train.torch.get_device``): the card of its rank where the worker
    holds a chip, the CPU where it holds none."""
    import torch
    import torch.distributed as dist

    if not _holds_chip():
        return torch.device("cpu")
    if dist.is_available() and dist.is_initialized():
        return _card(dist.get_rank())
    from ray_tpu_torch.train import session

    s = session.get_session()
    return _card(s.context.world_rank if s is not None else 0)


def prepare_model(model, parallel_strategy: str = "ddp"):
    """Wrap in DDP when a process group is live (reference:
    `train_loop_utils.py:75-98`)."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel as DDP

    device = get_device()
    model = model.to(device)
    if parallel_strategy and dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return DDP(model, device_ids=[device.index]
                   if device.type == "cuda" else None)
    return model


def prepare_data_loader(data_loader):
    """Re-create the DataLoader with a DistributedSampler so each rank
    sees its shard (reference: `train_loop_utils.py:116`)."""
    import torch.distributed as dist
    from torch.utils.data import DataLoader
    from torch.utils.data.distributed import DistributedSampler

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return data_loader
    # Preserve the loader's ordering intent: a sequentially-sampled loader
    # must stay ordered per shard (reference keeps the shuffle choice when
    # re-wrapping).
    from torch.utils.data import RandomSampler

    was_shuffled = isinstance(data_loader.sampler, RandomSampler)
    sampler = DistributedSampler(data_loader.dataset, shuffle=was_shuffled)
    return DataLoader(
        data_loader.dataset,
        batch_size=data_loader.batch_size,
        sampler=sampler,
        num_workers=data_loader.num_workers,
        pin_memory=data_loader.pin_memory,
        collate_fn=data_loader.collate_fn,
        drop_last=data_loader.drop_last,
    )


class TorchTrainer(DataParallelTrainer):
    """DataParallelTrainer with the torch process-group bootstrap
    (reference: `python/ray/train/torch/torch_trainer.py`)."""

    _default_backend_config = TorchConfig()

    def __init__(self, train_loop_per_worker, *,
                 torch_config: Optional[TorchConfig] = None, **kwargs):
        kwargs.setdefault("backend_config", torch_config or TorchConfig())
        super().__init__(train_loop_per_worker, **kwargs)
