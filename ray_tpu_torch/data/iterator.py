"""DataIterator — the per-worker view of a dataset shard.

Reference analogue: `python/ray/data/iterator.py` (``DataIterator`` with
``iter_batches`` / ``iter_torch_batches``).  Train workers receive one of
these from ``session.get_dataset_shard`` and pull host batches from it;
``iter_torch_batches`` stages each numpy batch onto the card (from pinned
host memory, without blocking the host) unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional


def _torch_device(device):
    """``device`` as a ``torch.device``; a CUDA device where no card is
    present raises rather than falling back to the CPU."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"batches asked for on {device}, but no CUDA device is "
            "available to this process; pass device='cpu' for host batches")
    return device


def _stage(array, dtype, device):
    """One numpy column as a tensor of ``dtype`` on ``device``."""
    import numpy as np
    import torch

    t = torch.from_numpy(np.ascontiguousarray(array))
    if dtype is not None:
        t = t.to(dtype)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


class DataIterator:
    def __init__(self, dataset):
        self._dataset = dataset

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str = "numpy", drop_last: bool = False,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None) -> Iterator[Any]:
        return self._dataset.iter_batches(
            batch_size=batch_size, batch_format=batch_format,
            drop_last=drop_last,
            local_shuffle_buffer_size=local_shuffle_buffer_size,
            local_shuffle_seed=local_shuffle_seed)

    def iter_rows(self) -> Iterator[Any]:
        return self._dataset.iter_rows()

    def iter_torch_batches(self, *, batch_size: int = 256,
                           drop_last: bool = True, dtype=None,
                           device="cuda") -> Iterator[Any]:
        """Numpy batches as tensors staged onto ``device`` (host→HBM: a
        copy from pinned memory with ``non_blocking``); on the CPU only
        where the caller passes ``device="cpu"``.  Raises where a CUDA
        device is asked for and no card is present.  Each batch is staged
        in the ``region`` ``data.stage``."""
        from ray_tpu_torch.util.tracing import region

        device = _torch_device(device)
        for batch in self.iter_batches(batch_size=batch_size,
                                       drop_last=drop_last):
            with region("data.stage"):
                if isinstance(batch, dict):
                    out = {k: _stage(v, dtype, device)
                           if v.dtype.kind in "fiub" else v
                           for k, v in batch.items()}
                else:
                    out = _stage(batch, dtype, device)
            yield out

    def materialize(self):
        return self._dataset.materialize()

    def count(self) -> int:
        return self._dataset.count()

    def __iter__(self):
        return self.iter_rows()

    def __repr__(self):
        return f"DataIterator({self._dataset!r})"


class StreamSplitDataIterator(DataIterator):
    """One shard of ``Dataset.streaming_split(n)`` (reference:
    `_internal/iterator/stream_split_iterator.py`).

    Blocks are claimed from the split coordinator on demand and executed
    through the dataset's lazy op chain with a small prefetch pipeline —
    nothing materializes up front, and whatever this consumer doesn't
    claim goes to its siblings."""

    def __init__(self, dataset, coordinator, index: int, world: int):
        super().__init__(dataset)
        self._coord = coordinator
        self.index = index
        self.world = world
        self._epoch = 0

    def _claimed_blocks(self):
        """Generator of local blocks for this epoch (prefetch depth 2); each
        claim is the ``region`` ``data.claim``, each wait for a block's
        read ``data.block_wait``."""
        import ray_tpu_torch
        from ray_tpu_torch.util.tracing import region

        epoch = self._epoch
        self._epoch += 1

        def claim():
            with region("data.claim"):
                return ray_tpu_torch.get(self._coord.claim.remote(epoch),
                                         timeout=120)

        pending = []
        for _ in range(2):
            i = claim()
            if i is None:
                break
            pending.append(self._dataset._execute_block(i))
        while pending:
            ref = pending.pop(0)
            i = claim()
            if i is not None:
                pending.append(self._dataset._execute_block(i))
            with region("data.block_wait"):
                block = ray_tpu_torch.get(ref)
            yield block

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str = "numpy", drop_last: bool = False,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None) -> Iterator[Any]:
        from ray_tpu_torch.data.dataset import _batches_from_block_iter

        return _batches_from_block_iter(
            self._claimed_blocks(), batch_size=batch_size,
            batch_format=batch_format, drop_last=drop_last,
            local_shuffle_buffer_size=local_shuffle_buffer_size,
            local_shuffle_seed=local_shuffle_seed)

    def iter_rows(self) -> Iterator[Any]:
        from ray_tpu_torch.data.block import BlockAccessor

        for block in self._claimed_blocks():
            yield from BlockAccessor.for_block(block).iter_rows()

    def count(self) -> int:
        raise TypeError("a streaming-split shard has no static count — "
                        "its share of blocks is decided by the pull loop")

    def materialize(self):
        raise TypeError("streaming-split shards are consume-once streams")

    def __repr__(self):
        return (f"StreamSplitDataIterator({self.index}/{self.world}, "
                f"{self._dataset!r})")
