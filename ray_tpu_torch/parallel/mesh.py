"""Process-group mesh with named parallelism axes — counterpart of
``ray_tpu/parallel/mesh.py``.

The JAX package's mesh is a ``jax.sharding.Mesh`` over the devices of one
program; here each rank is a process and the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
initialised default process group, with ``mesh_dim_names`` in
``AXIS_ORDER``.  A mesh axis's process group (``mesh.get_group(name)``)
is what a JAX axis name is inside ``shard_map``: the ranks a collective
runs over.

Canonical axis names (outer → inner):

  dp    data parallel (pure replication of params)
  fsdp  fully-sharded data parallel (params sharded along it)
  pp    pipeline stages
  sp    sequence/context parallel (ring and Ulysses attention)
  tp    tensor parallel (megatron-style)
  ep    expert parallel (MoE)

The caller initialises the default group and so picks its backend
(``init_process_group``): ``nccl`` where each rank has its own card, the
default on CUDA; ``gloo`` for ranks on the CPU or ranks that share one
card, which NCCL refuses.  Nothing here retries with another backend.
"""

from __future__ import annotations

import datetime
import math
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXIS_ORDER = ("dp", "fsdp", "pp", "sp", "ep", "tp")


def init_process_group(init_method: str, world_size: int, rank: int,
                       backend: Optional[str] = None, device="cuda",
                       timeout_s: float = 300.0) -> torch.device:
    """Join the default process group as ``rank`` of ``world_size`` at
    ``init_method`` (``tcp://localhost:<port>``, ``file://<path>``), with
    a timeout on the rendezvous and on every collective.  ``backend``
    defaults to ``"nccl"`` on a CUDA ``device``, ``"gloo"`` on the CPU.  A
    CUDA device without an index is ``rank % device_count``; it becomes
    the current device.  Returns the rank's device."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return device


def create_mesh(axes: Dict[str, int], ranks: Optional[Sequence[int]] = None,
                device_type: str = "cuda") -> DeviceMesh:
    """Build a mesh from {axis_name: size}; size -1 means "all remaining".

    ``ranks`` are the global ranks the mesh spans, all of the default
    group's by default (the JAX function's ``devices``); they fill the mesh
    in row-major order with the axes laid out in AXIS_ORDER, so the
    innermost (tp) axis holds adjacent ranks.  Every rank of the group
    calls this together: building the axes' groups is collective."""
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    n = len(ranks)
    sizes = dict(axes)
    unknown = [k for k, v in sizes.items() if v == -1]
    if len(unknown) > 1:
        raise ValueError("at most one axis may be -1")
    known = math.prod(v for v in sizes.values() if v != -1) or 1
    if unknown:
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[unknown[0]] = n // known
    total = math.prod(sizes.values()) if sizes else 1
    if total != n:
        raise ValueError(
            f"mesh axes {sizes} require {total} devices, have {n}"
        )
    names = [a for a in AXIS_ORDER if a in sizes]
    names += [a for a in sizes if a not in AXIS_ORDER]
    shape = [sizes[a] for a in names]
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=tuple(names))


def single_device_mesh(axis: str = "dp", device_type: str = "cuda"
                       ) -> DeviceMesh:
    """A one-rank mesh of rank 0, as the JAX one holds the first device;
    every rank of the default group builds it together."""
    return DeviceMesh(device_type, [0], mesh_dim_names=(axis,))


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


def local_device_count() -> int:
    """CUDA devices this process sees."""
    return torch.cuda.device_count()
