"""LearnerGroup — data-parallel learner fan-out over actor replicas.

Reference analogue: `rllib/core/learner/learner_group.py:61` (N Learner
workers, each holding a replica of the module, gradients averaged across
them per update).  TPU-first twist: each replica's update is the
algorithm's existing jitted program; only the GRADIENT allreduce crosses
processes, over the host collective group
(`ray_tpu_torch/collective` — the DCN plane; on real multi-host TPU the same
update runs under pjit with psum instead).

The factory seam keeps this algorithm-agnostic: the driver ships a
cloudpickled ``factory()`` returning

    {"params", "grad_fn": (params, batch) -> (grads, metrics),
     "apply_fn": (params, grads) -> None (one optimizer step in place)}

Each replica computes grads on its shard, allreduce-means them, and
applies the identical averaged update — replicas stay in lockstep, so
weights can be read from any one of them.

Counterpart of ``ray_tpu/rllib/learner_group.py``: the factory ships with
the vendored cloudpickle; the replicas run on the CPU
(``CUDA_VISIBLE_DEVICES=""``, where the reference pins JAX to the CPU);
the gradient tree flattens in ``tree_leaves``' order into one f32 CPU
tensor for the host group's all-reduce (``collective.allreduce``), in
place of ``jax.tree.flatten``; weights travel as ``params_to_numpy``'s host
tree, as the reference's ``jax.tree.map(np.asarray, ...)``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["LearnerGroup", "LearnerWorker"]


class LearnerWorker:
    """One learner replica (runs as an actor)."""

    def __init__(self, factory_blob: bytes, world: int, rank: int,
                 group_name: str):
        from ray_tpu_torch import collective as col
        from ray_tpu_torch._vendor import cloudpickle

        built = cloudpickle.loads(factory_blob)()
        self._params = built["params"]
        self._grad_fn = built["grad_fn"]
        self._apply_fn = built["apply_fn"]
        self._world = world
        self._group = group_name
        if world > 1:
            col.init_collective_group(world, rank, backend="host",
                                      group_name=group_name)

    def update(self, shard: Dict[str, np.ndarray]) -> Dict[str, float]:
        import torch

        from ray_tpu_torch import collective as col
        from ray_tpu_torch.rllib.algorithm import to_learner
        from ray_tpu_torch.rllib.optim import tree_leaves, tree_unflatten

        device = tree_leaves(self._params)[0].device
        grads, metrics = self._grad_fn(self._params,
                                       to_learner(shard, device))
        if self._world > 1:
            # ONE allreduce of the concatenated flat gradient (leaf-per-call
            # would pay the host-group round trip per tensor)
            leaves = tree_leaves(grads)
            flat = torch.cat([l.detach().reshape(-1).to("cpu",
                                                         torch.float32)
                              for l in leaves])
            flat = col.allreduce(flat, group_name=self._group) / self._world
            out = [part.reshape(l.shape).to(l.device, l.dtype)
                   for part, l in zip(torch.split(
                       flat, [l.numel() for l in leaves]), leaves)]
            grads = tree_unflatten(grads, out)
        self._apply_fn(self._params, grads)
        return {k: float(v) for k, v in metrics.items()}

    def get_weights(self):
        from ray_tpu_torch.rllib.models import params_to_numpy

        return params_to_numpy(self._params)

    def set_weights(self, weights):
        from ray_tpu_torch.rllib.models import load_params

        load_params(self._params, weights)
        return True


class LearnerGroup:
    """Driver-side handle: shards each batch across the replicas, runs
    their updates in lockstep, and reads weights from replica 0."""

    _seq = 0

    def __init__(self, factory, num_learners: int,
                 resources: Optional[Dict[str, float]] = None):
        import ray_tpu_torch
        from ray_tpu_torch._vendor import cloudpickle

        LearnerGroup._seq += 1
        group_name = f"learner_group_{LearnerGroup._seq}"
        blob = cloudpickle.dumps(factory)
        res = resources or {}
        worker_cls = ray_tpu_torch.remote(
            num_cpus=res.get("CPU", 1), max_restarts=0,
            runtime_env={"env_vars": {"CUDA_VISIBLE_DEVICES": ""}},
        )(LearnerWorker)
        self._workers = [
            worker_cls.remote(blob, num_learners, rank, group_name)
            for rank in range(num_learners)
        ]
        self.num_learners = num_learners

    @staticmethod
    def _shard(batch: Dict[str, np.ndarray], n: int, axis_map=None
               ) -> List[Dict[str, np.ndarray]]:
        """Split every array along its batch axis (default 0; axis_map
        overrides per key — IMPALA's time-major arrays split on axis 1)."""
        shards = [dict() for _ in range(n)]
        for k, v in batch.items():
            v = np.asarray(v)
            ax = (axis_map or {}).get(k, 0)
            if v.shape[ax] < n:
                # an empty shard's mean-based loss is NaN, and the
                # allreduce would poison every replica — fail loudly
                raise ValueError(
                    f"batch axis {ax} of {k!r} ({v.shape[ax]}) is smaller "
                    f"than num_learners ({n}); use fewer learners or "
                    f"bigger batches")
            parts = np.array_split(v, n, axis=ax)
            for i in range(n):
                shards[i][k] = parts[i]
        return shards

    def update(self, batch: Dict[str, np.ndarray], axis_map=None
               ) -> Dict[str, float]:
        import ray_tpu_torch

        shards = self._shard(batch, self.num_learners, axis_map)
        metrics = ray_tpu_torch.get(
            [w.update.remote(s) for w, s in zip(self._workers, shards)],
            timeout=300)
        return metrics[0]

    def get_weights(self):
        import ray_tpu_torch

        return ray_tpu_torch.get(self._workers[0].get_weights.remote(),
                           timeout=120)

    def get_all_weights(self) -> List[Any]:
        """Every replica's weights (tests assert lockstep)."""
        import ray_tpu_torch

        return ray_tpu_torch.get(
            [w.get_weights.remote() for w in self._workers], timeout=120)

    def set_weights(self, weights):
        """Checkpoint restore: push identical weights into every replica."""
        import ray_tpu_torch

        ray_tpu_torch.get([w.set_weights.remote(weights) for w in self._workers],
                    timeout=120)

    def shutdown(self):
        import ray_tpu_torch

        for w in self._workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001
                pass
