"""Placement groups (reference: `python/ray/util/placement_group.py:34,139`,
bundle reservation 2PC at `src/ray/raylet/placement_group_resource_manager.cc`).

Single-node: bundles are resource sub-pools carved out of the node's pool
atomically when capacity allows; a PG whose bundles fit total capacity but
not *currently available* resources stays **pending** and is reserved as
resources free up — availability is never driven negative.  ``ready()``
returns an ObjectRef that resolves when the reservation lands (reference
semantics).  PACK/SPREAD/STRICT_* strategies are recorded and become
meaningful with multi-node scheduling (ICI-slice-aware packing is the TPU
analogue of NVLink-island STRICT_PACK — see SURVEY.md §7).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch.core.ids import ObjectID, PlacementGroupID, put_counter
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.worker import global_worker

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]],
                 strategy: str, ready_oid: Optional[ObjectID] = None):
        self.id = pg_id
        self.bundle_specs = bundles
        self.strategy = strategy
        self._ready_oid = ready_oid

    def ready(self) -> ObjectRef:
        """ObjectRef that resolves to True once every bundle is reserved."""
        if self._ready_oid is not None:
            return ObjectRef(self._ready_oid)
        import ray_tpu_torch

        return ray_tpu_torch.put(True)  # local mode: trivially ready

    def wait(self, timeout_seconds: Optional[float] = None) -> bool:
        import ray_tpu_torch

        ready, _ = ray_tpu_torch.wait([self.ready()], num_returns=1,
                                timeout=timeout_seconds)
        if not ready:
            return False
        try:
            # The ready object resolves to an error if the PG was removed
            # while still pending — that is NOT "ready".
            return bool(ray_tpu_torch.get(ready[0]))
        except Exception:  # noqa: BLE001
            return False

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def __repr__(self):
        return f"PlacementGroup({self.id.hex()}, {self.strategy}, {self.bundle_specs})"

    def __reduce__(self):
        return (PlacementGroup,
                (self.id, self.bundle_specs, self.strategy, self._ready_oid))


def placement_group(bundles: List[Dict[str, float]], strategy: str = "PACK",
                    name: str = "", lifetime: Optional[str] = None) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty dicts")
    worker = global_worker()
    pg_id = PlacementGroupID.from_random()
    if worker.mode == "local":
        return PlacementGroup(pg_id, bundles, strategy)
    ready_oid = put_counter.next_object_id()
    if worker.mode == "driver":
        ok = worker.raylet.call(
            worker.raylet.create_pg, pg_id.hex(), bundles, strategy, ready_oid
        ).result()
    else:
        ok = worker._request("create_pg", pg_id=pg_id.hex(), bundles=bundles,
                             strategy=strategy, ready_oid=ready_oid)
    if not ok:
        raise ValueError(
            f"placement group {bundles} exceeds cluster capacity"
        )
    return PlacementGroup(pg_id, bundles, strategy, ready_oid=ready_oid)


def remove_placement_group(pg: PlacementGroup):
    worker = global_worker()
    if worker.mode == "driver":
        worker.raylet.call(worker.raylet.remove_pg, pg.id.hex()).result()
    elif worker.mode in ("worker", "client"):
        worker._request("remove_pg", pg_id=pg.id.hex())


def get_current_placement_group() -> Optional[PlacementGroup]:
    return None
