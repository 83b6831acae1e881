"""Thread-local mesh context — counterpart of ``ray_tpu/parallel/context.py``.

Models need the mesh to run sequence-parallel attention over its ``sp``
axis; threading it through every call signature is noisy, so callers bind
it here around the model's calls (``with use_mesh(mesh): ...``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

from torch.distributed.device_mesh import DeviceMesh

_state = threading.local()


def get_mesh() -> Optional[DeviceMesh]:
    return getattr(_state, "mesh", None)


def require_mesh() -> DeviceMesh:
    mesh = get_mesh()
    if mesh is None:
        raise RuntimeError(
            "no mesh bound — wrap the call in `with use_mesh(mesh):` "
            "(the Train layer does this automatically)"
        )
    return mesh


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh):
    prev = get_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev
