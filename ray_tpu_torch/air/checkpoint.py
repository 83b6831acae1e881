"""Checkpoint — a morphable bundle of training state.

Reference analogue: `python/ray/air/checkpoint.py:66` (dict ⇄ directory ⇄ URI
representations).  The dict form holds host tensors and arrays (tensors are
copied to the CPU on save, dtype kept, so a checkpoint never pins device
memory), and directory serialization is a single pickle blob.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any, Dict, Optional

_METADATA_FILE = "ckpt.pkl"


def _to_host(tree):
    """Every tensor → a CPU copy of the same dtype (bf16 stays bf16),
    through dicts (a ``state_dict`` too), lists and tuples, so checkpoints
    don't pin device memory and hold the state as it was when they were
    made: a CPU tensor is copied too, since the loop goes on updating its
    own in place (an optimizer's step counters) while a reported
    checkpoint is still being shipped.  Numpy arrays and everything else
    pass unchanged."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        out = type(tree)((k, _to_host(v)) for k, v in tree.items())
        if hasattr(tree, "_metadata"):  # a state_dict's version record
            out._metadata = tree._metadata
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class Checkpoint:
    """A checkpoint either holds an in-memory dict or points at a directory."""

    def __init__(self, data: Optional[Dict[str, Any]] = None,
                 path: Optional[str] = None):
        if (data is None) == (path is None):
            raise ValueError("provide exactly one of data / path")
        self._data = data
        self._path = path

    # ------------------------------------------------------------ construct

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        return cls(data=_to_host(data))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path=path)

    # ------------------------------------------------------------ views

    def to_dict(self) -> Dict[str, Any]:
        if self._data is not None:
            return self._data
        with open(os.path.join(self._path, _METADATA_FILE), "rb") as f:
            return pickle.load(f)

    def to_directory(self, path: Optional[str] = None) -> str:
        if path is None:
            if self._path is not None:
                return self._path
            path = tempfile.mkdtemp(prefix="ray_tpu_ckpt_")
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, _METADATA_FILE), "wb") as f:
            pickle.dump(self.to_dict(), f, protocol=pickle.HIGHEST_PROTOCOL)
        return path

    @property
    def is_directory(self) -> bool:
        return self._path is not None

    def __repr__(self):
        kind = f"path={self._path}" if self._path else \
            f"keys={sorted(self.to_dict().keys())}"
        return f"Checkpoint({kind})"

    def __reduce__(self):
        # Ship the data form across processes; directory checkpoints stay
        # path-referenced (shared filesystem assumption, same as reference).
        if self._path is not None:
            return (Checkpoint, (None, self._path))
        return (Checkpoint, (self._data, None))
