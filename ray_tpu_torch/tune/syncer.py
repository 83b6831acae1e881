"""Experiment-directory syncing to URI storage backends.

Reference analogue: `python/ray/tune/syncer.py:24-115` (the Syncer that
mirrors trial/experiment dirs to cloud storage so experiments survive the
head node and restore anywhere).

Backends register by URI scheme.  ``file://`` ships built-in (and is what
the tests exercise); ``gs://`` / ``s3://`` adapters plug in by
subclassing :class:`Syncer` and registering — the transfer surface is two
directory copies, so any blob client slots in.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Type
from urllib.parse import urlparse

__all__ = ["Syncer", "FileSyncer", "get_syncer", "register_syncer"]


class Syncer:
    """Mirror a local directory to/from a URI."""

    def sync_up(self, local_dir: str, uri: str) -> None:
        raise NotImplementedError

    def sync_down(self, uri: str, local_dir: str) -> None:
        raise NotImplementedError


class FileSyncer(Syncer):
    """file:// backend — a directory merge-copy.  Doubles as NFS/fuse
    "cloud" storage (mount the bucket, point storage_path at it)."""

    @staticmethod
    def _path(uri: str) -> str:
        parsed = urlparse(uri)
        if parsed.scheme != "file":
            raise ValueError(f"FileSyncer got non-file URI {uri!r}")
        return parsed.path

    def sync_up(self, local_dir: str, uri: str) -> None:
        """Incremental: only files whose (size, mtime) changed re-copy —
        the controller syncs on every state save, and re-shipping every
        retained checkpoint each time would be O(experiment size)."""
        dest = self._path(uri)
        for root, _dirs, files in os.walk(local_dir):
            rel = os.path.relpath(root, local_dir)
            droot = dest if rel == "." else os.path.join(dest, rel)
            os.makedirs(droot, exist_ok=True)
            for fname in files:
                s = os.path.join(root, fname)
                d = os.path.join(droot, fname)
                try:
                    sst = os.stat(s)
                    dst = os.stat(d)
                    if (int(sst.st_mtime) <= int(dst.st_mtime)
                            and sst.st_size == dst.st_size):
                        continue
                except OSError:
                    pass
                shutil.copy2(s, d)

    def sync_down(self, uri: str, local_dir: str) -> None:
        src = self._path(uri)
        if not os.path.isdir(src):
            raise FileNotFoundError(f"no synced experiment at {uri}")
        os.makedirs(local_dir, exist_ok=True)
        shutil.copytree(src, local_dir, dirs_exist_ok=True)


_SYNCERS: Dict[str, Type[Syncer]] = {"file": FileSyncer}


def register_syncer(scheme: str, cls: Type[Syncer]) -> None:
    _SYNCERS[scheme] = cls


def get_syncer(uri: str) -> Syncer:
    scheme = urlparse(uri).scheme
    cls = _SYNCERS.get(scheme)
    if cls is None:
        raise ValueError(
            f"no syncer registered for scheme {scheme!r} "
            f"(have: {sorted(_SYNCERS)}); register one with "
            "ray_tpu_torch.tune.syncer.register_syncer")
    return cls()
