"""A session root of one's own for a driver of the runtime.

The runtime puts each session's directory, with its Unix sockets, under
``config.temp_dir`` (``RAY_TPU_TEMP_DIR``), ``/tmp/ray_tpu_torch`` by
default: one directory that every driver on the host shares, and with it
the runtime_env cache in ``<temp_dir>/runtime_envs``.  ``new_session_root()``
makes a new, empty directory for a driver that should share none of that
(a test, a smoke run); set ``config.temp_dir`` to it in the driver, or
``RAY_TPU_TEMP_DIR`` in a driver's environment, and remove it after
``shutdown()``.
"""

from __future__ import annotations

import os
import tempfile

# AF_UNIX allows 107 bytes of path.  The longest socket under a root is a
# worker's direct listener, ``<root>/session_<%Y%m%d-%H%M%S>_<pid>_<6 hex>/
# direct-<pid>.sock`` (``core/worker.py``'s session dir,
# ``core/direct.py``'s listener), with pids of up to 7 digits (Linux's
# largest pid_max, 2**22).
_SOCKET_TAIL = len("/session_20260101-000000_4194304_abcdef"
                   "/direct-4194304.sock")
_AF_UNIX_PATH_MAX = 107


def new_session_root(prefix: str = "rtt_") -> str:
    """A new directory under the temp dir (``TMPDIR``), or under ``/tmp``
    where the temp dir's path would leave the session's sockets too long
    for AF_UNIX."""
    root = tempfile.mkdtemp(prefix=prefix)
    if len(root) + _SOCKET_TAIL > _AF_UNIX_PATH_MAX:
        os.rmdir(root)
        root = tempfile.mkdtemp(prefix=prefix, dir="/tmp")
    return root
