"""Python's compiled bytecode, kept inside the checkout.

Where the environment forbids writing bytecode (``PYTHONDONTWRITEBYTECODE``)
and the installed packages ship none, every process compiles each module
it imports from source, every run: ``import torch`` alone then costs
seconds of host time in each of the run's processes, and the set-up swings
with the host's load.  ``keep_in`` has this process and every process it
starts (the runtime's, which inherit the environment) write and read
their bytecode under one fixed directory of the checkout, so that only a
checkout's first run compiles.
"""

import os
import sys


def keep_in(root: str) -> str:
    """Write and read bytecode under ``<root>/.bench_cache/pycache``, here
    and in every process started from here; returns the directory.  Call
    it before importing anything large."""
    path = os.path.join(root, ".bench_cache", "pycache")
    sys.pycache_prefix = path
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = path
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    return path
