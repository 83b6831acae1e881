"""Build of the hand-written CUDA kernels under ``ray_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Libraries go to
``ray_tpu_torch/_build/``, named by a hash of the sources and flags: a
changed source builds anew, an unchanged one is loaded as it is.  The
sources are compiled for ``sm_90a`` (Hopper) only.

A failed build raises ``KernelBuildError``: there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: name -> what nvcc printed for the last build (ptxas: registers, spills)
BUILD_LOG: Dict[str, str] = {}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    pass


def sources() -> Dict[str, str]:
    """name -> path of every ``csrc/*.cu``."""
    return {os.path.splitext(os.path.basename(p))[0]: p
            for p in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.isfile(path):
        raise KernelBuildError("nvcc not found (PATH, CUDA_HOME/bin)")
    return path


def _lib_path(src: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for p in [src] + headers:
        with open(p, "rb") as f:
            h.update(f.read())
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named sources (all by default) that have no library for
    their current hash, one ``nvcc`` each, all started together.  Returns
    name -> library path."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    missing = [n for n in names if n not in srcs]
    if missing:
        raise KernelBuildError(f"no source csrc/{missing[0]}.cu")
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = {n: _lib_path(srcs[n]) for n in names}
    todo = {n: p for n, p in out.items() if not os.path.isfile(p)}
    if not todo:
        return out
    nvcc = _nvcc()
    procs = {}
    for n, lib in todo.items():
        # per-pid temp name: a concurrent build never loads half a file
        tmp = f"{lib}.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, srcs[n]]
        procs[n] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for n, (cmd, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[n] = log
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{log}")
            if os.path.exists(tmp):
                os.unlink(tmp)
        else:
            os.replace(tmp, todo[n])
    if failed:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            _loaded[name] = lib
        return lib
