"""Runtime environments: per-task/actor working_dir, py_modules, env_vars.

Reference analogue: `python/ray/_private/runtime_env/` — ``working_dir``
and ``py_modules`` are zipped, content-addressed, shipped through the GCS
KV store, and extracted into a per-URI cache on the executing node
(`packaging.py`: zip->GCS; `working_dir.py`: download+extract).  ``pip``/
``conda`` envs are declared but rejected here: the TPU image is hermetic
(no network), matching the deployment model where dependencies bake into
the image.

Flow:
  driver: prepare_runtime_env(env) zips local dirs -> kv["rtenv:<sha>"],
          rewrites the env to {"working_dir_uri": sha, ...};
  worker: ensure_runtime_env(env) fetches+extracts each URI once per node
          (cache keyed by sha), chdirs / extends sys.path.
"""

from __future__ import annotations

import hashlib
import io
import os
import sys
import zipfile
from typing import Optional

_MAX_PACKAGE_BYTES = 256 << 20
_EXCLUDE_DIRS = {".git", "__pycache__", ".venv", "node_modules"}


def _zip_dir(path: str) -> bytes:
    """Deterministic zip: sorted entries, zeroed timestamps — identical
    content hashes identically across machines/checkouts (mtimes would
    defeat the content-addressed KV dedup)."""
    buf = io.BytesIO()
    base = os.path.abspath(path)
    entries = []
    for root, dirs, files in os.walk(base):
        dirs[:] = sorted(d for d in dirs if d not in _EXCLUDE_DIRS)
        for f in sorted(files):
            full = os.path.join(root, f)
            entries.append((os.path.relpath(full, base), full))
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for rel, full in sorted(entries):
            info = zipfile.ZipInfo(rel, date_time=(1980, 1, 1, 0, 0, 0))
            info.compress_type = zipfile.ZIP_DEFLATED
            info.external_attr = (os.stat(full).st_mode & 0xFFFF) << 16
            with open(full, "rb") as fh:
                zf.writestr(info, fh.read())
            if buf.tell() > _MAX_PACKAGE_BYTES:
                raise ValueError(
                    f"runtime_env package {path} exceeds "
                    f"{_MAX_PACKAGE_BYTES >> 20}MB")
    return buf.getvalue()


def _dir_signature(path: str) -> tuple:
    """Cheap change signature (no content reads) for the driver-side
    packaging cache: (count, total size, max mtime_ns)."""
    count = size = 0
    newest = 0
    for root, dirs, files in os.walk(path):
        dirs[:] = [d for d in dirs if d not in _EXCLUDE_DIRS]
        for f in files:
            try:
                st = os.stat(os.path.join(root, f))
            except OSError:
                continue
            count += 1
            size += st.st_size
            newest = max(newest, st.st_mtime_ns)
    return (count, size, newest)


_package_cache: dict = {}  # (abspath, signature) -> sha


def _kv_key(sha: str) -> bytes:
    return f"rtenv:{sha}".encode()


def prepare_runtime_env(worker, env: Optional[dict]) -> Optional[dict]:
    """Driver-side: package local dirs into the GCS KV, returning an env
    whose dirs are content-addressed URIs (idempotent per content)."""
    if not env:
        return env
    if env.get("pip") or env.get("conda"):
        raise ValueError(
            "runtime_env pip/conda are not supported on the hermetic TPU "
            "image — bake dependencies into the image (reference parity: "
            "python/ray/_private/runtime_env/pip.py)")
    out = dict(env)
    wd = env.get("working_dir")
    if wd:
        if not os.path.isdir(wd):
            raise ValueError(
                f"runtime_env working_dir {wd!r} does not exist")
        out.pop("working_dir")
        out["working_dir_uri"] = _package_dir(worker, wd)
    mods = env.get("py_modules")
    if mods:
        uris = []
        for m in mods:
            if not os.path.isdir(m):
                raise ValueError(f"py_modules entry {m!r} is not a dir")
            uris.append((_package_dir(worker, m),
                         os.path.basename(os.path.abspath(m))))
        out.pop("py_modules")
        out["py_modules_uris"] = uris
    return out


def _package_dir(worker, path: str) -> str:
    """zip+hash+upload once per (path, content signature) — repeated
    .remote() calls with the same env skip the packaging work entirely."""
    key = (os.path.abspath(path), _dir_signature(path))
    sha = _package_cache.get(key)
    if sha is not None:
        return sha
    blob = _zip_dir(path)
    sha = hashlib.sha1(blob).hexdigest()
    if worker.kv_get(_kv_key(sha)) is None:
        worker.kv_put(_kv_key(sha), blob)
    _package_cache[key] = sha
    return sha


def _cache_root() -> str:
    from ray_tpu_torch.core.config import config

    return os.path.join(config.temp_dir, "runtime_envs")


def _ensure_extracted(worker, sha: str) -> str:
    dest = os.path.join(_cache_root(), sha)
    if os.path.isdir(dest):
        return dest
    blob = worker.kv_get(_kv_key(sha))
    if blob is None:
        raise RuntimeError(f"runtime_env package {sha} missing from GCS KV")
    tmp = dest + f".tmp{os.getpid()}"
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        zf.extractall(tmp)
    try:
        os.replace(tmp, dest)
    except OSError:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)  # raced another worker
    return dest


def ensure_runtime_env(worker, env: Optional[dict]):
    """Worker-side: materialize URIs, chdir into the working dir, extend
    sys.path for py_modules (reference: per-URI cache in
    `runtime_env/working_dir.py`)."""
    if not env:
        return
    sha = env.get("working_dir_uri")
    if sha:
        dest = _ensure_extracted(worker, sha)
        os.chdir(dest)
        if dest not in sys.path:
            sys.path.insert(0, dest)
    wd = env.get("working_dir")
    if wd:  # same-host local path (un-packaged, e.g. internal callers)
        os.chdir(wd)  # raises if missing — don't run in a stale cwd
        if wd not in sys.path:
            sys.path.insert(0, wd)
    for sha, name in env.get("py_modules_uris", ()):
        dest = _ensure_extracted(worker, sha)
        # importable as <name>: expose a parent dir containing the module
        parent = os.path.join(_cache_root(), f"mod_{sha}")
        os.makedirs(parent, exist_ok=True)
        link = os.path.join(parent, name)
        if not os.path.exists(link):
            try:
                os.symlink(dest, link)
            except OSError:
                pass  # raced another worker
        if parent not in sys.path:
            sys.path.insert(0, parent)
