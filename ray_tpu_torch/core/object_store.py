"""Python client for the native shared-memory object store.

Counterpart of the reference's plasma client
(`src/ray/object_manager/plasma/client.h:146`) — but with no store server
process: all metadata lives in the shm mapping itself (see
`ray_tpu_torch/native/src/object_store.cc` for the design rationale), so create /
seal / get are lock-protected shm operations, not socket round trips.

Zero-copy: ``get`` deserializes with out-of-band buffers that alias the mmap
directly; the store pin is released when the returned root object is
garbage-collected (weakref.finalize).  Known round-1 limitation: if a caller
extracts a numpy view from the returned object and drops the root, the pin is
released early and the buffer becomes evictable under memory pressure (the
mapping itself stays valid, so this can never segfault).
"""

from __future__ import annotations

import ctypes
import itertools
import mmap as _mmap
import os
import threading
import time
import weakref
from typing import Any, Optional

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.util.locks import make_lock


from ray_tpu_torch.core.exceptions import ObjectLostError as _BaseObjectLostError

config.define("object_store_spill", bool, True,
              "Overflowing puts spill to disk (reference: "
              "local_object_manager.h:41) instead of LRU-evicting sealed "
              "objects; False restores pure in-memory LRU behavior.")


class ObjectStoreFullError(RuntimeError):
    pass


# Disambiguates concurrent spill tmp files within one process (itertools
# .count() is GIL-atomic).
_spill_tmp_seq = itertools.count()


class ObjectLostError(_BaseObjectLostError):
    """Canonical ray_tpu_torch ObjectLostError, enriched with the object id (so
    ``except ray_tpu_torch.ObjectLostError`` catches store-level evictions)."""

    def __init__(self, object_id: ObjectID):
        super().__init__(
            f"Object {object_id.hex()} was evicted or never created."
        )
        self.object_id = object_id


class _StoreStats(ctypes.Structure):
    _fields_ = [
        ("capacity", ctypes.c_uint64),
        ("bytes_in_use", ctypes.c_uint64),
        ("num_objects", ctypes.c_uint64),
        ("num_evictions", ctypes.c_uint64),
    ]


def _load_lib():
    from ray_tpu_torch.native.build import lib_path

    lib = ctypes.CDLL(lib_path())
    lib.rt_store_init.restype = ctypes.c_int
    lib.rt_store_init.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]
    lib.rt_store_attach.restype = ctypes.c_void_p
    lib.rt_store_attach.argtypes = [ctypes.c_char_p]
    lib.rt_store_detach.argtypes = [ctypes.c_void_p]
    lib.rt_create.restype = ctypes.c_int
    lib.rt_create.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.rt_create_opts.restype = ctypes.c_int
    lib.rt_create_opts.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
    ]
    lib.rt_seal.restype = ctypes.c_int
    lib.rt_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rt_get.restype = ctypes.c_int
    lib.rt_get.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.rt_release.restype = ctypes.c_int
    lib.rt_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rt_contains.restype = ctypes.c_int
    lib.rt_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rt_delete.restype = ctypes.c_int
    lib.rt_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rt_abort.restype = ctypes.c_int
    lib.rt_abort.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rt_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(_StoreStats)]
    return lib


_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        _lib = _load_lib()
    return _lib


_MADV_POPULATE_WRITE = 23  # linux 5.14+; not in the mmap module yet


def _prefault(path: str):
    """Materialize the arena's tmpfs pages up front (MADV_POPULATE_WRITE
    keeps contents intact, so it is safe to run concurrently with puts).
    Skipping this leaves first-touch page-fault zeroing on the put hot
    path — measured 1.8 GiB/s vs 5.3 GiB/s after prefault."""
    try:
        fd = os.open(path, os.O_RDWR)
        try:
            m = _mmap.mmap(fd, os.fstat(fd).st_size)
        finally:
            os.close(fd)
        try:
            m.madvise(_MADV_POPULATE_WRITE)
        finally:
            m.close()
    except (OSError, ValueError):
        pass  # old kernel / permissions: stay lazy


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def sweep_dead_store_files(shm_dir: str = "/dev/shm") -> list:
    """Reclaim store segments abandoned by crashed raylets.

    A segment's name embeds its creating raylet's pid
    (``rtt_store_<pid>_<hex>``, `raylet_main.py`); the raylet unlinks it
    on clean shutdown, but SIGKILL / OOM-kill / a segfault skips that —
    and a shm file nobody will ever unlink eats host memory forever.
    Every raylet sweeps at startup: any segment whose creator pid is
    gone is garbage by construction (live raylets' pids still exist, so
    their segments are never touched).  Returns the removed paths."""
    import shutil

    removed = []
    try:
        names = os.listdir(shm_dir)
    except OSError:
        return removed
    for name in names:
        if not name.startswith("rtt_store_") or name.endswith(".spill"):
            continue
        parts = name.split("_")
        try:
            pid = int(parts[2])
        except (IndexError, ValueError):
            continue
        if _pid_alive(pid):
            continue
        path = os.path.join(shm_dir, name)
        try:
            os.unlink(path)
        except OSError:
            continue
        shutil.rmtree(path + ".spill", ignore_errors=True)
        removed.append(path)
    return removed


def create_store_file(path: str, capacity_bytes: int, table_cap: int = 1 << 16):
    rc = _get_lib().rt_store_init(path.encode(), capacity_bytes, table_cap)
    if rc != 0:
        raise OSError(-rc, f"rt_store_init({path}) failed")
    # Background: ~0.5 ms/MB; don't block init on it.
    import threading

    threading.Thread(target=_prefault, args=(path,), daemon=True,
                     name="store-prefault").start()


class ShmObjectStore:
    """A client connection (attach) to a shm store file.

    Overflow spilling (reference: `src/ray/raylet/local_object_manager.h:41`
    ``SpillObjectUptoMaxThroughput``): when the arena cannot fit a new
    object, its bytes go to a per-store spill DIRECTORY on disk and reads
    restore them transparently (mmap + zero-copy deserialize).  The
    serverless-store design moves spilling into the writing client — no
    IO-worker processes — with the spill dir shared by every client of
    the store file."""

    def __init__(self, path: str, spill_dir: Optional[str] = None):
        self._path = path
        self._lib = _get_lib()
        # Serializes close() against native calls from data-plane threads
        # (serve/receive): a check-then-act on _handle alone could pass a
        # NULL/freed handle into C during raylet shutdown.
        self._close_lock = make_lock("object_store.close")
        self._handle = self._lib.rt_store_attach(path.encode())  # guard: _close_lock
        if not self._handle:
            raise OSError(f"cannot attach to object store at {path}")
        fd = os.open(path, os.O_RDWR)
        try:
            size = os.fstat(fd).st_size
            self._mmap = _mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self._view = memoryview(self._mmap)
        self._spill_dir = spill_dir or (path + ".spill")

    # -- spill plane ----------------------------------------------------------

    def _spill_path(self, object_id: ObjectID) -> str:
        return os.path.join(self._spill_dir, object_id.hex())

    def spill(self, object_id: ObjectID, ser: "serialization.SerializedObject"):
        """Write a serialized object to the spill dir (atomic rename)."""
        buf = bytearray(ser.total_bytes())
        ser.write_into(memoryview(buf))
        self.spill_raw(object_id, buf)

    def spill_raw(self, object_id: ObjectID, data):
        os.makedirs(self._spill_dir, exist_ok=True)
        # Per-process counter in the tmp name: a pid-only suffix collides
        # when two THREADS of one process spill the same object
        # concurrently (one writer truncates the file under the other).
        tmp = (self._spill_path(object_id)
               + f".tmp{os.getpid()}.{next(_spill_tmp_seq)}")
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, self._spill_path(object_id))

    def has_spilled(self, object_id: ObjectID) -> bool:
        return os.path.exists(self._spill_path(object_id))

    def read_spilled(self, object_id: ObjectID):
        """Deserialize straight off a file mapping (buffers alias the map;
        the finalizer keeps it alive like the shm path does)."""
        import weakref

        try:
            fd = os.open(self._spill_path(object_id), os.O_RDONLY)
        except OSError:
            # raced a free()/delete() between has_spilled and open
            raise ObjectLostError(object_id) from None
        try:
            m = _mmap.mmap(fd, 0, prot=_mmap.PROT_READ)
        finally:
            os.close(fd)
        value = serialization.deserialize(memoryview(m))

        def _close(mm=m):
            try:
                mm.close()
            except BufferError:
                pass  # a view still aliases the map (interpreter exit)

        try:
            weakref.finalize(value, _close)
        except TypeError:
            pass  # scalar/container: mapping lives until GC of m
        return value

    # -- raw byte-level API ---------------------------------------------------

    def create(self, object_id: ObjectID, size: int,
               allow_evict: bool = True) -> memoryview:
        off = ctypes.c_uint64()
        with self._close_lock:
            if not self._handle:
                raise ObjectStoreFullError("store is closed")
            rc = self._lib.rt_create_opts(self._handle, object_id.binary(),
                                          size, ctypes.byref(off),
                                          1 if allow_evict else 0)
        if rc == -17:  # EEXIST
            raise FileExistsError(object_id.hex())
        if rc != 0:
            raise ObjectStoreFullError(
                f"cannot allocate {size} bytes for {object_id.hex()} (rc={rc})"
            )
        return self._view[off.value : off.value + size]

    def seal(self, object_id: ObjectID):
        with self._close_lock:
            if self._handle:
                self._lib.rt_seal(self._handle, object_id.binary())

    def release(self, object_id: ObjectID):
        with self._close_lock:
            if self._handle:
                self._lib.rt_release(self._handle, object_id.binary())

    def abort(self, object_id: ObjectID):
        with self._close_lock:
            if self._handle:
                self._lib.rt_abort(self._handle, object_id.binary())

    def get_buffer(self, object_id: ObjectID) -> Optional[memoryview]:
        """Pin + return buffer view, or None if absent/unsealed."""
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        with self._close_lock:
            if not self._handle:  # closed (raylet shutdown) — data-plane
                return None       # serve threads may race one request in
            rc = self._lib.rt_get(self._handle, object_id.binary(),
                                  ctypes.byref(off), ctypes.byref(size))
            if rc != 0:
                return None
            return self._view[off.value : off.value + size.value]

    def contains(self, object_id: ObjectID) -> bool:
        with self._close_lock:
            if not self._handle:
                return False
            return bool(self._lib.rt_contains(self._handle,
                                              object_id.binary()))

    def delete(self, object_id: ObjectID) -> bool:
        with self._close_lock:
            ok = bool(self._handle) and \
                self._lib.rt_delete(self._handle, object_id.binary()) == 0
        try:
            os.unlink(self._spill_path(object_id))
            ok = True
        except OSError:
            pass
        return ok

    def stats(self) -> dict:
        st = _StoreStats()
        with self._close_lock:
            if self._handle:
                self._lib.rt_stats(self._handle, ctypes.byref(st))
        return {
            "capacity": st.capacity,
            "bytes_in_use": st.bytes_in_use,
            "num_objects": st.num_objects,
            "num_evictions": st.num_evictions,
        }

    # -- object-level API -----------------------------------------------------

    def put_serialized(self, object_id: ObjectID,
                       ser: serialization.SerializedObject,
                       spill_ok: Optional[bool] = None):
        if spill_ok is None:
            spill_ok = config.object_store_spill
        try:
            # spilling mode never LRU-evicts sealed data: the NEW object
            # overflows to disk instead (no silent loss)
            buf = self.create(object_id, ser.total_bytes(),
                              allow_evict=not spill_ok)
        except ObjectStoreFullError:
            if not spill_ok:
                raise
            self.spill(object_id, ser)
            return
        try:
            ser.write_into(buf)
        except BaseException:
            del buf
            self.abort(object_id)
            raise
        del buf
        self.seal(object_id)
        self.release(object_id)

    def put(self, object_id: ObjectID, value: Any):
        self.put_serialized(object_id, serialization.serialize(value))

    def get(self, object_id: ObjectID, timeout: Optional[float] = None,
            known_sealed: bool = True) -> Any:
        """Deserialize an object; blocks until sealed (bounded by timeout).

        ``known_sealed``: the caller learned from the raylet that the object
        was sealed here — so absence means it was EVICTED (LRU), and we raise
        ObjectLostError immediately instead of polling forever.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 0.0005
        while True:
            buf = self.get_buffer(object_id)
            if buf is None and not self.contains(object_id) \
                    and self.has_spilled(object_id):
                return self.read_spilled(object_id)
            if buf is None and known_sealed and not self.contains(object_id):
                raise ObjectLostError(object_id)
            if buf is not None:
                try:
                    value = serialization.deserialize(buf)
                except BaseException:
                    del buf
                    self.release(object_id)
                    raise
                if value is None or isinstance(value, (bool, int, float, str, bytes)):
                    # Immutable scalars can't alias shm buffers: unpin now.
                    del buf
                    self.release(object_id)
                else:
                    try:
                        weakref.finalize(value, self.release, object_id)
                    except TypeError:
                        # Containers (tuple/dict/list) aren't weakref-able:
                        # release now; the mapping stays valid so views can
                        # never fault, they just become evictable.
                        del buf
                        self.release(object_id)
                return value
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(f"object {object_id.hex()} not ready")
            time.sleep(delay)
            delay = min(delay * 2, 0.01)

    def close(self):
        with self._close_lock:
            if self._handle:
                self._view.release()
                self._mmap.close()
                self._lib.rt_store_detach(self._handle)
                self._handle = None


class InProcObjectStore:
    """Pure-Python fallback store (used by local_mode and unit tests)."""

    def __init__(self):
        self._objects = {}

    def put(self, object_id: ObjectID, value: Any):
        self._objects[object_id] = serialization.dumps(value)

    def put_serialized(self, object_id, ser):
        self._objects[object_id] = ser.to_bytes()

    def get(self, object_id: ObjectID, timeout: Optional[float] = None,
            known_sealed: bool = True) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        while object_id not in self._objects:
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(f"object {object_id.hex()} not ready")
            time.sleep(0.001)
        return serialization.loads(self._objects[object_id])

    def contains(self, object_id: ObjectID) -> bool:
        return object_id in self._objects

    def delete(self, object_id: ObjectID) -> bool:
        return self._objects.pop(object_id, None) is not None

    def stats(self) -> dict:
        return {
            "capacity": 0,
            "bytes_in_use": sum(len(v) for v in self._objects.values()),
            "num_objects": len(self._objects),
            "num_evictions": 0,
        }

    def close(self):
        self._objects.clear()
