"""Unique identifiers for jobs, tasks, actors, objects, nodes.

Design notes (vs reference `src/ray/common/id.h`): the reference derives
ObjectIDs from the owning TaskID plus a return-index so that ownership can be
recovered from the ID alone.  We keep that property: an ``ObjectID`` is the
16-byte TaskID of the task that created it concatenated with a 4-byte
little-endian index.  ``put`` objects use a per-worker synthetic "put task" id.

All IDs are immutable value types backed by ``bytes`` and are cheap to hash,
compare, and ship over the wire.
"""

from __future__ import annotations

import os
import random
import struct
import threading

_JOB_ID_SIZE = 4
_UNIQUE_ID_SIZE = 16
_OBJECT_INDEX_SIZE = 4

# Process-local PRNG for ID minting.  ``os.urandom`` is a syscall per call
# (~14us on sandboxed/para-virtualized hosts — it was the single largest
# line in the task-submission profile at one TaskID per .remote()); a
# Mersenne generator seeded once per process from 32 urandom bytes keeps
# the same collision odds for our purposes (IDs only need uniqueness, not
# unpredictability) at ~0.5us per ID.  Forked children reseed via the
# at-fork hook (getpid is itself a syscall on these hosts, so no per-call
# pid check).
_rng: "random.Random | None" = None
_rng_lock = threading.Lock()


def _reseed():
    global _rng, _rng_lock
    _rng = None
    # The parent may have been mid-mint at fork time, leaving the copied
    # lock held forever in the child — replace it, don't just reseed.
    _rng_lock = threading.Lock()


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reseed)


def _random_bytes(n: int) -> bytes:
    global _rng
    with _rng_lock:
        if _rng is None:
            _rng = random.Random(os.urandom(32))
        return _rng.getrandbits(n * 8).to_bytes(n, "little")


class BaseID:
    __slots__ = ("_bytes", "_hash", "_hex")
    SIZE = _UNIQUE_ID_SIZE

    def __init__(self, binary: bytes):
        if not isinstance(binary, bytes) or len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {binary!r}"
            )
        self._bytes = binary
        self._hash = None  # computed lazily; ids key hot-path dicts
        self._hex = None  # ditto; task events / object tables key by hex

    @classmethod
    def from_random(cls) -> "BaseID":
        return cls(_random_bytes(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str) -> "BaseID":
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls) -> "BaseID":
        return cls(b"\x00" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        h = self._hex
        if h is None:
            h = self._hex = self._bytes.hex()
        return h

    def __hash__(self):
        h = self._hash
        if h is None:
            h = self._hash = hash((type(self).__name__, self._bytes))
        return h

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __lt__(self, other):
        return self._bytes < other._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    SIZE = _JOB_ID_SIZE


class NodeID(BaseID):
    SIZE = _UNIQUE_ID_SIZE


class WorkerID(BaseID):
    SIZE = _UNIQUE_ID_SIZE


class ActorID(BaseID):
    SIZE = _UNIQUE_ID_SIZE


class PlacementGroupID(BaseID):
    SIZE = _UNIQUE_ID_SIZE


class FunctionID(BaseID):
    SIZE = _UNIQUE_ID_SIZE


class TaskID(BaseID):
    SIZE = _UNIQUE_ID_SIZE


class ObjectID(BaseID):
    """TaskID (16 bytes) + return index (4 bytes LE)."""

    SIZE = _UNIQUE_ID_SIZE + _OBJECT_INDEX_SIZE

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + struct.pack("<I", index))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:_UNIQUE_ID_SIZE])

    def return_index(self) -> int:
        return struct.unpack("<I", self._bytes[_UNIQUE_ID_SIZE:])[0]


# Convenient alias matching the public API name.
ObjectRefID = ObjectID


class _PutCounter:
    """Per-process counter used to mint ObjectIDs for ``put`` calls."""

    def __init__(self):
        self._lock = threading.Lock()
        self._task_id = TaskID.from_random()
        self._index = 0

    def next_object_id(self) -> ObjectID:
        with self._lock:
            self._index += 1
            if self._index >= 2**32 - 1:
                self._task_id = TaskID.from_random()
                self._index = 1
            return ObjectID.for_task_return(self._task_id, self._index)


put_counter = _PutCounter()
