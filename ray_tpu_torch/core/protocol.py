"""Control-plane wire protocol: length-prefixed pickled frames over unix
sockets.

Reference analogue: Ray uses gRPC for worker<->raylet control
(`node_manager.proto`) and a unix socket with flatbuffers for the local
raylet connection (`src/ray/raylet/format/node_manager.fbs`).  Single-node
round 1 uses one unix stream socket per worker; the multi-node transport
(gRPC across hosts) slots in behind the same message schema.

BULK DATA does not ride this protocol: raylet-to-raylet object bytes move
on a dedicated per-peer-pair TCP connection with a raw binary header
format (see ``data_channel.py``) so control frames never queue behind
megabytes of payload.  Only the python-fallback pull path (and inline
objects) still ship object bytes as pickled control frames.

Message = arbitrary picklable dict with a "t" (type) key.  Types:

driver->worker:
  task          {spec: TaskSpec, arg_values: {hex: bytes}}   dispatch
  reply         {rid, ok, value|error}                       response to a request
  shutdown      {}

worker->driver:
  register      {pid, worker_id, direct_addr}
  done          {task_id, ok, inline: {hex: bytes}, stored: [hex], error}
  direct_done   done + {spec} — bookkeeping for a call whose result already
                reached the caller over a direct channel
  direct_notes  {notes: [direct_running|direct_done, ...]} — one coalesced
                train of direct bookkeeping notes (burst mode), applied in
                order raylet-side
  submit        {spec}                                       nested submission
  request       {rid, op, ...}  ops: get / wait / put_inline / kv_get / kv_put /
                actor_handle / named_actor / submit_sync / log /
                direct_lookup / direct_lease / direct_lease_release

raylet->worker (direct-transport control):
  direct_lease  {lease_id|None}  lease token grant/release — the worker's
                DirectServer rejects lease hellos presenting any other id
  direct_fence  {actor_ids, node_id}  tear down matching direct channels

direct channel (caller worker <-> callee worker, core/direct.py — the
raylet is NOT on this path; it only brokered the address):
  dhello        {caller, actor_id|None, generation, incarnation, lease_id}
  dhello_ack    {ok, reason, pid}      generation/incarnation fencing verdict
  dcall         {spec}                 FIFO per channel; dep-free specs only
  dburst        {calls: [dcall|dcancel, ...]}  one coalesced submit flush
                window (burst mode) — pickled as a single frame so shared
                spec strings are memoized across the burst; unpacked in
                order at the callee
  dresult       {task_id, ok, inline, stored, sizes, error, rejected?,
                 dur?}  dur = callee decode→result turnover (burst mode),
                the caller's lease-pipelining evidence
  dcancel       {task_id}              cancel a call submitted on this
                channel (pre-exec mark / mid-exec interrupt)

Codec layer: framing (scan on receive, coalesced assembly on send) is a
pluggable codec.  The default is a native library
(`ray_tpu_torch/native/src/frame_codec.cc`, same hermetic g++ + ctypes recipe as
the shm object store) that returns every complete frame's boundaries in ONE
GIL-cheap call per socket-readiness event; a byte-identical pure-Python
codec is selected automatically when the native build is unavailable, or
forced with ``RAY_TPU_DISABLE_NATIVE_CODEC=1``.  The reference pays the
equivalent cost in GIL-released Cython (`_raylet.pyx:3111`).
"""

from __future__ import annotations

import pickle
import socket
import struct
from typing import Any, Callable, List, Optional, Tuple

from ray_tpu_torch.core.config import config

config.define("disable_native_codec", bool, False,
              "Force the pure-Python frame codec even when the native "
              "library is available (parity tests, debugging).  Consumed "
              "once, when the codec singleton is built at import.")

_LEN = struct.Struct("<Q")
_HDR = _LEN.size

# Stream-corruption guard: a frame claiming more than this is a desynced or
# hostile peer, not a real message (inline objects cap at ~100KB, pull
# chunks at a few MB; the biggest legitimate frames are runtime-env
# working-dir zips riding KV puts).  Matches the reference's 512MB gRPC
# message ceiling — low enough that a corrupt length prefix is rejected
# BEFORE recv_exact allocates a receive buffer for it.  Both codecs
# reject identically.
MAX_FRAME_BYTES = 1 << 29


class ProtocolError(RuntimeError):
    """Framing-level corruption (oversized length prefix).  The connection
    that produced it must be torn down — the stream cannot resync."""


# ---------------------------------------------------------------------------
# Codecs: scan (receive side) and encode (send side).  Both produce/consume
# byte-identical streams; tests/test_protocol_codec.py fuzzes the parity.


class PythonCodec:
    """Pure-Python fallback — also the reference semantics for the tests."""

    name = "python"

    @staticmethod
    def scan(view, length: int) -> Tuple[List[Tuple[int, int]], int]:
        """Return ([(payload_off, payload_len), ...], consumed) for every
        complete frame in ``view[:length]``.  ``view`` is any object
        supporting ``unpack_from`` access (bytes/bytearray/memoryview)."""
        frames: List[Tuple[int, int]] = []
        pos = 0
        unpack_from = _LEN.unpack_from
        while length - pos >= _HDR:
            (flen,) = unpack_from(view, pos)
            if flen > MAX_FRAME_BYTES:
                raise ProtocolError(
                    f"frame length {flen} exceeds {MAX_FRAME_BYTES}")
            if length - pos - _HDR < flen:
                break
            frames.append((pos + _HDR, flen))
            pos += _HDR + flen
        return frames, pos

    @staticmethod
    def encode(payloads: List[bytes]) -> bytes:
        pack = _LEN.pack
        parts: List[bytes] = []
        for data in payloads:
            parts.append(pack(len(data)))
            parts.append(data)
        return b"".join(parts)


class NativeCodec:
    """ctypes wrapper over librt_codec.so (see frame_codec.cc)."""

    name = "native"

    def __init__(self, path: str):
        import ctypes

        self._ctypes = ctypes
        lib = ctypes.CDLL(path)
        lib.rtc_scan.restype = ctypes.c_longlong
        lib.rtc_scan.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.rtc_encode.restype = ctypes.c_longlong
        lib.rtc_encode.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
        ]
        self._lib = lib
        self._cap = 512

    def scan(self, view, length: int) -> Tuple[List[Tuple[int, int]], int]:
        ctypes = self._ctypes
        if isinstance(view, bytearray):
            # Zero-copy: a live export on the bytearray held only for the
            # duration of this call (the caller compacts after we return).
            arr = (ctypes.c_char * length).from_buffer(view)
        else:
            if isinstance(view, memoryview):
                view = bytes(view[:length])
            arr = (ctypes.c_char * length).from_buffer_copy(view[:length])
        addr = ctypes.addressof(arr)
        cap = self._cap
        frames: List[Tuple[int, int]] = []
        base = 0
        offs = (ctypes.c_uint64 * cap)()
        lens = (ctypes.c_uint64 * cap)()
        consumed = ctypes.c_uint64()
        while True:
            got = self._lib.rtc_scan(
                addr + base, length - base, MAX_FRAME_BYTES, offs, lens,
                cap, ctypes.byref(consumed))
            if got < 0:
                raise ProtocolError(
                    f"frame length exceeds {MAX_FRAME_BYTES}")
            for i in range(got):
                frames.append((base + offs[i], lens[i]))
            base += consumed.value
            if got < cap:
                del arr  # release the bytearray export
                return frames, base

    # Below this total the ctypes argument marshalling costs more than it
    # saves; bytes.join is one C-level pass and wins.  Measured on the dev
    # host: join ahead up to 64KB-frame batches (16x64KB = 1MB total took
    # 221us join vs 136us native), native ~3x faster at 1MB frames.  256KB
    # sits past the measured break-even with margin so small control
    # trains never pay the marshalling overhead.
    _NATIVE_ENCODE_MIN_BYTES = 256 << 10

    def encode(self, payloads: List[bytes]):
        n = len(payloads)
        total = _HDR * n
        for data in payloads:
            total += len(data)
        if total < self._NATIVE_ENCODE_MIN_BYTES:
            return PythonCodec.encode(payloads)
        ctypes = self._ctypes
        out = bytearray(total)
        ptrs = (ctypes.c_char_p * n)(*payloads)
        lens = (ctypes.c_uint64 * n)()
        for i, data in enumerate(payloads):
            lens[i] = len(data)
        dest = (ctypes.c_char * total).from_buffer(out)
        wrote = self._lib.rtc_encode(
            ptrs, lens, n, ctypes.addressof(dest), total)
        del dest  # release the bytearray export before handing `out` off
        if wrote != total:
            raise ProtocolError("native encode overflow (codec bug)")
        return out


def _select_codec():
    if config.disable_native_codec:
        return PythonCodec()
    from ray_tpu_torch.native.build import try_lib_path

    path = try_lib_path("codec")
    if path is None:
        return PythonCodec()
    try:
        return NativeCodec(path)
    except OSError:
        return PythonCodec()


_codec = _select_codec()
NATIVE_CODEC_ACTIVE = _codec.name == "native"


# ---------------------------------------------------------------------------
# Send side


def send_msg(sock: socket.socket, msg: Any, lock=None):
    data = pickle.dumps(msg, protocol=5)
    frame = _LEN.pack(len(data)) + data
    if lock is not None:
        with lock:
            # blocking-ok: the caller-passed lock exists to serialize
            # writers on this one socket (frame integrity); it guards no
            # other state, so nothing else can queue behind the send.
            sock.sendall(frame)
    else:
        sock.sendall(frame)


def send_msgs(sock: socket.socket, msgs, lock=None):
    """Coalesce many frames into ONE sendall.

    The receiver's frame scanner parses length-prefixed frames one at a
    time, so coalescing is invisible to it.  The point is the syscall
    count: on a busy host each sendall to a blocked peer costs a scheduler
    wakeup (~100us measured on a contended 1-vCPU box) — one write for a
    16-task dispatch batch pays that once instead of 16 times.  The frame
    assembly itself (headers + payload memcpy) runs in the native codec
    when available."""
    if not msgs:
        return
    payloads = [pickle.dumps(msg, protocol=5) for msg in msgs]
    frame = _codec.encode(payloads)
    if lock is not None:
        with lock:
            # blocking-ok: per-socket write-serialization lock (see
            # send_msg above); guards no other state.
            sock.sendall(frame)
    else:
        sock.sendall(frame)


def encode_frames(payloads: List[bytes]):
    """Assemble pre-pickled payloads into one wire buffer (codec-routed)."""
    return _codec.encode(payloads)


# ---------------------------------------------------------------------------
# Receive side


def drain_frames(buf: bytearray, handle, alive) -> None:
    """Handle every complete length-prefixed frame in ``buf`` (the
    receive-side counterpart of send_msgs' coalescing); stops early —
    leaving the rest buffered — when ``alive()`` goes false, so a handler
    may kill or repurpose the connection mid-train.

    One codec scan finds every frame boundary up front; payloads are
    unpickled straight out of a memoryview (no per-frame bytes() copy) and
    the buffer is compacted ONCE per drain (the old per-frame
    ``del buf[:k]`` was an O(buffer) memmove each time — quadratic under
    coalesced bursts)."""
    frames, _ = _codec.scan(buf, len(buf))
    if not frames:
        return
    consumed = 0
    mv = memoryview(buf)
    try:
        for off, flen in frames:
            if not alive():
                break
            # A frame counts as consumed once parsed, even if its handler
            # raises (matches the old semantics: a poison message never
            # re-delivers).
            consumed = off + flen
            msg = pickle.loads(mv[off:off + flen])
            handle(msg)
    finally:
        mv.release()
        del buf[:consumed]


def recv_exact(sock: socket.socket, n: int) -> Optional[bytearray]:
    """Read exactly n bytes via recv_into on one preallocated buffer (one
    allocation per message instead of per-chunk bytes + b"".join)."""
    out = bytearray(n)
    view = memoryview(out)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:])
        if r == 0:
            return None
        got += r
    return out


def recv_into_exact(sock: socket.socket, view: memoryview) -> bool:
    """Fill ``view`` completely via recv_into; False on EOF.  Shared by the
    control-plane readers and the zero-copy data channel (which recv_intos
    straight into shm store buffers — see data_channel.py)."""
    got, n = 0, len(view)
    while got < n:
        r = sock.recv_into(view[got:])
        if r == 0:
            return False
        got += r
    return True


def liveness_ping(address, node_id: str, incarnation: int,
                  timeout: float) -> bool:
    """Dial a raylet control listener and verify a ping/pong identity
    echo: the pong must carry the expected node_id AND incarnation — a
    recycled port answering, or an older incarnation of the node, is not
    liveness.  One blocking dial+roundtrip bounded by ``timeout``; shared
    by the GCS's direct probe and the peer-relayed indirect probe so the
    two verdicts can never diverge."""
    timeout = max(0.05, timeout)
    try:
        with socket.create_connection(tuple(address),
                                      timeout=timeout) as sock:
            sock.settimeout(timeout)
            send_msg(sock, {"t": "ping"})
            reply = recv_msg(sock)
    except (OSError, ProtocolError):
        return False
    return (isinstance(reply, dict) and reply.get("t") == "pong"
            and reply.get("node_id") == node_id
            and reply.get("incarnation") == incarnation)


def recv_msg(sock: socket.socket) -> Optional[Any]:
    header = recv_exact(sock, _HDR)
    if header is None:
        return None
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame length {length} exceeds {MAX_FRAME_BYTES}")
    data = recv_exact(sock, length)
    if data is None:
        return None
    return pickle.loads(data)


class FrameReader:
    """Buffered blocking message reader for dedicated reader threads
    (worker <- raylet, GCS server/client loops).

    ``recv_msg`` on a coalesced train previously cost two syscalls and two
    allocations PER MESSAGE (header read + payload read + join).  This
    reader recvs into one reusable chunk, scans every complete frame with
    the codec, and decodes the whole train — so an N-message burst costs
    ~1 syscall, and only partial tails are ever copied into the carry
    buffer."""

    __slots__ = ("_sock", "_chunk", "_buf", "_pending")

    def __init__(self, sock: socket.socket, chunk_size: int = 1 << 20):
        self._sock = sock
        self._chunk = bytearray(chunk_size)
        self._buf = bytearray()  # partial-frame carry
        from collections import deque

        self._pending = deque()

    def _decode(self, view, frames) -> None:
        loads = pickle.loads
        append = self._pending.append
        for off, flen in frames:
            append(loads(view[off:off + flen]))

    def recv_msg(self) -> Optional[Any]:
        """Next message, or None on EOF."""
        if self._pending:
            return self._pending.popleft()
        while True:
            try:
                n = self._sock.recv_into(self._chunk)
            except OSError:
                return None
            if n == 0:
                return None
            if not self._buf:
                # Fast path: scan the fresh chunk in place; only a trailing
                # partial frame (if any) is copied into the carry buffer.
                frames, consumed = _codec.scan(self._chunk, n)
                if frames:
                    self._decode(memoryview(self._chunk), frames)
                if consumed < n:
                    self._buf += memoryview(self._chunk)[consumed:n]
            else:
                self._buf += memoryview(self._chunk)[:n]
                frames, consumed = _codec.scan(self._buf, len(self._buf))
                if frames:
                    mv = memoryview(self._buf)
                    try:
                        self._decode(mv, frames)
                    finally:
                        mv.release()
                    del self._buf[:consumed]
            if self._pending:
                return self._pending.popleft()
