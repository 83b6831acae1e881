"""Zero-copy raylet-to-raylet data plane.

A DEDICATED TCP connection per peer pair carries bulk object bytes so
control traffic (heartbeats, task dispatch, done messages) never queues
behind megabytes of data frames — the reference runs object transfer as
chunked gRPC streams on the object manager's own channel pool
(`src/ray/object_manager/object_manager.h:117`), separate from the raylet's
control RPCs.

Wire format (little-endian, NO pickle anywhere on this channel):

  connect preamble   8 bytes  b"RTDP\\x02\\0\\0\\0"
  hello (pull side -> holder)      _HELLO: incarnation u64 | node_id 32s
      identity + fencing: a channel presenting an incarnation the cluster
      declared dead is refused (split-brain guard — a resurrected
      partitioned node must re-register before it may move bytes)
  request  (pull side -> holder)   _REQ:  op u8 | rid u64 | offset u64 |
                                          length u64 | object_id 20s
      op 1 = META   (offset/length ignored; reply carries the total size)
      op 2 = READ   (stream bytes [offset, offset+length) back)
  response (holder -> pull side)   _RESP: flags u8 | rid u64 | offset u64 |
                                          length u64 | [payload length bytes]
      flags 0 = DATA (payload = the requested range, complete)
            1 = META (length = total object size, no payload)
            2 = ERR  (payload = UTF-8 error message)

Zero copies end to end: the serving side writes straight off a pinned
``memoryview`` of the shm arena via ``sendmsg`` (spilled objects via
``os.sendfile``), and the receiving side ``recv_into``s directly into the
destination ``store.create()`` buffer — no ``bytes()`` slicing, no pickle
frame, no intermediate bytearray.

The channel is deliberately dumb: all policy (admission, striping across
holders, retry/rotation) lives in ``ray_tpu_torch/core/pull_manager.py``.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
from typing import Callable, Dict, Optional, Tuple

from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.protocol import recv_exact as _recv_exact
from ray_tpu_torch.core.protocol import recv_into_exact
from ray_tpu_torch.util import chaos as _chaos
from ray_tpu_torch.util.locks import make_lock

MAGIC = b"RTDP\x02\x00\x00\x00"

_REQ = struct.Struct("<BQQQ20s")
_RESP = struct.Struct("<BQQQ")
# connection hello: the pull side's identity + registration incarnation
# (node_id as 32 hex bytes; fencing input for the serving side)
_HELLO = struct.Struct("<Q32s")

OP_META = 1
OP_READ = 2

FLAG_DATA = 0
FLAG_META = 1
FLAG_ERR = 2

# sendfile granularity for spilled objects (bounds one syscall's worth of
# disk->socket work; the kernel loops internally anyway).
_SENDFILE_CHUNK = 8 << 20


def _send_header_and_view(sock: socket.socket, header: bytes, view) -> None:
    """One gather write for header + payload (``sendmsg``), falling back to
    a plain loop on partial sends.  ``view`` aliases the shm arena — the
    kernel copies straight out of the store, no user-space staging."""
    total = len(header) + len(view)
    sent = sock.sendmsg([header, view])
    if sent == total:
        return
    # Partial send (full socket buffer): finish with sendall on the rest.
    if sent < len(header):
        sock.sendall(header[sent:])
        sock.sendall(view)
    else:
        sock.sendall(view[sent - len(header):])


class DataServer:
    """Accepts peer data connections and serves META/READ requests straight
    from this node's shm store (or its spill directory).

    Each accepted connection gets one daemon thread (bounded by cluster
    size: peers keep ONE data connection per pair).  Serving never touches
    raylet event-thread state — only the thread-safe store client — so a
    slow or stalled peer can never head-of-line-block the control plane.
    """

    def __init__(self, node_ip: str, store_fn: Callable[[], object],
                 fence_fn: Optional[Callable[[str, int], bool]] = None):
        """``fence_fn(node_id, incarnation) -> bool``: incarnation-fencing
        check for the connect hello — False refuses the connection (the
        peer presented an incarnation that was declared dead)."""
        self._store_fn = store_fn
        self._fence_fn = fence_fn
        self._listener = socket.create_server((node_ip, 0), backlog=32)
        self.port = self._listener.getsockname()[1]
        self._conns: Dict[int, socket.socket] = {}  # guard: _lock
        self._lock = make_lock("data_server.conns")
        self._closed = False
        # Test seam: per-READ artificial delay (lets tests kill a holder
        # deterministically "mid-stream").
        self.serve_delay_s = 0.0
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="data-accept", daemon=True)
        self._accept_thread.start()

    # ---- accept / serve ---------------------------------------------------

    def _accept_loop(self):
        while not self._closed:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            with self._lock:
                if self._closed:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    return
                self._conns[sock.fileno()] = sock
            threading.Thread(target=self._serve_conn, args=(sock,),
                             name="data-serve", daemon=True).start()

    def _serve_conn(self, sock: socket.socket):
        key = sock.fileno()
        blackholed = False  # chaos partition: requests drain, replies vanish
        try:
            magic = _recv_exact(sock, len(MAGIC))
            if magic is None or bytes(magic) != MAGIC:
                return
            hello = _recv_exact(sock, _HELLO.size)
            if hello is None:
                return
            incarnation, peer_id_raw = _HELLO.unpack(bytes(hello))
            peer_id = peer_id_raw.rstrip(b"\x00").decode("ascii", "replace")
            if (self._fence_fn is not None
                    and not self._fence_fn(peer_id, incarnation)):
                return  # fenced incarnation: refuse to move bytes for it
            while not self._closed:
                hdr = _recv_exact(sock, _REQ.size)
                if hdr is None:
                    return
                op, rid, offset, length, oid_bytes = _REQ.unpack(bytes(hdr))
                oid = ObjectID(oid_bytes)
                if not blackholed:
                    fault = _chaos.net_fault("data", peer=peer_id,
                                             direction="in")
                    if fault == "blackhole":
                        blackholed = True
                    if fault is not None:
                        continue  # this response is swallowed by the chaos
                else:
                    continue
                if op == OP_META:
                    self._serve_meta(sock, rid, oid)
                elif op == OP_READ:
                    if self.serve_delay_s:
                        import time

                        time.sleep(self.serve_delay_s)
                    if self._closed:
                        return
                    self._serve_read(sock, rid, oid, offset, length)
                else:
                    self._send_err(sock, rid, f"unknown op {op}")
        except OSError:
            pass
        finally:
            with self._lock:
                self._conns.pop(key, None)
            try:
                sock.close()
            except OSError:
                pass

    def _send_err(self, sock, rid: int, msg: str):
        payload = msg.encode("utf-8", "replace")
        sock.sendall(_RESP.pack(FLAG_ERR, rid, 0, len(payload)) + payload)

    def _object_size(self, store, oid: ObjectID) -> Optional[int]:
        buf = store.get_buffer(oid)
        if buf is not None:
            try:
                return len(buf)
            finally:
                del buf
                store.release(oid)
        if store.has_spilled(oid):
            try:
                return os.stat(store._spill_path(oid)).st_size
            except OSError:
                return None
        return None

    def _serve_meta(self, sock, rid: int, oid: ObjectID):
        store = self._store_fn()
        size = self._object_size(store, oid) if store is not None else None
        if size is None:
            self._send_err(sock, rid, f"object {oid.hex()} not here")
            return
        sock.sendall(_RESP.pack(FLAG_META, rid, 0, size))

    def _serve_read(self, sock, rid: int, oid: ObjectID,
                    offset: int, length: int):
        store = self._store_fn()
        buf = store.get_buffer(oid) if store is not None else None
        if buf is not None:
            try:
                if offset + length > len(buf):
                    self._send_err(
                        sock, rid,
                        f"range [{offset},{offset + length}) out of bounds "
                        f"for {oid.hex()} ({len(buf)} bytes)")
                    return
                _send_header_and_view(
                    sock, _RESP.pack(FLAG_DATA, rid, offset, length),
                    buf[offset:offset + length])
            finally:
                del buf
                store.release(oid)
            return
        if store is not None and store.has_spilled(oid):
            self._serve_read_spilled(sock, rid, oid, offset, length, store)
            return
        self._send_err(sock, rid, f"object {oid.hex()} not here")

    def _serve_read_spilled(self, sock, rid: int, oid: ObjectID,
                            offset: int, length: int, store):
        try:
            fd = os.open(store._spill_path(oid), os.O_RDONLY)
        except OSError:
            self._send_err(sock, rid, f"object {oid.hex()} freed")
            return
        try:
            size = os.fstat(fd).st_size
            if offset + length > size:
                self._send_err(
                    sock, rid,
                    f"range [{offset},{offset + length}) out of bounds "
                    f"for spilled {oid.hex()} ({size} bytes)")
                return
            sock.sendall(_RESP.pack(FLAG_DATA, rid, offset, length))
            pos, remaining = offset, length
            while remaining > 0:
                try:
                    n = os.sendfile(sock.fileno(), fd, pos,
                                    min(remaining, _SENDFILE_CHUNK))
                except OSError:  # non-sendfile-able fs: plain read loop
                    with os.fdopen(os.dup(fd), "rb", closefd=True) as f:
                        f.seek(pos)
                        while remaining > 0:
                            data = f.read(min(remaining, _SENDFILE_CHUNK))
                            if not data:
                                raise OSError("spill file truncated")
                            sock.sendall(data)
                            pos += len(data)
                            remaining -= len(data)
                    return
                if n == 0:
                    raise OSError("sendfile returned 0")
                pos += n
                remaining -= n
        finally:
            os.close(fd)

    def close(self):
        self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass


class DataChannel:
    """Pull-side endpoint of one peer-pair data connection.

    ``request_range(rid, oid, offset, length, sink)`` registers a
    destination memoryview for ``rid`` and sends the READ; the receiver
    thread ``recv_into``s the response payload straight into that view.
    Events (data complete / meta / error / channel closed) are delivered
    via the ``on_event(channel, rid, kind, arg)`` callback FROM THE
    RECEIVER THREAD — the pull manager is responsible for its own locking
    and for hopping completions onto the raylet event loop.
    """

    def __init__(self, node_id: str, address: Tuple[str, int],
                 on_event: Callable[["DataChannel", Optional[int], str,
                                     object], None],
                 connect_timeout: float = 3.0,
                 identity: Optional[Tuple[str, int]] = None):
        """``identity``: this (pulling) node's ``(node_id, incarnation)``,
        sent in the connect hello for the server's fencing check."""
        self.node_id = node_id
        self._on_event = on_event
        self._sock = socket.create_connection(address,
                                              timeout=connect_timeout)
        self._sock.settimeout(None)
        try:
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        my_id, my_inc = identity or ("", 0)
        self._sock.sendall(MAGIC + _HELLO.pack(
            int(my_inc), my_id.encode("ascii", "replace")[:32].ljust(
                32, b"\x00")))
        self._send_lock = make_lock("data_channel.send")
        self._sinks: Dict[int, memoryview] = {}  # guard: _sinks_lock
        self._sinks_lock = make_lock("data_channel.sinks")
        self._chaos_blackholed = False
        self.alive = True
        self._recv_thread = threading.Thread(
            target=self._recv_loop, name=f"data-recv-{node_id[:8]}",
            daemon=True)
        self._recv_thread.start()

    # ---- requests (any thread) -------------------------------------------

    def request_meta(self, rid: int, oid: ObjectID) -> bool:
        return self._send(_REQ.pack(OP_META, rid, 0, 0, oid.binary()))

    def request_range(self, rid: int, oid: ObjectID, offset: int,
                      length: int, sink: Optional[memoryview]) -> bool:
        """``sink`` must be exactly ``length`` bytes (or None to receive
        into a throwaway buffer — used when the store had no room and the
        caller accumulates via on_event)."""
        if sink is not None:
            with self._sinks_lock:
                self._sinks[rid] = sink
        ok = self._send(_REQ.pack(OP_READ, rid, offset, length, oid.binary()))
        if not ok and sink is not None:
            with self._sinks_lock:
                self._sinks.pop(rid, None)
        return ok

    def cancel(self, rid: int):
        """Forget a rid: bytes that still arrive for it are drained and
        dropped (keeps the stream framing intact after a reassignment)."""
        with self._sinks_lock:
            self._sinks.pop(rid, None)

    def _send(self, data: bytes) -> bool:
        if not self.alive:
            return False
        if self._chaos_blackholed:
            return True  # partitioned: the request silently vanishes
        fault = _chaos.net_fault("data", peer=self.node_id)
        if fault is not None:
            if fault == "blackhole":
                self._chaos_blackholed = True
            # dropped request: the pull watchdog rotates/retries the range
            return True
        try:
            with self._send_lock:
                # blocking-ok: the send lock EXISTS to serialize writers on
                # this socket; requests are tiny (37B) and the receiver
                # drains continuously, so the buffer can't stay full.
                self._sock.sendall(data)
            return True
        except OSError:
            self.close()
            return False

    # ---- receiver thread --------------------------------------------------

    def _recv_loop(self):
        try:
            self._recv_loop_inner()
        except OSError:
            pass  # reset/shutdown: same as EOF
        self.close()
        self._on_event(self, None, "closed", None)

    def _recv_loop_inner(self):
        sock = self._sock
        scratch = None
        while True:
            hdr = _recv_exact(sock, _RESP.size)
            if hdr is None:
                break
            flags, rid, offset, length = _RESP.unpack(bytes(hdr))
            if flags == FLAG_META:
                self._on_event(self, rid, "meta", length)
                continue
            if flags == FLAG_ERR:
                payload = _recv_exact(sock, length)
                if payload is None:
                    break
                self._on_event(self, rid, "err",
                               bytes(payload).decode("utf-8", "replace"))
                continue
            # DATA: land the payload in the registered sink (zero-copy), or
            # drain it if the rid was cancelled/reassigned.
            with self._sinks_lock:
                sink = self._sinks.pop(rid, None)
            if sink is not None and len(sink) == length:
                if not recv_into_exact(sock, sink):
                    break
                self._on_event(self, rid, "data", (offset, length))
            else:
                if sink is not None:
                    # length mismatch: protocol desync — treat as fatal
                    self.close()
                    break
                if scratch is None or len(scratch) < min(length, 1 << 20):
                    scratch = bytearray(min(max(length, 1), 1 << 20))
                remaining = length
                ok = True
                view = memoryview(scratch)
                while remaining > 0:
                    n = min(remaining, len(scratch))
                    if not recv_into_exact(sock, view[:n]):
                        ok = False
                        break
                    remaining -= n
                if not ok:
                    break

    def close(self):
        self.alive = False
        # shutdown() BEFORE close(): a receiver thread blocked in recv()
        # holds its own reference to the socket, so a bare close() would
        # never wake it and the "closed" event (which drives range
        # reassignment and pull failure) would never fire.
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._sinks_lock:
            self._sinks.clear()

    def join_receiver(self, timeout: float = 1.0):
        """Wait for the receiver thread to exit (no-op from the receiver
        thread itself).  Used to quiesce writes into a destination buffer
        before its allocation is freed."""
        th = self._recv_thread
        if th is not threading.current_thread():
            th.join(timeout)
