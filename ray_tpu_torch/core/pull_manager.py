"""Pull manager: policy layer of the zero-copy data plane.

Reference analogue: ``PullManager`` (`src/ray/object_manager/pull_manager.h:52`)
— admission control over total in-flight pull bytes, dedup of concurrent
requests for one object, chunk pipelining, and retry with source rotation.
On top of the reference semantics this one stripes chunk ranges across
MULTIPLE holders when the directory lists more than one (the reference
pulls a whole object from a single picked location), rebalancing work-stealing
style: every source that finishes a range grabs the next unassigned one, so
a stalled source simply stops winning ranges.

Threading: ``request``/``on_node_dead``/``tick`` run on the raylet event
thread; range completions arrive on DataChannel receiver threads.  One lock
guards all state; completions hop back to the event loop via ``post``
(raylet.call_async) so ``_object_in_store`` and friends stay event-thread
only.
"""

from __future__ import annotations

import heapq
import itertools
import queue as _queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.data_channel import DataChannel
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.util.locks import make_lock
from ray_tpu_torch.util.retry import BackoffPolicy

config.define("data_dial_attempts", int, 3,
              "Connect attempts per holder when dialing a data channel "
              "(unified jittered-exponential backoff between attempts) "
              "before the holder is tombstoned off the data plane.")

config.define("pull_max_inflight_bytes", int, 256 << 20,
              "Admission cap on total bytes of in-flight object pulls "
              "(reference: RAY_object_manager_max_bytes_in_flight).  Pulls "
              "beyond the cap wait in a FIFO+priority queue (task-argument "
              "pulls ahead of get()/wait() prefetch).")
config.define("pull_stripe_bytes", int, 8 << 20,
              "Range granularity for data-plane pulls: the unit of "
              "multi-source striping and of pipelining within one source.")
config.define("pull_pipeline_depth", int, 2,
              "Outstanding ranges per source per pull (keeps the pipe full "
              "while a range lands).")
config.define("pull_range_timeout_s", float, 20.0,
              "A range in flight longer than this rotates to another "
              "holder (source stall detection); with no alternative the "
              "channel is dropped and the pull retries via the directory.")
config.define("pull_max_sources", int, 4,
              "Max holders one pull stripes across.")


class _Pull:
    __slots__ = ("oid", "size", "priority", "channels", "dest", "buf",
                 "created", "unassigned", "inflight", "done_bytes",
                 "bytes_by_source", "meta_rid", "meta_tried", "meta_t",
                 "meta_chan", "state", "started", "charged")

    def __init__(self, oid: ObjectID, size: int, priority: int):
        self.oid = oid
        self.size = size
        self.priority = priority
        self.charged = 0  # bytes charged against the admission cap
        self.channels: List[DataChannel] = []
        self.dest: Optional[memoryview] = None   # store.create() buffer
        self.buf: Optional[bytearray] = None     # store-full fallback
        self.created = False
        self.unassigned: List[Tuple[int, int]] = []  # (offset, length) LIFO
        # rid -> (channel, offset, length, start_time)
        self.inflight: Dict[int, Tuple[DataChannel, int, int, float]] = {}
        self.done_bytes = 0
        self.bytes_by_source: Dict[str, int] = {}
        self.meta_rid: Optional[int] = None
        self.meta_tried = 0
        self.meta_t = 0.0  # last META request time (stall watchdog)
        self.meta_chan: Optional[DataChannel] = None
        self.state = "queued"  # queued | dialing | meta | active
        self.started = time.monotonic()


class PullManager:
    def __init__(
        self,
        node_id: str,
        store_fn: Callable[[], object],
        data_addr_fn: Callable[[str], Optional[Tuple[str, int]]],
        post: Callable[..., None],
        on_done: Callable[[ObjectID], None],
        on_fail: Callable[[ObjectID, List[str]], None],
        hello_fn: Optional[Callable[[], Tuple[str, int]]] = None,
    ):
        """``data_addr_fn``: peer node_id -> (host, data_port) or None —
        called on the event thread at request time only.  ``post`` hops a
        closure onto the raylet event loop; ``on_done``/``on_fail`` are
        delivered through it.  ``hello_fn`` returns this node's
        ``(node_id, incarnation)`` — the identity every dialed data
        channel presents for the holder's incarnation-fencing check."""
        self.node_id = node_id
        self._store_fn = store_fn
        self._data_addr_fn = data_addr_fn
        self._post = post
        self._on_done = on_done
        self._on_fail = on_fail
        self._hello_fn = hello_fn
        self._lock = make_lock("pull_manager.state")
        # SUSPECT holders (failure-detector state from node_suspect pubsub):
        # new pulls put them last in line and active pulls rotate striped
        # ranges away from them — routing-only, nothing is torn down, so a
        # false suspicion costs a rebalance, not a failed pull.
        self._suspect: set = set()                   # guard: _lock
        self._rid = itertools.count(1)
        self._seq = itertools.count()
        self._pulls: Dict[ObjectID, _Pull] = {}      # guard: _lock
        self._queue: list = []                       # guard: _lock
        self._queued: Dict[ObjectID, _Pull] = {}     # guard: _lock
        self._rid_to_pull: Dict[int, _Pull] = {}     # guard: _lock
        self._channels: Dict[str, DataChannel] = {}  # guard: _lock
        self._inflight_bytes = 0                     # guard: _lock
        self._closed = False
        # Nodes with no dialable data channel (dial failed / no data_port):
        # node_id -> tombstone expiry.  Lets request() refuse synchronously
        # so the caller falls back to the control-plane path instead of
        # re-dialing a dead host on every retry.  Event thread (request) +
        # dialer thread (_dial) both touch it; entries are independent and
        # dict get/set/del are GIL-atomic, so it rides without the lock.
        self._no_data_plane: Dict[str, float] = {}
        # Blocking TCP dials run on a dedicated dialer thread — NEVER on
        # the raylet event thread (a blackholed holder would stall
        # heartbeats for a connect timeout and get this node declared
        # dead).
        self._dial_q: _queue.SimpleQueue = _queue.SimpleQueue()
        self._dialer_started = False
        # ---- cumulative stats (read by metrics flush + tests) ----
        self._bytes_total = 0                        # guard: _lock
        self._chunks_total = 0                       # guard: _lock
        self._source_switches = 0                    # guard: _lock
        self._multi_source_pulls = 0                 # guard: _lock
        self._completed = 0                          # guard: _lock
        self._failed = 0                             # guard: _lock
        self._last_completed: Optional[dict] = None  # guard: _lock

    # ------------------------------------------------------------- public

    def active(self, oid: ObjectID) -> bool:
        with self._lock:
            return oid in self._pulls or oid in self._queued

    def _dialable(self, node: str) -> bool:
        exp = self._no_data_plane.get(node)
        if exp is None:
            return True
        if time.monotonic() > exp:
            del self._no_data_plane[node]
            return True
        return False

    def request(self, oid: ObjectID, size: int, locations: List[str],
                priority: int = 1) -> bool:
        """Start (or queue) a pull.  Returns False when NO holder is
        reachable on the data plane (per the tombstone cache) — the caller
        falls back to the control-plane pull path.  Runs on the raylet
        event thread; TCP dials for not-yet-connected holders happen on
        the dialer thread."""
        if self._closed:
            return False
        locs = [n for n in locations if self._dialable(n)]
        if not locs:
            return False
        # SUSPECT holders sort last: still usable (a suspicion is not a
        # death), but healthy holders win the stripe assignments.
        # unguarded-ok: set membership is GIL-atomic; staleness only
        # affects ordering.
        locs.sort(key=lambda n: n in self._suspect)
        cap_src = max(1, config.pull_max_sources)
        need_dial = False
        with self._lock:
            if oid in self._pulls or oid in self._queued:
                # dedup; an arg-priority request bumps a queued prefetch
                # (fresh heap entry — the stale one pops as a no-op)
                queued = self._queued.get(oid)
                if queued is not None and priority < queued.priority:
                    queued.priority = priority
                    if queued.state == "queued":
                        heapq.heappush(self._queue,
                                       (priority, next(self._seq), oid))
                return True
            pull = _Pull(oid, max(0, size), priority)
            live = [self._channels[n] for n in locs[:cap_src]
                    if n in self._channels and self._channels[n].alive]
            if len(live) == len(locs[:cap_src]):
                # every holder already connected: straight to admission
                pull.channels = live
                self._queued[oid] = pull
                heapq.heappush(self._queue,
                               (priority, next(self._seq), oid))
                actions = self._admit_locked()
            else:
                # at least one holder needs a (blocking) dial: hand off
                pull.state = "dialing"
                self._queued[oid] = pull
                actions = []
                need_dial = True
        if actions:
            self._run_actions(actions)
        if need_dial:
            self._dial_q.put((oid, locs[:cap_src]))
            if not self._dialer_started:
                self._dialer_started = True
                threading.Thread(target=self._dialer_loop,
                                 name="pull-dialer", daemon=True).start()
        return True

    def _dialer_loop(self):
        while not self._closed:
            try:
                oid, locs = self._dial_q.get(timeout=5.0)
            except _queue.Empty:
                continue
            channels = self._dial(locs)
            with self._lock:
                pull = self._queued.get(oid)
                if pull is None or pull.state != "dialing":
                    continue
                pull.channels = [c for c in channels if c.alive]
                if not pull.channels:
                    del self._queued[oid]
                    self._failed += 1
                    fail = True
                    actions = []
                else:
                    fail = False
                    pull.state = "queued"
                    heapq.heappush(self._queue,
                                   (pull.priority, next(self._seq), oid))
                    actions = self._admit_locked()
            if fail:
                # tombstones are recorded by _dial; the raylet's retry will
                # see request() return False and use the fallback path
                self._post(self._on_fail, oid, [])
            else:
                self._run_actions(actions)

    def on_node_dead(self, node_id: str):
        with self._lock:
            chan = self._channels.get(node_id)
            self._suspect.discard(node_id)
        if chan is not None:
            chan.close()  # receiver thread delivers the "closed" event

    def _rotate_range_locked(self, pull, rid, chan, off, ln, others,
                             now, actions):  # requires: _lock
        """Reassign one in-flight range DIRECTLY to the least-loaded other
        holder (the generic assigner could hand the range straight back to
        the vacated slot) — temporarily exceeding its pipeline depth beats
        staying on a stalled/suspect source."""
        chan.cancel(rid)
        del pull.inflight[rid]
        self._rid_to_pull.pop(rid, None)
        self._source_switches += 1
        other = min(
            others,
            key=lambda c: sum(1 for e in pull.inflight.values()
                              if e[0] is c))
        new_rid = next(self._rid)
        pull.inflight[new_rid] = (other, off, ln, now)
        self._rid_to_pull[new_rid] = pull
        sink = (pull.dest[off:off + ln]
                if pull.dest is not None else None)
        actions.append(("range", other, new_rid, pull.oid, off, ln, sink))

    def on_node_suspect(self, node_id: str, suspect: bool):
        """Failure-detector routing signal (raylet event thread): a
        SUSPECT holder's in-flight striped ranges rotate to the pull's
        other live sources immediately instead of waiting out the stall
        watchdog; the channel stays open and nothing fails — if the node
        recovers, it simply starts winning ranges again."""
        actions = []
        now = time.monotonic()
        with self._lock:
            if not suspect:
                self._suspect.discard(node_id)
                return
            self._suspect.add(node_id)
            for pull in self._pulls.values():
                others = [c for c in pull.channels
                          if c.node_id != node_id and c.alive]
                if not others:
                    continue  # sole source: keep it, slow beats dead
                for rid, (chan, off, ln, _t0) in list(pull.inflight.items()):
                    if chan.node_id != node_id:
                        continue
                    self._rotate_range_locked(pull, rid, chan, off, ln,
                                              others, now, actions)
        self._run_actions(actions)

    def tick(self):
        """Watchdog (event-thread timer): rotate stalled ranges to another
        holder; with no alternative, drop the channel so the pull fails
        fast and retries through the directory."""
        timeout = config.pull_range_timeout_s
        if timeout <= 0:
            return
        now = time.monotonic()
        stalled_channels = []
        with self._lock:
            actions = []
            for pull in list(self._pulls.values()):
                # META stall: the reply rides the holder's (sequentially
                # served) connection, so a wedged serve thread starves it
                # forever without this — close the serving channel and let
                # the closed event rotate or fail the pull.
                if (pull.state == "meta"
                        and now - pull.meta_t >= timeout
                        and pull.meta_chan is not None):
                    stalled_channels.append(pull.meta_chan)
                    pull.meta_t = now  # don't re-close every tick
                    continue
                for rid, (chan, off, ln, t0) in list(pull.inflight.items()):
                    if now - t0 < timeout:
                        continue
                    others = [c for c in pull.channels
                              if c is not chan and c.alive]
                    if others:
                        self._rotate_range_locked(pull, rid, chan, off, ln,
                                                  others, now, actions)
                    else:
                        stalled_channels.append(chan)
        self._run_actions(actions)
        for chan in stalled_channels:
            chan.close()

    def stats(self) -> dict:
        with self._lock:
            return {
                "inflight_bytes": self._inflight_bytes,
                "queued": len(self._queue),
                "active": len(self._pulls),
                "bytes_total": self._bytes_total,
                "chunks_total": self._chunks_total,
                "source_switches": self._source_switches,
                "multi_source_pulls": self._multi_source_pulls,
                "completed": self._completed,
                "failed": self._failed,
                "last_completed": dict(self._last_completed)
                if self._last_completed else None,
            }

    def close(self):
        self._closed = True
        with self._lock:
            channels = list(self._channels.values())
            self._channels.clear()
        for chan in channels:
            chan.close()

    # ------------------------------------------------------- channel plumbing

    def _dial(self, locations: List[str]) -> List[DataChannel]:
        """Connect (or reuse) data channels for up to pull_max_sources
        holders.  Runs on the DIALER thread (blocking connects must stay
        off the raylet event loop).  Each holder gets
        ``data_dial_attempts`` connects under the unified backoff policy
        (a restarting peer often accepts on the second try); nodes that
        still can't be dialed — no data_port registered, or every connect
        failed — get a tombstone so callers stop retrying the data plane
        against them for a while."""
        out = []
        policy = BackoffPolicy()
        for node in locations[:max(1, config.pull_max_sources)]:
            with self._lock:
                chan = self._channels.get(node)
            if chan is not None and chan.alive:
                out.append(chan)
                continue
            addr = self._data_addr_fn(node)
            if addr is None:
                self._no_data_plane[node] = time.monotonic() + 30.0
                continue
            chan = None
            identity = self._hello_fn() if self._hello_fn is not None \
                else None
            for attempt in range(max(1, config.data_dial_attempts)):
                if self._closed:
                    return out
                try:
                    chan = DataChannel(node, addr, self._on_event,
                                       identity=identity)
                    break
                except (ConnectionRefusedError, TimeoutError):
                    # Refused: the peer process is gone.  Timeout: the
                    # HOST is gone (preemption — the dominant failure on
                    # the target fleet) and already cost connect_timeout.
                    # Retrying either is futile, and every sleep here
                    # serializes in front of all other queued dials on
                    # this (single) dialer thread.
                    break
                except OSError:
                    # reset/unreachable (fast failures): plausibly a
                    # restarting peer — retry under the unified backoff
                    if attempt + 1 < max(1, config.data_dial_attempts):
                        time.sleep(policy.delay(attempt))
            if chan is None:
                self._no_data_plane[node] = time.monotonic() + 30.0
                continue
            # Install under the lock, and never clobber a channel some
            # other path installed while this dial was in flight — the
            # overwritten entry would leak an open connection (its
            # receiver thread would also keep feeding stale events).
            with self._lock:
                existing = self._channels.get(node)
                if existing is not None and existing.alive \
                        and existing is not chan:
                    loser = chan
                    chan = existing
                else:
                    self._channels[node] = chan
                    loser = None
            if loser is not None:
                loser.close()
            out.append(chan)
        return out

    # ---------------------------------------------------------- admission

    def _admit_locked(self) -> list:  # requires: _lock
        """Admit queued pulls while under the in-flight byte cap (always at
        least one when nothing is active, so an object bigger than the cap
        still moves).  Returns channel actions to run outside the lock."""
        cap = max(1, config.pull_max_inflight_bytes)
        actions = []
        while self._queue:
            _, _, oid = self._queue[0]
            pull = self._queued.get(oid)
            if pull is None or pull.state == "dialing":  # stale / not ready
                heapq.heappop(self._queue)
                continue
            # Unknown size (META pending) is charged a provisional stripe's
            # worth so a burst of size-0 directory entries can't blow
            # through the cap; the true size adjusts the charge on META.
            est = pull.size or max(1, config.pull_stripe_bytes)
            if self._pulls and self._inflight_bytes + est > cap:
                break
            heapq.heappop(self._queue)
            del self._queued[oid]
            pull.charged = est
            self._inflight_bytes += est
            actions.extend(self._start_locked(pull))
        return actions

    def _start_locked(self, pull: _Pull) -> list:  # requires: _lock
        pull.channels = [c for c in pull.channels if c.alive]
        if not pull.channels:
            return [("fail", pull, [])]
        self._pulls[pull.oid] = pull
        if pull.size <= 0:
            # size unknown: ask the first holder (META) before allocating
            pull.state = "meta"
            rid = next(self._rid)
            pull.meta_rid = rid
            pull.meta_t = time.monotonic()
            pull.meta_chan = pull.channels[pull.meta_tried
                                           % len(pull.channels)]
            self._rid_to_pull[rid] = pull
            return [("meta", pull.meta_chan, rid, pull.oid)]
        return self._activate_locked(pull)

    def _activate_locked(self, pull: _Pull) -> list:  # requires: _lock
        """Size known: allocate the destination and fan the first ranges
        out round-robin across every live holder."""
        pull.state = "active"
        self._inflight_bytes += pull.size - pull.charged
        pull.charged = pull.size
        store = self._store_fn()
        if store is None:
            return [("fail", pull, [])]
        try:
            pull.dest = store.create(pull.oid, pull.size,
                                     allow_evict=not config.object_store_spill)
            pull.created = True
        except FileExistsError:
            # raced another path; the object is (or is becoming) local
            return [("done", pull)]
        except Exception:  # noqa: BLE001 — store full
            if not config.object_store_spill:
                return [("fail", pull, [])]
            pull.buf = bytearray(pull.size)
            pull.dest = memoryview(pull.buf)
        if pull.size == 0:
            return [("done", pull)]
        stripe = max(64 << 10, config.pull_stripe_bytes)
        # LIFO assignment order doesn't matter for correctness; build the
        # range list back-to-front so .pop() hands out ascending offsets.
        pull.unassigned = [
            (off, min(stripe, pull.size - off))
            for off in range(0, pull.size, stripe)
        ][::-1]
        return self._assign_locked(pull)

    def _assign_locked(self, pull: _Pull) -> list:  # requires: _lock
        """Top up every live source to pipeline_depth outstanding ranges."""
        actions = []
        depth = max(1, config.pull_pipeline_depth)
        live = [c for c in pull.channels if c.alive]
        # SUSPECT holders stop winning new ranges while any healthy source
        # remains (failure-detector routing; a lone suspect still serves).
        healthy = [c for c in live if c.node_id not in self._suspect]
        if healthy:
            live = healthy
        if not live:
            if pull.inflight or not pull.unassigned:
                return actions
            return [("fail", pull, [])]
        counts = {id(c): 0 for c in live}
        for chan, _off, _ln, _t in pull.inflight.values():
            if id(chan) in counts:
                counts[id(chan)] += 1
        for chan in itertools.cycle(live):
            if not pull.unassigned:
                break
            if all(counts[id(c)] >= depth for c in live):
                break
            if counts[id(chan)] >= depth:
                continue
            off, ln = pull.unassigned.pop()
            rid = next(self._rid)
            pull.inflight[rid] = (chan, off, ln, time.monotonic())
            self._rid_to_pull[rid] = pull
            counts[id(chan)] += 1
            sink = pull.dest[off:off + ln] if pull.dest is not None else None
            actions.append(("range", chan, rid, pull.oid, off, ln, sink))
        return actions

    def _run_actions(self, actions: list):
        """Execute channel sends / completions collected under the lock."""
        for act in actions:
            kind = act[0]
            if kind == "range":
                _, chan, rid, oid, off, ln, sink = act
                if not chan.request_range(rid, oid, off, ln, sink):
                    # send failed -> channel closed itself; the "closed"
                    # event reassigns this rid
                    pass
            elif kind == "meta":
                _, chan, rid, oid = act
                chan.request_meta(rid, oid)
            elif kind == "done":
                self._finalize(act[1])
            elif kind == "fail":
                self._fail(act[1], act[2])

    # --------------------------------------------------------- channel events

    def _on_event(self, chan: DataChannel, rid: Optional[int], kind: str,
                  arg):
        """Receiver-thread callback from a DataChannel."""
        if kind == "closed":
            self._on_channel_closed(chan)
            return
        with self._lock:
            pull = self._rid_to_pull.pop(rid, None) if rid else None
            if pull is None:
                return
            if kind == "data":
                entry = pull.inflight.pop(rid, None)
                if entry is None:
                    return
                _, off, ln, _t = entry
                pull.done_bytes += ln
                pull.bytes_by_source[chan.node_id] = \
                    pull.bytes_by_source.get(chan.node_id, 0) + ln
                self._bytes_total += ln
                self._chunks_total += 1
                if pull.done_bytes >= pull.size and not pull.unassigned \
                        and not pull.inflight:
                    actions = [("done", pull)]
                else:
                    actions = self._assign_locked(pull)
            elif kind == "meta":
                if pull.state != "meta":
                    return
                pull.size = int(arg)
                pull.meta_rid = None
                actions = self._activate_locked(pull)
            else:  # "err" — this holder can't serve (freed / never had it)
                actions = self._drop_source_locked(pull, chan, rid)
        self._run_actions(actions)

    def _drop_source_locked(self, pull: _Pull, chan: DataChannel,  # requires: _lock
                            rid: Optional[int]) -> list:
        if pull.state == "meta":
            pull.meta_tried += 1
            others = [c for c in pull.channels if c is not chan and c.alive]
            if not others:
                return [("fail", pull, [chan.node_id])]
            pull.channels = others
            new_rid = next(self._rid)
            pull.meta_rid = new_rid
            pull.meta_t = time.monotonic()
            pull.meta_chan = others[pull.meta_tried % len(others)]
            self._rid_to_pull[new_rid] = pull
            return [("meta", pull.meta_chan, new_rid, pull.oid)]
        if rid is not None:
            entry = pull.inflight.pop(rid, None)
            if entry is not None:
                pull.unassigned.append((entry[1], entry[2]))
        before = len(pull.channels)
        pull.channels = [c for c in pull.channels
                         if c is not chan and c.alive]
        if not pull.channels:
            return [("fail", pull, [chan.node_id])]
        if len(pull.channels) < before:
            self._source_switches += 1
        return self._assign_locked(pull)

    def _on_channel_closed(self, chan: DataChannel):
        with self._lock:
            if self._channels.get(chan.node_id) is chan:
                del self._channels[chan.node_id]
            actions = []
            for pull in list(self._pulls.values()):
                if chan not in pull.channels and not any(
                        c is chan for c, *_ in pull.inflight.values()):
                    continue
                moved = False
                for rid, entry in list(pull.inflight.items()):
                    if entry[0] is chan:
                        del pull.inflight[rid]
                        self._rid_to_pull.pop(rid, None)
                        pull.unassigned.append((entry[1], entry[2]))
                        moved = True
                had = chan in pull.channels
                pull.channels = [c for c in pull.channels if c is not chan]
                # NB: channel death is NOT authoritative "object gone" —
                # fail with no bad_nodes so the retry keeps the directory
                # entry (an explicit "not here" ERR is what scrubs it).
                if pull.state == "meta" and had and not pull.channels:
                    actions.append(("fail", pull, []))
                    continue
                if pull.state == "meta" and had:
                    # retry meta on a surviving holder
                    new_rid = next(self._rid)
                    if pull.meta_rid is not None:
                        self._rid_to_pull.pop(pull.meta_rid, None)
                    pull.meta_rid = new_rid
                    pull.meta_t = time.monotonic()
                    pull.meta_chan = pull.channels[0]
                    self._rid_to_pull[new_rid] = pull
                    actions.append(("meta", pull.meta_chan, new_rid,
                                    pull.oid))
                    continue
                if not pull.channels:
                    actions.append(("fail", pull, []))
                    continue
                if moved or had:
                    self._source_switches += 1
                    actions.extend(self._assign_locked(pull))
            # a dead channel may also unblock queued admissions ( pulls that
            # failed shrink inflight bytes inside _fail, not here )
        self._run_actions(actions)

    # ------------------------------------------------------------ completion

    def _teardown_locked(self, pull: _Pull):  # requires: _lock
        self._pulls.pop(pull.oid, None)
        for rid in list(pull.inflight):
            chan = pull.inflight[rid][0]
            chan.cancel(rid)
            self._rid_to_pull.pop(rid, None)
        pull.inflight.clear()
        if pull.meta_rid is not None:
            self._rid_to_pull.pop(pull.meta_rid, None)
        self._inflight_bytes -= pull.charged
        pull.charged = 0
        if self._inflight_bytes < 0:
            self._inflight_bytes = 0

    def _finalize(self, pull: _Pull):
        """All bytes landed (receiver thread or event thread): seal (or
        spill) and hand completion to the event loop."""
        store = self._store_fn()
        with self._lock:
            self._teardown_locked(pull)
            self._completed += 1
            if len([s for s, b in pull.bytes_by_source.items() if b > 0]) >= 2:
                self._multi_source_pulls += 1
            self._last_completed = {
                "oid": pull.oid.hex(),
                "size": pull.size,
                "sources": dict(pull.bytes_by_source),
                "elapsed_s": time.monotonic() - pull.started,
            }
            actions = self._admit_locked()
        try:
            if pull.created:
                pull.dest = None
                store.seal(pull.oid)
                store.release(pull.oid)
            elif pull.buf is not None:
                pull.dest = None
                try:
                    dest = store.create(
                        pull.oid, pull.size,
                        allow_evict=not config.object_store_spill)
                    dest[:] = pull.buf
                    del dest
                    store.seal(pull.oid)
                    store.release(pull.oid)
                except FileExistsError:
                    pass
                except Exception:  # noqa: BLE001 — still full: spill
                    store.spill_raw(pull.oid, pull.buf)
                pull.buf = None
        except Exception:  # noqa: BLE001
            self._post(self._on_fail, pull.oid, [])
            self._run_actions(actions)
            return
        self._post(self._on_done, pull.oid)
        self._run_actions(actions)

    def _fail(self, pull: _Pull, bad_nodes: List[str]):
        store = self._store_fn()
        with self._lock:
            self._queued.pop(pull.oid, None)
            # Channels that may STILL be landing bytes into pull.dest (a
            # receiver that already popped its sink is mid recv_into and
            # chan.cancel() can't stop it) must be quiesced before the
            # allocation is freed, or the late bytes would write into a
            # reused arena region — silent corruption of another object.
            live = {e[0] for e in pull.inflight.values() if e[0].alive}
            self._teardown_locked(pull)
            self._failed += 1
            actions = self._admit_locked()
        if pull.created:
            for chan in live:
                chan.close()
                chan.join_receiver()
            pull.dest = None
            try:
                store.abort(pull.oid)
            except Exception:  # noqa: BLE001
                pass
        pull.buf = None
        self._post(self._on_fail, pull.oid, list(bad_nodes))
        self._run_actions(actions)
