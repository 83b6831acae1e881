"""Lock factory + runtime lock-order watchdog.

Reference analogue: the reference leans on clang thread-safety annotations
(``GUARDED_BY``/``ACQUIRED_AFTER`` in `src/ray/common/`) for compile-time
lock discipline; a Python port gets no compiler help, so the dynamic half
lives here and the static half in ``tools/analysis``.

Every lock in the concurrent core is created through :func:`make_lock` /
:func:`make_rlock` with a stable dotted name (``"raylet.inbox"``,
``"pull_manager.state"``).  Normally that returns a plain
``threading.Lock`` — zero overhead.  With ``RAY_TPU_DEBUG_LOCKS=1`` it
returns a :class:`DebugLock` that

* keeps a per-thread stack of locks currently held,
* records every observed acquisition ORDER (lock A held while acquiring
  lock B) as an edge A->B in a process-global graph, stamped with the
  stack trace that first exhibited it, and
* checks the graph for cycles ONLINE, before blocking on the inner
  acquire: the moment any thread's acquisition would close a cycle
  (A->...->B observed earlier, B->A now), the potential deadlock is
  reported with both stacks — even if the threads never actually race.

Violations are collected in-process (:func:`lock_order_violations`) and
printed to stderr once per distinct cycle.  The CI workflow runs the fast
test subset with the watchdog on.
"""

from __future__ import annotations

import sys
import threading
import traceback
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.core.config import config

__all__ = ["DebugLock", "make_lock", "make_rlock", "lock_order_violations",
           "reset_lock_order_state"]

# Process-global acquisition-order graph.  _edges is only ever mutated
# under _graph_lock; readers use GIL-atomic dict membership checks on the
# hot path so an already-known edge costs one dict probe, no lock.
_graph_lock = threading.Lock()
_edges: Dict[Tuple[str, str], List[str]] = {}  # guard: _graph_lock
_succ: Dict[str, set] = {}                     # guard: _graph_lock
_violations: List[dict] = []                   # guard: _graph_lock
_reported: set = set()                         # guard: _graph_lock
_held = threading.local()  # .stack — this thread's currently-held DebugLocks


def _held_stack() -> list:
    stack = getattr(_held, "stack", None)
    if stack is None:
        stack = _held.stack = []
    return stack


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """BFS for a path src -> ... -> dst through the order graph (caller
    holds _graph_lock)."""
    if src == dst:
        return [src]
    parents: Dict[str, str] = {src: src}
    frontier = [src]
    while frontier:
        nxt = []
        for node in frontier:
            for succ in _succ.get(node, ()):  # unguarded-ok: documented — caller holds _graph_lock (requires below)
                if succ in parents:
                    continue
                parents[succ] = node
                if succ == dst:
                    path = [dst]
                    while path[-1] != src:
                        path.append(parents[path[-1]])
                    return path[::-1]
                nxt.append(succ)
        frontier = nxt
    return None


def lock_order_violations() -> List[dict]:
    """Potential deadlocks observed so far: each entry has ``cycle`` (the
    lock names around the loop) and ``stacks`` (one formatted stack per
    edge of the cycle — "both stacks" for the two-lock ABBA case)."""
    with _graph_lock:
        return [dict(v) for v in _violations]


def reset_lock_order_state():
    """Forget every recorded edge and violation (test isolation)."""
    with _graph_lock:
        _edges.clear()
        _succ.clear()
        _violations.clear()
        _reported.clear()


class DebugLock:
    """Drop-in ``threading.Lock``/``RLock`` wrapper feeding the order graph.

    The ordering edge is recorded (and the cycle check runs) BEFORE the
    blocking inner acquire: a live ABBA deadlock reports at the moment it
    forms instead of hanging silently, and two orderings observed at
    different times still flag the latent cycle.
    """

    __slots__ = ("name", "_inner", "_reentrant")

    def __init__(self, name: str, reentrant: bool = False):
        self.name = name
        self._reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = _held_stack()
        first_entry = not (self._reentrant
                           and any(e is self for e in held))
        # Ordering discipline applies to BLOCKING first acquisitions only:
        # a try-acquire cannot deadlock, and a reentrant re-acquire adds no
        # new ordering.
        if blocking and first_entry:
            for prev in held:
                self._note_edge(prev.name, self.name)
        got = self._inner.acquire(blocking, timeout)
        if got:
            held.append(self)
        return got

    def release(self):
        self._inner.release()
        held = _held_stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()

    def locked(self) -> bool:
        # RLock has no locked() before 3.12; DebugLock is only asked by
        # plain-lock call sites.
        return self._inner.locked()

    def _note_edge(self, a: str, b: str):
        if a == b:
            # Two same-named instances nested (e.g. two peers' send locks):
            # instance-level order is not tracked across a shared name.
            return
        if (a, b) in _edges:  # unguarded-ok: GIL-atomic membership probe, rechecked under _graph_lock below
            return
        stack = "".join(traceback.format_stack(limit=16)[:-2])
        with _graph_lock:
            if (a, b) in _edges:
                return
            # Closing edge a->b while b ->...-> a already exists = cycle.
            path = _find_path(b, a)
            _edges[(a, b)] = [stack]
            _succ.setdefault(a, set()).add(b)
            if path is None:
                return
            cycle = [a] + path  # a -> b -> ... -> a
            key = frozenset(cycle)
            if key in _reported:
                return
            _reported.add(key)
            stacks = [f"--- edge {a} -> {b} (this thread,"
                      f" {threading.current_thread().name}):\n{stack}"]
            for i in range(len(path) - 1):
                estack = _edges.get((path[i], path[i + 1]))
                if estack:
                    stacks.append(f"--- edge {path[i]} -> {path[i + 1]} "
                                  f"(first observed):\n{estack[0]}")
            _violations.append({"cycle": cycle, "stacks": stacks})
            sys.stderr.write(
                "[ray_tpu_torch][debug-locks] POTENTIAL DEADLOCK: lock order "
                "cycle " + " -> ".join(cycle) + "\n"
                + "\n".join(stacks) + "\n")


def make_lock(name: str):
    """A lock for runtime shared state: plain ``threading.Lock`` normally,
    order-tracked :class:`DebugLock` under ``RAY_TPU_DEBUG_LOCKS=1``."""
    if config.debug_locks:
        return DebugLock(name)
    return threading.Lock()


def make_rlock(name: str):
    """Reentrant variant of :func:`make_lock`."""
    if config.debug_locks:
        return DebugLock(name, reentrant=True)
    return threading.RLock()
