"""The program's own regions in a traced window.

``ray_tpu_torch.util.tracing.region`` records each named stretch of the
program's work as a ``record_function`` while the profiler runs, so the
regions below land among the window's kineto events on the profiler's
clock.  ``reduce`` turns those events into what the program's per-layer
metrics read, beside ``trace.reduce_events``' record, which it leaves as
it is:

- ``regions``: [name, host seconds, self seconds, count] of each region,
  clipped to the window (self: less its child regions);
- ``idle_by_region``: [region, seconds, outermost region] of the device's
  idle time, by the innermost region open on the training thread at each
  gap's middle, ``OUTSIDE`` where none is;
- ``device_by_region``: [region, seconds, of which backward, operations]
  of the device's kernels, copies and fills.  An operation is tied to its
  launch by correlation id, and the launch to the innermost region open
  on the training thread at the launch's host time; an operation launched
  inside an autograd node's backward goes to the region of the forward op
  that made the node (the node's ``sequence_nr`` and forward thread), so
  the head's backward counts for ``gpt2.head``.  ``UNLINKED``: no launch
  found;
- ``allocator``: the caching allocator's device allocations, frees and
  retries over the stretch (``allocator_counts`` before and after), or
  None off the card;
- ``launch_lead_us``: the least (device start - launch start) over the
  linked operations, and ``early_ops``: how many start more than
  ``EARLY_US`` before their launch.  Both clocks agree only where no
  operation does: kineto moves the device's timestamps onto the host's
  clock, and a linked operation cannot run before its launch.

The training thread is the one that holds the most ``train_step``
regions (failing that, the most regions).
"""

from __future__ import annotations

import bisect
from typing import Dict, List, NamedTuple, Optional, Tuple

from benchmarks.harness.trace import WINDOW, _DEVICE_KINDS, _plain, _union

#: the program's region names (``ray_tpu_torch``: ``models/gpt2.py``,
#: ``data/iterator.py``, ``train/session.py``)
STEP = "train_step"
HEAD = "gpt2.head"
INGEST_WAITS = ("data.claim", "data.block_wait")
REGIONS = frozenset((
    STEP, "train_step.cast", "train_step.loss", "train_step.backward",
    "train_step.grad_sum", "train_step.optimizer", "train_step.zero_grad",
    "gpt2.trunk", HEAD, "data.claim", "data.block_wait", "data.stage",
    "train.report", "train.report_wait"))
OUTSIDE = "(outside the program's regions)"
UNLINKED = "(unlinked)"
#: an autograd node's backward, carrying the node's ``sequence_nr``
BACKWARD = "autograd::engine::evaluate_function"
#: the host side of a launch: CUDA runtime or driver calls
_LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
#: how far (us) an operation may start before its launch's host time
#: before the two clocks count as apart
EARLY_US = 50
#: the allocator's counters that ``allocator`` reports
ALLOCATOR = ("num_device_alloc", "num_device_free", "num_alloc_retries")


class Event(NamedTuple):
    """A kineto event: ``trace._plain``'s five fields, then the thread
    (the profiler's own id on the host side), the correlation id, the id
    of the op it is linked to (a launch's enclosing op), the autograd
    sequence number and, for a backward, the thread of its forward."""

    name: str
    device: str
    kind: str
    start: int
    end: int
    thread: int = 0
    corr: int = 0
    linked: int = 0
    seq: int = -1
    fwd_thread: int = 0


def event(e) -> Event:
    """The ``Event`` of a kineto event (torch 2.11 and later)."""

    def get(attr, default):
        f = getattr(e, attr, None)
        return f() if f is not None else default

    return Event(*_plain(e), get("start_thread_id", 0),
                 get("correlation_id", 0), get("linked_correlation_id", 0),
                 get("sequence_nr", -1), get("fwd_thread_id", 0))


def allocator_counts() -> Optional[Dict[str, int]]:
    """The caching allocator's counters now, None without a card."""
    import torch

    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats()
    return {k: int(stats.get(k, 0)) for k in ALLOCATOR}


def allocator_delta(before, after) -> Optional[Dict[str, int]]:
    if before is None or after is None:
        return None
    return {k: after[k] - before[k] for k in ALLOCATOR}


class _Intervals:
    """One thread's nested intervals (events of one thread nest: each
    closes before the one around it); ``inner(t)`` is the innermost one
    open at ``t``."""

    def __init__(self, events: List[Event]):
        self.events = sorted(events, key=lambda e: (e.start, -e.end))
        self.starts = [e.start for e in self.events]
        self.parent: List[int] = []
        stack: List[int] = []
        for i, e in enumerate(self.events):
            while stack and self.events[stack[-1]].end <= e.start:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def inner_index(self, t: int) -> int:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.events[i].end <= t:
            i = self.parent[i]
        return i

    def inner(self, t: int) -> Optional[Event]:
        i = self.inner_index(t)
        return self.events[i] if i >= 0 else None

    def outer(self, t: int) -> Optional[Event]:
        i = self.inner_index(t)
        while i >= 0 and self.parent[i] >= 0:
            i = self.parent[i]
        return self.events[i] if i >= 0 else None


def _by_thread(events: List[Event]) -> Dict[int, _Intervals]:
    threads: Dict[int, List[Event]] = {}
    for e in events:
        threads.setdefault(e.thread, []).append(e)
    return {t: _Intervals(evs) for t, evs in threads.items()}


def _is_launch(e: Event) -> bool:
    """A runtime or driver call on the host.  Where kineto gives no
    activity kind (torch 2.11: every host event reads ``cpu_op``) the
    name tells: CUDA's API calls begin with ``cu``."""
    return e.device == "CPU" and (e.kind in _LAUNCH_KINDS or (
        e.kind == "cpu_op" and e.name.startswith("cu")))


class Linker:
    """Ties host times and threads to the program's regions."""

    def __init__(self, events: List[Event]):
        host = [e for e in events if e.device == "CPU"]
        regions = [e for e in host if e.name in REGIONS]
        self.regions = _by_thread(regions)
        counts: Dict[int, Tuple[int, int]] = {}
        for e in regions:
            steps, n = counts.get(e.thread, (0, 0))
            counts[e.thread] = (steps + (e.name == STEP), n + 1)
        self.thread = max(counts, key=counts.get) if counts else None
        self.backward = _by_thread([e for e in host
                                    if e.name.startswith(BACKWARD)])
        self.forward: Dict[Tuple[int, int], Event] = {}
        self.ops: Dict[int, Event] = {}
        self.launches: Dict[int, Event] = {}
        for e in host:
            if _is_launch(e):
                self.launches.setdefault(e.corr, e)
                continue
            self.ops.setdefault(e.corr, e)
            key = (e.thread, e.seq)
            if (e.seq >= 0 and not e.name.startswith(BACKWARD)
                    and (key not in self.forward
                         or e.start < self.forward[key].start)):
                self.forward[key] = e

    def _training(self, t: int, outer: bool = False) -> Optional[Event]:
        if self.thread is None:
            return None
        at = self.regions[self.thread]
        return at.outer(t) if outer else at.inner(t)

    def region_at(self, t: int) -> str:
        """The innermost region open on the training thread at ``t``."""
        r = self._training(t)
        return r.name if r is not None else OUTSIDE

    def outer_at(self, t: int) -> str:
        r = self._training(t, outer=True)
        return r.name if r is not None else OUTSIDE

    def region_of(self, thread: int, t: int, depth: int = 0
                  ) -> Tuple[str, bool]:
        """(region, whether through a backward) of work done on ``thread``
        at ``t``: inside an autograd node's backward, the region of the
        forward op that made the node (a recompute's forward, itself run
        inside a backward, is followed in turn); else the training
        thread's region at ``t``."""
        nodes = self.backward.get(thread)
        node = nodes.inner(t) if nodes is not None else None
        if node is not None and node.seq >= 0 and depth < 8:
            fwd = self.forward.get((node.fwd_thread, node.seq))
            if fwd is not None:
                return self.region_of(fwd.thread, fwd.start, depth + 1)[0], \
                    True
        return self.region_at(t), node is not None

    def device_region(self, op: Event) -> Tuple[str, bool,
                                                Optional[Event]]:
        """(region, through a backward, launch) of a device operation."""
        launch = self.launches.get(op.corr)
        if launch is None:
            return UNLINKED, False, None
        enclosing = self.ops.get(launch.linked) or self.ops.get(op.linked)
        thread = enclosing.thread if enclosing is not None else self.thread
        region, backward = self.region_of(thread, launch.start)
        return region, backward, launch


def reduce(events: List[Event], allocator: Optional[Dict] = None) -> Dict:
    """``trace["program"]`` from a traced window's events (``event`` of
    each kineto event); the window is the ``bench.traced`` span."""
    window = [e for e in events if e.name == WINDOW and e.device == "CPU"]
    if not window:
        raise ValueError("the trace holds no bench.traced span")
    lo, hi = window[0].start, window[0].end
    link = Linker(events)

    rows: Dict[str, List] = {}
    for at in link.regions.values():
        for i, e in enumerate(at.events):
            a, b = max(e.start, lo), min(e.end, hi)
            if b <= a:
                continue
            row = rows.setdefault(e.name, [e.name, 0.0, 0.0, 0])
            row[1] += (b - a) / 1e9
            row[2] += (b - a) / 1e9
            row[3] += 1
            if at.parent[i] >= 0:
                rows[at.events[at.parent[i]].name][2] -= (b - a) / 1e9

    host_names = {e.name for e in events if e.device == "CPU"}
    device = [e for e in events if e.device == "CUDA"
              and e.kind in _DEVICE_KINDS and e.name not in host_names]
    by_region: Dict[str, List] = {}
    clipped, lead, early = [], None, 0
    for op in device:
        a, b = max(op.start, lo), min(op.end, hi)
        if b <= a:
            continue
        clipped.append((a, b))
        region, backward, launch = link.device_region(op)
        row = by_region.setdefault(region, [region, 0.0, 0.0, 0])
        row[1] += (b - a) / 1e9
        row[2] += (b - a) / 1e9 if backward else 0.0
        row[3] += 1
        if launch is not None:
            d = (op.start - launch.start) / 1e3
            lead = d if lead is None else min(lead, d)
            early += d < -EARLY_US

    idle: Dict[Tuple[str, str], float] = {}
    at = lo
    for a, b in _union(clipped) + [(hi, hi)]:
        if a > at:
            mid = (at + a) // 2
            key = (link.region_at(mid), link.outer_at(mid))
            idle[key] = idle.get(key, 0.0) + (a - at) / 1e9
        at = max(at, b)
    return {
        "regions": sorted(rows.values(), key=lambda r: -r[1]),
        "idle_by_region": sorted(([k[0], v, k[1]] for k, v in idle.items()),
                                 key=lambda r: -r[1]),
        "device_by_region": sorted(by_region.values(), key=lambda r: -r[1]),
        "allocator": allocator,
        "launch_lead_us": lead, "early_ops": early}


def reduce_kineto(kineto_events, allocator: Optional[Dict] = None) -> Dict:
    """``reduce`` of the profiler's raw events
    (``prof.profiler.kineto_results.events()``)."""
    return reduce([event(e) for e in kineto_events], allocator)


# ------------------------------------------------------------- readings
# Each returns None where the record holds nothing to read, never 0.


def _program(record: Dict) -> Optional[Dict]:
    t = record.get("trace")
    return t.get("program") if t else None


def _region_row(program: Dict, name: str) -> Optional[List]:
    return next((r for r in program["regions"] if r[0] == name), None)


def step_idle(record: Dict) -> Optional[float]:
    """100 x the device's idle time while a train step (any of its
    regions) runs on the training thread, over the window."""
    p = _program(record)
    if not p or _region_row(p, STEP) is None:
        return None
    idle = sum(r[1] for r in p["idle_by_region"] if r[2] == STEP)
    return 100 * idle / record["trace"]["window_s"]


def lm_head_share(record: Dict) -> Optional[float]:
    """100 x the device time of ``gpt2.head`` (its forward and the backward
    of the nodes it made) over the window's busy time."""
    p = _program(record)
    row = next((r for r in p["device_by_region"] if r[0] == HEAD),
               None) if p else None
    if row is None or record["trace"]["busy_s"] <= 0:
        return None
    return 100 * row[1] / record["trace"]["busy_s"]


def ingest_wait_ms(record: Dict) -> Optional[float]:
    """Host milliseconds a step waiting on Data: ``data.claim`` plus
    ``data.block_wait``, over the train steps in the window."""
    p = _program(record)
    steps = _region_row(p, STEP) if p else None
    waits = [r for r in (_region_row(p, n) for n in INGEST_WAITS)
             if r is not None] if p else []
    if steps is None or not waits:
        return None
    return 1e3 * sum(r[1] for r in waits) / steps[3]
