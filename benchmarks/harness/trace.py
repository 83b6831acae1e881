"""A traced window, reduced in the process that holds the card.

``Tracer`` wraps ``torch.profiler`` (CPU and CUDA activities) around a
stretch of the cell's work that the driver marks with host spans
(``span``: a ``record_function`` named ``bench.<what>``).  ``reduce_events``
turns the profiler's events into the record the per-layer metrics read:

- ``window_s``: the wall length of the traced window, from its own span;
- ``busy_s``: the union of the device's operations (kernels, copies,
  fills) inside that window, so idle time before the first kernel and
  after the last counts as idle;
- ``device_ops``: [name, seconds, count] of every device operation, by
  total time;
- ``idle_by_host``: [label, seconds] of the device's idle time inside the
  window, by the innermost host span open at the middle of each gap.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

WINDOW = "bench.traced"
#: label of device idle time while no host span of the driver is open
OUTSIDE = "outside the driver's spans"
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def span(name: str):
    """A host span ``bench.<name>`` that the trace can label gaps by; a
    no-op outside a profile."""
    from torch.profiler import record_function

    return record_function(f"bench.{name}")


class Tracer:
    """``start()`` ... ``stop()`` around the traced stretch; ``stop``
    returns the reduced record.  Synchronize before each: the window
    should begin and end with the device drained."""

    def __init__(self):
        self._prof = None
        self._window = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        import torch

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._window = span("traced")
        self._window.__enter__()

    @property
    def active(self) -> bool:
        return self._prof is not None

    def stop(self) -> Dict:
        self._window.__exit__(None, None, None)
        self._prof.stop()
        events = self._prof.profiler.kineto_results.events()
        self._prof = None
        return reduce_events([_plain(e) for e in events])


def _plain(e) -> Tuple[str, str, str, int, int]:
    """(name, device type, activity kind, start ns, end ns) of a kineto
    event.  Where the event has no ``activity_type`` (torch 2.11), a device
    event counts as a kernel; ``reduce_events`` drops the device-side
    annotations by name."""
    device = str(e.device_type()).rsplit(".", 1)[-1]
    if hasattr(e, "activity_type"):
        kind = e.activity_type()
    elif hasattr(e, "is_user_annotation") and e.is_user_annotation():
        kind = "gpu_user_annotation" if device == "CUDA" else \
            "user_annotation"
    else:
        kind = "kernel" if device == "CUDA" else "cpu_op"
    start = e.start_ns()
    return (e.name(), device, kind, start, start + e.duration_ns())


def _union(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def reduce_events(events) -> Dict:
    """The record of a traced window from (name, device type, kind, start
    ns, end ns) events: the window is the ``bench.traced`` span; device
    events are those on the CUDA device of kind kernel, copy or fill (not
    the device-side annotations, which carry the name of a host range)."""
    window = [e for e in events if e[0] == WINDOW and e[1] == "CPU"]
    if not window:
        raise ValueError("the trace holds no bench.traced span")
    lo, hi = window[0][3], window[0][4]
    host_names = {e[0] for e in events if e[1] == "CPU"}
    device = [e for e in events if e[1] == "CUDA" and e[2] in _DEVICE_KINDS
              and e[0] not in host_names]
    ops: Dict[str, List] = {}
    clipped = []
    for name, _, _, a, b in device:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        clipped.append((a, b))
        entry = ops.setdefault(name, [name, 0.0, 0])
        entry[1] += (b - a) / 1e9
        entry[2] += 1
    busy = _union(clipped)
    gaps, at = [], lo
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = b
    if at < hi:
        gaps.append((at, hi))
    host = sorted((e[3], e[4], e[0][len("bench."):]) for e in events
                  if e[1] == "CPU" and e[0].startswith("bench.")
                  and e[0] != WINDOW)
    idle: Dict[str, float] = {}
    for a, b in gaps:
        label, mid = OUTSIDE, (a + b) // 2
        for s, t, name in host:  # the innermost: the latest to open
            if s > mid:
                break
            if t > mid:
                label = name
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e9
    return {"window_s": (hi - lo) / 1e9,
            "busy_s": sum(b - a for a, b in busy) / 1e9,
            "device_ops": sorted(ops.values(), key=lambda x: -x[1]),
            "idle_by_host": sorted(([k, v] for k, v in idle.items()),
                                   key=lambda x: -x[1])}


def kernel_time(record: Dict, pattern: str) -> Tuple[float, int]:
    """(seconds, launches) of the device operations whose name holds
    ``pattern``."""
    hits = [op for op in record["device_ops"] if pattern in op[0]]
    return sum(op[1] for op in hits), sum(op[2] for op in hits)


def breakdown(record: Dict, n: int = 10) -> Dict:
    """The contract's ``breakdown``: the device operations that took most
    time and the idle time by what the host was doing, at most ``n``
    each."""
    return {"device_ops": [[op[0][:200], op[1]]
                           for op in record["device_ops"][:n]],
            "idle_gaps": [list(x) for x in record["idle_by_host"][:n]]}
