"""Readings of a traced window shared by the per-layer metrics: a kernel's
share of its roofline and the device's idle share, in percent.  Each
returns None where the trace holds nothing to read (no trace, no launch
of the kernel), never 0."""

from __future__ import annotations

from typing import Dict, Optional

from benchmarks.harness import trace, yardstick

FWD_KERNEL = "flash_fwd_kernel"
DQ_KERNEL = "flash_bwd_dq_kernel"
DKV_KERNEL = "flash_bwd_dkv_kernel"


def flash_forward(record: Dict) -> Optional[float]:
    """100 x (least time of one causal forward x launches) / device time."""
    t = record.get("trace")
    if not t:
        return None
    seconds, launches = trace.kernel_time(t, FWD_KERNEL)
    if not launches:
        return None
    bound, _ = yardstick.attention_bound(
        *yardstick.flash_shape(record["config"], record["traffic"]), True)
    return 100 * bound * launches / seconds


def flash_backward(record: Dict) -> Optional[float]:
    """100 x (least time of one causal backward x pairs) / the dq and
    dk/dv kernels' device time; None where their launches differ."""
    t = record.get("trace")
    if not t:
        return None
    dq_s, dq_n = trace.kernel_time(t, DQ_KERNEL)
    dkv_s, dkv_n = trace.kernel_time(t, DKV_KERNEL)
    if not dq_n or dq_n != dkv_n:
        return None
    products, tensors, rows = yardstick.BWD_WORK["pair"]
    bound, _ = yardstick.attention_bound(
        *yardstick.flash_shape(record["config"], record["traffic"]), True,
        products=products, tensors=tensors, rows=rows)
    return 100 * bound * dq_n / (dq_s + dkv_s)


def idle_share(record: Dict) -> Optional[float]:
    """100 x (1 - device busy / wall) over the traced window."""
    t = record.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100 * (1 - t["busy_s"] / t["window_s"])
