"""The flash backward kernels (``csrc/flash_bwd.cu``: dq, then dk/dv) in
the train step: the least time of the whole backward's work (five
products; q, k, v, do, dq, dk, dv; lse and delta) at the cell's
(B, H, S, D), causal, times the pairs launched, over the two kernels'
summed device time."""

from benchmarks.harness import rooflines


def read(record):
    return rooflines.flash_backward(record)
