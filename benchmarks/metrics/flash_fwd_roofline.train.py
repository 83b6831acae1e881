"""The flash forward kernel (``csrc/flash_fwd.cu``) in the train step:
the least time of its causal attention work at the cell's (B, H, S, D),
times its launches, over its summed device time in the trace."""

from benchmarks.harness import rooflines


def read(record):
    return rooflines.flash_forward(record)
