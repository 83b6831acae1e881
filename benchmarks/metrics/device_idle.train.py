"""The card's idle share in the training worker: the traced window's wall
time with no device operation running, over that window."""

from benchmarks.harness import rooflines


def read(record):
    return rooflines.idle_share(record)
