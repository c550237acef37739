"""Training: clips trained on, over the window (host clock)."""

from port_bench.harness import readers


def read(rec):
    return readers.rate(rec, "train")
