"""Operations of a train step (forward and backward) over its wall time, % of the chip's peak."""

from port_bench.harness import readers


def read(rec):
    return readers.mfu(rec, "train")
