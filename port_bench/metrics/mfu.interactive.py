"""Operations of a B=4 request over its wall time, % of the chip's peak."""

from port_bench.harness import readers


def read(rec):
    return readers.mfu(rec, "infer")
