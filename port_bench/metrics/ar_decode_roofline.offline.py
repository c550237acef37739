"""The AR kernel's least time over its traced time at B=256, %."""

from port_bench.harness import readers


def read(rec):
    return readers.ar_decode_roofline(rec)
