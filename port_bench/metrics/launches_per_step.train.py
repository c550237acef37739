"""Device kernels a train step in the traced window."""

from port_bench.harness import readers


def read(rec):
    return readers.kernels_per_unit(rec)
