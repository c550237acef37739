"""Device ms a request inside the NNLS and Griffin-Lim range."""

from port_bench.harness import readers


def read(rec):
    return readers.range_device_ms(rec, "bench.griffin_lim")
