"""Host ms a step of the program's train.backward span (the function
that opens that range), timed by the host's clock in the measured window."""

from port_bench.harness import readers


def read(rec):
    return readers.span_host_ms(rec, "train.backward")
