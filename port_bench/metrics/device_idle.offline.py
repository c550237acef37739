"""Share of the measured window with no operation on the device, %: the
device's busy time a unit from the trace over the untraced wall time a unit."""

from port_bench.harness import readers


def read(rec):
    return readers.device_idle(rec)
