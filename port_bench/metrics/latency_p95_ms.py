"""An interactive request's 95th-percentile time from issue to waveform on the host, ms (host clock)."""

from port_bench.harness import readers


def read(rec):
    return readers.latency_ms(rec, 95)
