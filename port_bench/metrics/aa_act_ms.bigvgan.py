"""Device ms a request inside the program's ``vocoder.activation`` spans:
every anti-aliased SnakeBeta (upsample, activation, low-pass and
downsample), 109 a request."""

from port_bench.harness import readers


def read(rec):
    return readers.range_device_ms(rec, "vocoder.activation")
