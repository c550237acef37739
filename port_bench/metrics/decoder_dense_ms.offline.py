"""Device ms a request inside the program's ``decoder.encode`` and
``decoder.postnet`` spans: the decoder's dense work around the AR loop (the
BiLSTM encoder, the K/V conv banks and the content codebook before it, the
postnet after it)."""

from port_bench.harness import readers


def read(rec):
    return readers.range_device_ms(rec, "decoder.encode", "decoder.postnet")
