"""Device ms a request inside the video encoder's and the face net's ranges."""

from port_bench.harness import readers


def read(rec):
    return readers.range_device_ms(rec, "bench.encoder", "bench.face_net")
