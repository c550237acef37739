"""Device ms a request inside the program's ``model.face_net`` span: the
InceptionResnetV1 face net, its ReLU and L2 normalisation.

The profiler gives each kernel to the innermost range open at its launch
alone. The benchmark's hook on the face net module (``bench.face_net``)
opens inside ``model.face_net``, so while the hook exists the face net's
own kernels sit under the hook; the two names hold disjoint kernels, and
their sum is the span's whole work. A program without the span reads
nothing."""

from port_bench.harness import readers


def read(rec):
    if readers.range_device_ms(rec, "model.face_net") is None:
        return None
    return readers.range_device_ms(rec, "model.face_net", "bench.face_net")
