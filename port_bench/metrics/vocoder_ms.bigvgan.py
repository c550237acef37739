"""Device ms a request inside the program's BigVGAN spans (``vocoder.forward``,
``vocoder.upsample``, ``vocoder.amp``, ``vocoder.activation``). The profiler
gives each kernel to the innermost range open at its launch, and stamps a
range on the device from its first own kernel to its last. The program
places the four spans so that no span's own kernels bracket another's, so
the four names hold disjoint time and their sum is the generator's whole
work. A program without the spans reads nothing."""

from port_bench.harness import readers


def read(rec):
    return readers.range_device_ms(rec, "vocoder.forward", "vocoder.upsample", "vocoder.amp",
                                   "vocoder.activation")
