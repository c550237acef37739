"""The BigVGAN generator's weights of one run, made on the device from
``--seed``, under the published checkpoint's names.

The benchmark makes them and hands the same values to the program and to
the reference. They keep every stage's activations of order 1, so that
SnakeBeta's sine term weighs in every stage and not only the first:

- every convolution's weight U(-sqrt(3 / n), sqrt(3 / n)), where n is the
  number of products summed into one output: input channels times kernel
  for a convolution, input channels times kernel over stride for a
  transposed one. Each then keeps its input's mean square;
- ``conv_pre``'s bound times ``PRE_GAIN``, which lifts the mel that
  Lip2Speech serves on the benchmark's random weights to order 1;
- the second convolution of each residual unit (``convs2``) times
  ``RESIDUAL_GAIN``, so that the nine residual adds of a stage do not
  compound;
- each SnakeBeta's log alpha and log beta U(-LOG_SPREAD, LOG_SPREAD), a
  value of its own for every channel;
- every bias 0.

The random values come from one draw of one generator on the device.
"""

from __future__ import annotations

import math

import torch

from port_bench.harness.seeds import sub_seed
from port_bench.reference.bigvgan import BigVGANReference

PRE_GAIN = 32.0
RESIDUAL_GAIN = 0.5
LOG_SPREAD = 0.5


def bound(key: str, shape: tuple, v: dict) -> float:
    """The half width of the uniform draw of one weight, or of the
    ``LOG_SPREAD`` of a SnakeBeta parameter."""
    if key.endswith((".alpha", ".beta")):
        return LOG_SPREAD
    if key.startswith("ups."):  # a transposed conv's weight is (in, out, k)
        n = shape[0] * shape[2] / v["upsample_rates"][int(key.split(".")[1])]
    else:
        n = shape[1] * shape[2]
    b = math.sqrt(3.0 / n)
    if key == "conv_pre.weight":
        b *= PRE_GAIN
    elif ".convs2." in key:
        b *= RESIDUAL_GAIN
    return b


def state_dict(v: dict, n_mels: int, seed: int, device, dtype) -> dict[str, torch.Tensor]:
    """Every tensor of the generator's state dict in ``dtype`` on ``device``."""
    with torch.device("meta"):
        shapes = {k: tuple(t.shape) for k, t in BigVGANReference(v, n_mels).state_dict().items()}
    drawn = [k for k in shapes if k.endswith((".weight", ".alpha", ".beta"))]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "vocoder"))
    flat = torch.rand(sum(math.prod(shapes[k]) for k in drawn), generator=gen, device=device)
    out, at = {}, 0
    for k, shape in shapes.items():
        if k in drawn:
            n, b = math.prod(shape), bound(k, shape, v)
            t = flat[at:at + n].view(shape) * (2 * b) - b
            at += n
        else:  # biases
            t = torch.zeros(shape, device=device)
        out[k] = t.to(dtype)
    return out
