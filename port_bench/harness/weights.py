"""The weights of one run, made on the device from ``--seed``.

The benchmark makes the weights and hands the same values to the program
and to the reference: every matrix and kernel U(-1/sqrt(fan_in),
1/sqrt(fan_in)), the codebook U(0, 1), BOS N(0, 1), biases and running
means 0, running variances, BatchNorm scales and PSine amplitudes 1, PReLU
slopes 0.25, the attention temperatures sqrt(F) and sqrt(latent). The
random values come from one generator on the device in two large draws, so
the same seed gives the same weights on the same card.
"""

from __future__ import annotations

import math

import torch

from port_bench.harness.seeds import sub_seed
from port_bench.reference.model import Lip2SpeechReference


def state_dict(model_cfg: dict, seed: int, device, dtype) -> dict[str, torch.Tensor]:
    """Every tensor of the model's state dict, by the reference's names, in
    ``dtype`` on ``device`` (the BatchNorm counters int64)."""
    with torch.device("meta"):
        shapes = {k: (tuple(v.shape), v.dtype) for k, v in Lip2SpeechReference(model_cfg).state_dict().items()}
    uniform = [k for k, (s, _) in shapes.items() if len(s) >= 2 and not k.endswith("BOS")]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.rand(sum(math.prod(shapes[k][0]) for k in uniform), generator=gen, device=device)
    bos = torch.randn(shapes["decoder.BOS"][0], generator=gen, device=device)
    out, at = {}, 0
    for k, (shape, dt) in shapes.items():
        leaf = k.rsplit(".", 1)[-1]
        if dt == torch.int64:
            out[k] = torch.zeros(shape, dtype=dt, device=device)
            continue
        if k in uniform:
            n = math.prod(shape)
            u = flat[at:at + n].view(shape)
            at += n
            bound = 1.0 / math.sqrt(n // shape[0])
            t = u if leaf == "word_embeddings" else u * (2 * bound) - bound
        elif leaf == "BOS":
            t = bos
        elif leaf == "running_mean" or leaf.startswith("bias"):
            t = torch.zeros(shape, device=device)
        elif k == "decoder.temperature":
            t = torch.full(shape, math.sqrt(model_cfg["ffn_hidden_dim"]), device=device)
        elif k == "decoder.content.temperature":
            t = torch.full(shape, math.sqrt(model_cfg["content_latent_dim"]), device=device)
        elif k == "encoder.frontend3D.2.weight":
            t = torch.full(shape, 0.25, device=device)
        else:  # running variances, BatchNorm scales, PSine amplitudes
            t = torch.ones(shape, device=device)
        out[k] = t.to(dtype)
    return out
