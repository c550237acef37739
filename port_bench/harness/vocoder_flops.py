"""The operations and bytes of a BigVGAN request, from its shapes.

Counted by the benchmark, never by the program, in closed form:

- ``vocoder_flops``: the generator's convolutions, 2 operations a
  multiply-add (``conv_pre``, each transposed conv, the AMP blocks' dilated
  and plain convs, ``conv_post``). The anti-aliasing filters and the
  elementwise work are left out, as ``flops.py`` leaves out elementwise
  work. At the published widths: 126 C^2 multiply-adds a position in each
  stage's AMP blocks, 1.80 GFLOP a mel frame in all.
- ``activation_work``: every anti-aliased activation (18 a stage, and the
  last), its input read once and its output written once at the serving
  type, and its operations: the 2x upsample's polyphase FIR (2 outputs of
  6 taps an input sample), SnakeBeta at the doubled rate (5 operations a
  sample: scale, sine, square, scale, add) and the 12-tap low-pass at the
  output rate: 58 operations an input sample.
- ``lip2speech_flops``: the free-running Lip2Speech forward that makes the
  mel, counted as ``flops.infer_flops`` counts it, without NNLS and
  Griffin-Lim.
"""

from __future__ import annotations

import torch

from port_bench.harness import flops
from port_bench.reference.model import Ctx

AA_OPS_PER_SAMPLE = 2 * 6 * 2 + 2 * 5 + 12 * 2


def stages(v: dict, n_frames: int):
    """(channels, positions) of each stage's AMP blocks for ``n_frames`` mel frames."""
    c, length = v["upsample_initial_channel"], n_frames
    for u in v["upsample_rates"]:
        c, length = c // 2, length * u
        yield c, length


def vocoder_flops(v: dict, n_mels: int, B: int, M: int) -> float:
    """Operations of the generator's convolutions on B clips of M mel frames."""
    c0 = v["upsample_initial_channel"]
    macs = n_mels * c0 * 7 * M  # conv_pre
    c_in, length = c0, M
    for (c, out_len), k in zip(stages(v, M), v["upsample_kernel_sizes"]):
        macs += c_in * c * k * length  # each input sample scatters k taps
        per_kernel = sum(2 * len(d) * k_r for k_r, d in zip(v["resblock_kernel_sizes"],
                                                            v["resblock_dilation_sizes"]))
        macs += per_kernel * c * c * out_len
        c_in, length = c, out_len
    macs += c_in * 1 * 7 * length  # conv_post
    return 2.0 * B * macs


def activation_elements(v: dict, B: int, M: int) -> int:
    """Input samples (channels x positions x clips) of every anti-aliased activation."""
    per_stage = 2 * sum(len(d) for d in v["resblock_dilation_sizes"])
    total, last = 0, None
    for c, length in stages(v, M):
        total += per_stage * c * length
        last = c * length
    return B * (total + last)


def activation_work(v: dict, B: int, M: int, elem_bytes: int) -> tuple[float, float]:
    """(operations, bytes) of every anti-aliased activation of a request."""
    n = activation_elements(v, B, M)
    return float(AA_OPS_PER_SAMPLE * n), float(2 * elem_bytes * n)


def lip2speech_flops(conf: dict, B: int) -> float:
    m, d = conf["model"], conf["data"]
    T = d["max_video_frames"]
    ref = flops._meta_model(m)
    meta = torch.device("meta")

    def run():
        video = torch.empty(B, T, *d["mouth_size"], 3, device=meta)
        faces = torch.empty(B, d["n_face_crops"], *d["face_size"], 3, device=meta)
        gumbel = torch.empty(B * flops.codebook_slots(T), m["content_vocab_size"], device=meta)
        with torch.no_grad():
            ref.infer(Ctx(), video, faces, gumbel)

    return flops.count(run)


def request_flops(conf: dict, B: int, mel_prefix: int) -> float:
    """One request: the Lip2Speech forward and the generator on its mel prefix."""
    return lip2speech_flops(conf, B) + vocoder_flops(conf["vocoder"], conf["audio"]["n_mels"], B, mel_prefix)
