"""The operations and bytes of the work a cell does, from its shapes.

Counted by the benchmark, never by the program, so a count stays the same
whatever implements the work: ``count`` runs the plain reference on the
meta device under ``torch.utils.flop_counter.FlopCounterMode`` (every
matrix product and convolution, the training backward included; the
elementwise work is not counted), and ``ar_decode_work`` gives the AR
loop's operations and bytes in closed form, each input read once and each
output written once.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.reference import dsp
from port_bench.reference.model import Ctx, Lip2SpeechReference

# published NVIDIA H100 SXM peaks (dense): bf16 tensor cores, f32 without them, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def codebook_slots(T: int) -> int:
    """The content codebook's slots S for T encoder frames."""
    return min(T // k if T >= k else 1 for k in (1, 3, 5, 7))


def ar_decode_work(m: dict, B: int, T: int, S: int, M: int, weight_bytes: int) -> tuple[float, float]:
    """(operations, bytes) of one free-running AR decode of M steps."""
    F, H, L, NM = m["ffn_hidden_dim"], m["ffn_hidden_dim"] // 2, m["content_latent_dim"], m["n_mels"]
    mat = NM * H + H * H + 2 * F * F + F * H + 2 * F * L + 2 * (2 * F * 4 * F) + F * NM + 2 * F
    vec = 3 * H + 2 * H + 2 * F + H + L + 2 * 4 * F + NM + 1
    flops = M * B * (2 * mat + 2 * 2 * T * F + 2 * 2 * S * L)
    inputs = (mat * weight_bytes + vec * 4 + 2 * B * F * 4 + 2 * B * T * F * weight_bytes
              + 2 * B * S * L * weight_bytes + B * F * 4 + B * NM * 4 + M * F * 4 + 8)
    outputs = M * B * (NM + 1 + T) * 4
    return float(flops), float(inputs + outputs)


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the memory's bandwidth."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def count(fn) -> float:
    with FlopCounterMode(display=False) as c:
        fn()
    return float(c.get_total_flops())


def _meta_model(m: dict) -> Lip2SpeechReference:
    with torch.device("meta"):
        return Lip2SpeechReference(m)


def infer_flops(conf: dict, B: int, mel_prefix: int, gl_iters: int) -> float:
    """One request: the free-running model and NNLS + Griffin-Lim."""
    m, d, a = conf["model"], conf["data"], conf["audio"]
    T = d["max_video_frames"]
    ref = _meta_model(m)
    meta = torch.device("meta")

    def run():
        video = torch.empty(B, T, *d["mouth_size"], 3, device=meta)
        faces = torch.empty(B, d["n_face_crops"], *d["face_size"], 3, device=meta)
        gumbel = torch.empty(B * codebook_slots(T), m["content_vocab_size"], device=meta)
        with torch.no_grad():
            out = ref.infer(Ctx(), video, faces, gumbel)
            theta = torch.empty(B, a["n_fft"] // 2 + 1, mel_prefix, device=meta)
            dsp.mel_to_audio(out["mel_postnet"][..., :mel_prefix], a, theta, gl_iters, 16)

    return count(run)


def ar_loop_flops(m: dict, B: int, T: int, M: int) -> float:
    """The free-running AR loop alone, as the reference computes it."""
    ref = _meta_model(m)
    S = codebook_slots(T)
    F, L = m["ffn_hidden_dim"], m["content_latent_dim"]
    meta = torch.device("meta")
    enc = {"k": torch.empty(B, T, F, device=meta), "v": torch.empty(B, T, F, device=meta),
           "content_key": torch.empty(B, S, L, device=meta), "content_value": torch.empty(B, S, L, device=meta),
           "hidden": torch.empty(2, B, F, device=meta), "encoder_cell": torch.empty(B, F, device=meta)}
    with torch.no_grad():
        return count(lambda: ref.decoder.loop(Ctx(), enc, M))


def train_flops(conf: dict, B: int, tf_ratio: float) -> float:
    """One train step's forward and backward (the optimizer's elementwise
    update is not counted)."""
    from port_bench.reference.train import loss_terms, optimised

    m, d = conf["model"], conf["data"]
    T, M = d["max_video_frames"], d["max_mel_frames"]
    ref = _meta_model(m)
    meta = torch.device("meta")
    S = codebook_slots(T)
    Fh = m["ffn_hidden_dim"]
    chans = [m["postnet_embedding_dim"]] * (m["postnet_n_convolutions"] - 1) + [m["n_mels"]]
    draws = {
        "gumbel": torch.empty(B * S, m["content_vocab_size"], device=meta),
        "teacher": torch.empty(M, device=meta),
        "prenet": torch.empty(M, B, Fh // 2, dtype=torch.bool, device=meta),
        "attention": torch.empty(M, B, T, dtype=torch.bool, device=meta),
        "rnn": torch.empty(M, B, Fh, dtype=torch.bool, device=meta),
        "postnet": [torch.empty(B, c, M, dtype=torch.bool, device=meta) for c in chans],
        "encoder": torch.empty(B, T, m["video_feature_dim"], dtype=torch.bool, device=meta),
    }

    def run():
        video = torch.empty(B, T, *d["mouth_size"], 3, device=meta)
        faces = torch.empty(B, d["n_face_crops"], *d["face_size"], 3, device=meta)
        mel = torch.empty(B, m["n_mels"], M, device=meta)
        gate = torch.empty(B, M, device=meta)
        out = ref.teacher_forced(Ctx(train=True), video, faces, mel, tf_ratio, draws)
        total = loss_terms(out, mel, gate, conf["train"])["total"]
        torch.autograd.grad(total, [p for _, p in optimised(ref)], allow_unused=True)

    return count(run)
