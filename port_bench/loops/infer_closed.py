"""Inference under a closed loop: one client sends a request, waits for its
waveform, and sends the next.

A request is B clips: uint8 mouth frames (B, T, 96, 96, 3) and face crops
(B, n, 160, 160, 3) in pinned host memory, with its random draws (the
codebook's gumbel noise, Griffin-Lim's initial phases) on the card. It
goes through the port's path: the copy to the card, ``normalize_mouth`` and
``normalize_face``, ``Lip2Speech.forward`` free-running in the serving type
(the encoders, the face net, the decoder's encode, the AR kernel for every
step, the postnet), ``mel_to_audio`` on the mel prefix (NNLS, then
Griffin-Lim with its transforms in the serving type), and the waveform back
to the host. A request fails if its waveform is not finite or has another
shape. The traffic file gives the batch, the pool of distinct requests
(served in turn), the serving type, the mel prefix, the Griffin-Lim
iterations, how many requests the check samples, and how many the traced
window holds.

``correct``: once the window has closed, the reference recomputes a sample
of the served requests, drawn from the seed, from the same inputs and
weights (``check``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench.harness import compare, weights
from port_bench.harness.flops import codebook_slots
from port_bench.harness.runtime import Record, no_tf32, sync
from port_bench.harness.seeds import rng, sub_seed
from port_bench.harness.spec import port_config
from port_bench.harness.tracing import Tracer
from port_bench.reference import dsp
from port_bench.reference.model import Ctx, Lip2SpeechReference
from port_bench.reference.precision import bf16, exact, fp8
from port_bench.reference.train import normalize_face, normalize_mouth

KIND = "infer"


def to_host(x: torch.Tensor, dev) -> torch.Tensor:
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=dev.type == "cuda")
    return out.copy_(x)


def make_pool(conf: dict, t: dict, seed: int, dev) -> list[dict]:
    """The distinct requests, made on the device from the seed; the frames
    and crops then wait in pinned host memory."""
    d, m, a = conf["data"], conf["model"], conf["audio"]
    B, T = t["batch"], d["max_video_frames"]
    gen = torch.Generator(device=dev).manual_seed(sub_seed(seed, "inputs"))
    pool = []
    for _ in range(t["pool"]):
        mouth = torch.randint(0, 256, (B, T, *d["mouth_size"], 3), generator=gen, device=dev, dtype=torch.uint8)
        faces = torch.randint(0, 256, (B, d["n_face_crops"], *d["face_size"], 3), generator=gen, device=dev,
                              dtype=torch.uint8)
        u = torch.rand(B * codebook_slots(T), m["content_vocab_size"], generator=gen, device=dev)
        gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
        theta = dsp.uniform_phases((B, a["n_fft"] // 2 + 1, t["mel_prefix"]), gen, dev)
        pool.append({"mouth": to_host(mouth, dev), "faces": to_host(faces, dev), "gumbel": gumbel,
                     "theta": theta})
    return pool


def build_model(cfg, conf: dict, seed: int, dev, dtype):
    from lip2speech_torch.models.lip2speech import Lip2Speech

    with torch.device("meta"):
        model = Lip2Speech(cfg.model)
    model = model.to_empty(device=dev).to(dtype)
    model.load_state_dict(weights.state_dict(conf["model"], seed, dev, dtype), strict=True)
    return model.eval()


def program_serve(model, cfg, entry: dict, dev, dtype, t: dict, tracer: Tracer):
    """One request through the port: (outputs kept for the check, the
    waveform on the host, ok)."""
    from lip2speech_torch.ops import image
    from lip2speech_torch.ops.griffin_lim import mel_to_audio

    with tracer.span("bench.h2d"):
        mouth = entry["mouth"].to(dev, non_blocking=True)
        faces = entry["faces"].to(dev, non_blocking=True)
    with tracer.span("bench.normalize"):
        video = image.normalize_mouth(mouth).to(dtype)
        faces = image.normalize_face(faces).to(dtype)
    with tracer.span("bench.model"):
        out = model(video, faces, gumbel=entry["gumbel"])
    with tracer.span("bench.griffin_lim"):
        wav = mel_to_audio(out["mel_postnet"].float()[..., :t["mel_prefix"]], cfg.audio, n_iter=t["gl_iters"],
                           compute_dtype=None if dtype == torch.float32 else dtype, theta=entry["theta"])
    with tracer.span("bench.to_host"):
        finite = torch.isfinite(wav).all()
        wav_host = wav.to("cpu")
    want = (video.shape[0], (t["mel_prefix"] - 1) * cfg.audio.hop_length)
    ok = bool(finite) and tuple(wav_host.shape) == want
    kept = {k: out[k] for k in ("mel", "mel_postnet", "speaker_embedding")}
    return kept, wav_host, ok


class Reservoir:
    """A uniform sample of k of the requests offered, drawn from ``gen``."""

    def __init__(self, k: int, gen: np.random.Generator):
        self.k, self.gen, self.items, self.seen = k, gen, [], 0

    def offer(self, item):
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.gen.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def run(cell, seed: int, seconds: float, trace: bool, dev, t_start: float) -> Record:
    t, conf = cell.traffic, cell.config
    cfg = port_config(conf)
    dtype = getattr(torch, t["precision"])
    rec = Record(kind=KIND, cell=cell)
    model = build_model(cfg, conf, seed, dev, dtype)
    pool = make_pool(conf, t, seed, dev)
    tracer = Tracer()
    for entry in pool[:2]:  # every shape the window uses; the first call builds and packs the AR kernel
        program_serve(model, cfg, entry, dev, dtype, t, tracer)
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sample = Reservoir(t["check_requests"], rng(seed, "sample"))
    rec.setup_s = time.time() - t_start
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        start = time.perf_counter() - t0
        kept, wav, ok = program_serve(model, cfg, pool[i % len(pool)], dev, dtype, t, tracer)
        rec.units.append((start, time.perf_counter() - t0, t["batch"], ok))
        sample.offer((i % len(pool), kept, wav))
        i += 1
    rec.window_s = rec.units[-1][1]
    if trace:
        tracer.hook(model.encoder, "bench.encoder")
        tracer.hook(model.vgg_face, "bench.face_net")
        tracer.hook(model.decoder, "bench.decoder")
        with tracer.window(dev):
            for j in range(t["trace_units"]):
                program_serve(model, cfg, pool[(i + j) % len(pool)], dev, dtype, t, tracer)
        rec.trace, rec.trace_units = tracer.summary, t["trace_units"]
    if dev.type == "cuda":
        rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings, rows = check(conf, t, seed, dev, pool, sample.items)
    rec.extra["rows"] = {k: v.tolist() for k, v in rows.items()}
    rec.correct, rec.checks = compare.verdict(readings, cell.limits)
    rec.correct = rec.correct and rec.failed == 0
    return rec


def reference_model(conf: dict, seed: int, dev, dtype) -> Lip2SpeechReference:
    """The reference on the weights as served (in ``dtype``), computing in f32."""
    with torch.device("meta"):
        ref = Lip2SpeechReference(conf["model"])
    ref = ref.to_empty(device=dev)
    ref.load_state_dict({k: v.float() if v.is_floating_point() else v
                         for k, v in weights.state_dict(conf["model"], seed, dev, dtype).items()}, strict=True)
    return ref.eval()


def _rows(pool, items, key, dev):
    return torch.cat([pool[p][key].to(dev) for p, _, _ in items])


def control_outputs(conf: dict, t: dict, seed: int, dev, pool, items):
    """The reference with every product's operands in float8, put in the
    program's place on the same requests: what ``check`` would judge."""
    dtype = getattr(torch, t["precision"])
    serve_round = bf16 if dtype == torch.bfloat16 else exact
    ref = reference_model(conf, seed, dev, dtype)
    out_items = []
    with torch.no_grad():
        for p, _, _ in items:
            e = pool[p]
            video = serve_round(normalize_mouth(e["mouth"].to(dev)))
            faces = serve_round(normalize_face(e["faces"].to(dev)))
            out = ref.infer(Ctx(q=fp8), video, faces, e["gumbel"])
            wav = dsp.mel_to_audio(out["mel_postnet"][..., :t["mel_prefix"]], conf["audio"], e["theta"],
                                   t["gl_iters"], 16, q=fp8, transform=serve_round)
            out_items.append((p, out, wav.cpu()))
    del ref
    return out_items


def row_rel(p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """|p - r| / |r| of each row (L2 over the row's entries), in f64."""
    p, r = p.double().flatten(1), r.double().flatten(1)
    return (p - r).norm(dim=1) / r.norm(dim=1).clamp(min=1e-30)


def magnitudes(wav: torch.Tensor, a: dict) -> torch.Tensor:
    re, im = dsp.stft(wav.float(), a)
    return torch.sqrt(re * re + im * im)


def check(conf: dict, t: dict, seed: int, dev, pool, items) -> tuple[dict, dict]:
    """The reference over the sampled requests, in blocks of rows (clips),
    and the gaps of each row: the face net's embedding, the AR loop's mels
    and the postnet's mels (against the reference's own forward from the
    same inputs), and the waveform, judged against the reference's NNLS and
    Griffin-Lim run on the program's own mel prefix (the stage is followed
    from the program's mels): how far its magnitude spectrum lies from the
    NNLS target, next to how far the reference's does. Returns (the
    readings, every row's gaps): the worst row of the embedding and of the
    waveform; the root mean square over the rows of the mels, whose worst
    row is one clip's chaotic drift in a 300-step loop (``PERF.md``)."""
    dtype = getattr(torch, t["precision"])
    a = conf["audio"]
    serve_round = bf16 if dtype == torch.bfloat16 else exact
    with no_tf32():
        ref = reference_model(conf, seed, dev, dtype)
        S = codebook_slots(conf["data"]["max_video_frames"])
        mouth, faces = _rows(pool, items, "mouth", dev), _rows(pool, items, "faces", dev)
        gumbel = torch.cat([pool[p]["gumbel"].reshape(-1, S, pool[p]["gumbel"].shape[-1]) for p, _, _ in items])
        theta = _rows(pool, items, "theta", dev)
        prog = {k: torch.cat([o[k].float() for _, o, _ in items]) for k in ("speaker_embedding", "mel", "mel_postnet")}
        prog_wav = torch.cat([w.float() for _, _, w in items])
        rows = {k: [] for k in ("speaker_rel", "mel_rel", "postnet_rel", "wav_sc_gap")}
        n, step = mouth.shape[0], t["check_rows"]
        with torch.no_grad():
            for lo in range(0, n, step):
                sl = slice(lo, lo + step)
                video = serve_round(normalize_mouth(mouth[sl]))
                face = serve_round(normalize_face(faces[sl]))
                out = ref.infer(Ctx(), video, face, gumbel[sl].reshape(-1, gumbel.shape[-1]))
                p = {k: v[sl] for k, v in prog.items()}
                rows["speaker_rel"].append(row_rel(p["speaker_embedding"], out["speaker_embedding"]))
                rows["mel_rel"].append(row_rel(p["mel"], out["mel"]))
                rows["postnet_rel"].append(row_rel(p["mel_postnet"], out["mel_postnet"]))
                mel = p["mel_postnet"][..., :t["mel_prefix"]]
                ref_wav = dsp.mel_to_audio(mel, a, theta[sl], t["gl_iters"], 16, transform=serve_round)
                target = torch.sqrt(torch.clamp(dsp.mel_to_linear(torch.exp(mel), a, 16), min=1e-30))
                sc_p = row_rel(magnitudes(prog_wav[sl].to(dev), a), target)
                sc_r = row_rel(magnitudes(ref_wav, a), target)
                rows["wav_sc_gap"].append((sc_p - sc_r).abs() / sc_r)
        rows = {k: torch.cat(v).cpu() for k, v in rows.items()}
    readings = {
        "speaker_rel": float(rows["speaker_rel"].max()),
        "mel_rms": float(rows["mel_rel"].square().mean().sqrt()),
        "postnet_rms": float(rows["postnet_rel"].square().mean().sqrt()),
        "wav_sc_gap": float(rows["wav_sc_gap"].max()),
    }
    return readings, rows
