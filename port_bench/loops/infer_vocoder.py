"""Inference under a closed loop with the BigVGAN vocoder in Griffin-Lim's
place: one client sends a request, waits for its waveform, and sends the
next.

Every stage up to the mel is ``infer_closed``'s (its pool, its model and
its request path: the copy to the card, the normalisation,
``Lip2Speech.forward`` free-running in the serving type). The mel prefix
then goes through ``models.vocoder.mel_to_waveform`` with the generator
``models.vocoder.build_vocoder`` makes from the configuration's ``vocoder``
section, in the serving type, on the weights the benchmark makes from the
seed (``harness/vocoder_weights.py``), and the waveform goes back to the
host. A request fails if its waveform is not finite or not (B, mel prefix
x hop). The traffic file gives what ``infer_closed``'s does, less the
Griffin-Lim iterations. The traced window hooks the encoder, the face net
and the decoder as ``infer_closed``'s does, so that ``lrw.offline_b256``'s
per-layer metrics of those layers read the same ranges here.

``correct``: once the window has closed, the reference recomputes a sample
of the served requests, drawn from the seed (``check``): the face net's
embedding and the mels as ``infer_closed`` compares them, and
``vocoder_rel``, the worst clip's relative L2 gap of the program's signal
before the ``tanh`` (the output of ``conv_post``, kept by a hook) to the
reference generator's, both fed the program's own served mel prefix. The
gap is taken before the ``tanh``, which random weights may saturate.
"""

from __future__ import annotations

import sys
import time

import torch

from port_bench.harness import compare, vocoder_weights
from port_bench.harness.flops import codebook_slots
from port_bench.harness.runtime import Record, no_tf32, sync
from port_bench.harness.seeds import rng
from port_bench.harness.spec import port_config
from port_bench.harness.tracing import Tracer
from port_bench.loops.infer_closed import (Reservoir, _rows, build_model, make_pool, reference_model,
                                           row_rel)
from port_bench.reference.bigvgan import BigVGANReference
from port_bench.reference.model import Ctx
from port_bench.reference.precision import bf16, exact, fp8
from port_bench.reference.train import normalize_face, normalize_mouth

KIND = "infer"


def vocoder_config(conf: dict):
    """The port's Config with the configuration's vocoder section."""
    from lip2speech_torch.config import VocoderConfig

    return port_config(conf).replace(vocoder=VocoderConfig(**conf["vocoder"]))


def build_vocoder(cfg, conf: dict, seed: int, dev, dtype):
    """The port's generator, through its own constructor, on the seed's weights."""
    from lip2speech_torch.models import vocoder

    sd = vocoder_weights.state_dict(conf["vocoder"], conf["audio"]["n_mels"], seed, dev, dtype)
    return vocoder.build_vocoder(cfg, dev, dtype, checkpoint=sd)


def program_serve(model, gen, cfg, entry: dict, dev, dtype, t: dict, tracer: Tracer, signal: dict):
    """One request through the port: (outputs kept for the check, the
    waveform on the host, ok). ``signal`` holds the generator's last output
    before the ``tanh``."""
    from lip2speech_torch.models.vocoder import mel_to_waveform
    from lip2speech_torch.ops import image

    with tracer.span("bench.h2d"):
        mouth = entry["mouth"].to(dev, non_blocking=True)
        faces = entry["faces"].to(dev, non_blocking=True)
    with tracer.span("bench.normalize"):
        video = image.normalize_mouth(mouth).to(dtype)
        faces = image.normalize_face(faces).to(dtype)
    with tracer.span("bench.model"):
        out = model(video, faces, gumbel=entry["gumbel"])
    with tracer.span("bench.vocoder"):
        wav = mel_to_waveform(out["mel_postnet"][..., :t["mel_prefix"]], cfg, gen)
    with tracer.span("bench.to_host"):
        finite = torch.isfinite(wav).all()
        wav_host = wav.to("cpu")
    want = (video.shape[0], t["mel_prefix"] * cfg.audio.hop_length)
    ok = bool(finite) and tuple(wav_host.shape) == want
    kept = {k: out[k] for k in ("mel", "mel_postnet", "speaker_embedding")}
    kept["signal"] = signal["out"][:, 0]
    return kept, wav_host, ok


def run(cell, seed: int, seconds: float, trace: bool, dev, t_start: float) -> Record:
    t, conf = cell.traffic, cell.config
    cfg = vocoder_config(conf)
    dtype = getattr(torch, t["precision"])
    rec = Record(kind=KIND, cell=cell)
    model = build_model(cfg, conf, seed, dev, dtype)
    gen = build_vocoder(cfg, conf, seed, dev, dtype)
    signal = {}
    gen.conv_post.register_forward_hook(lambda mod, args, out: signal.__setitem__("out", out))
    pool = make_pool(conf, t, seed, dev)
    tracer = Tracer()

    def serve(entry):
        return program_serve(model, gen, cfg, entry, dev, dtype, t, tracer, signal)

    for entry in pool[:2]:  # every shape the window uses; the first call builds and packs the AR kernel
        serve(entry)
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sample = Reservoir(t["check_requests"], rng(seed, "sample"))
    rec.setup_s = time.time() - t_start
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        start = time.perf_counter() - t0
        kept, wav, ok = serve(pool[i % len(pool)])
        rec.units.append((start, time.perf_counter() - t0, t["batch"], ok))
        sample.offer((i % len(pool), kept, wav))
        i += 1
    rec.window_s = rec.units[-1][1]
    if trace:  # the hooks of infer_closed's traced window, read by the offline per-layer metrics
        tracer.hook(model.encoder, "bench.encoder")
        tracer.hook(model.vgg_face, "bench.face_net")
        tracer.hook(model.decoder, "bench.decoder")
        with tracer.window(dev):
            for j in range(t["trace_units"]):
                serve(pool[(i + j) % len(pool)])
        rec.trace, rec.trace_units = tracer.summary, t["trace_units"]
    if dev.type == "cuda":
        rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))
    del model, gen
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings, rows = check(conf, t, seed, dev, pool, sample.items)
    rec.extra["rows"] = {k: v.tolist() for k, v in rows.items()}
    for name, key in (("vocoder signal (before the tanh)", "signal_rms"), ("served mel prefix", "mel_in_rms")):
        print(f"{name} rms, program, each clip checked: "
              f"{float(rows[key].min())!r} to {float(rows[key].max())!r}", file=sys.stderr)
    rec.correct, rec.checks = compare.verdict(readings, cell.limits)
    rec.correct = rec.correct and rec.failed == 0
    return rec


def reference_vocoder(conf: dict, seed: int, dev, dtype) -> BigVGANReference:
    """The reference generator on the weights as served (in ``dtype``), computing in f32."""
    with torch.device("meta"):
        ref = BigVGANReference(conf["vocoder"], conf["audio"]["n_mels"])
    ref = ref.to_empty(device=dev)
    sd = vocoder_weights.state_dict(conf["vocoder"], conf["audio"]["n_mels"], seed, dev, dtype)
    ref.load_state_dict({k: v.float() for k, v in sd.items()}, strict=True)
    return ref.eval()


def control_outputs(conf: dict, t: dict, seed: int, dev, pool, items):
    """The reference with every product's operands in float8, Lip2Speech
    and the generator, put in the program's place on the same requests:
    what ``check`` would judge."""
    dtype = getattr(torch, t["precision"])
    serve_round = bf16 if dtype == torch.bfloat16 else exact
    ref = reference_model(conf, seed, dev, dtype)
    gen = reference_vocoder(conf, seed, dev, dtype)
    out_items = []
    with torch.no_grad():
        for p, _, _ in items:
            e = pool[p]
            out = ref.infer(Ctx(q=fp8), serve_round(normalize_mouth(e["mouth"].to(dev))),
                            serve_round(normalize_face(e["faces"].to(dev))), e["gumbel"])
            out["signal"] = gen.signal(out["mel_postnet"][..., :t["mel_prefix"]], q=fp8, rows=t["check_rows"])
            out_items.append((p, out, torch.tanh(out["signal"]).cpu()))
    del ref, gen
    return out_items


def check(conf: dict, t: dict, seed: int, dev, pool, items) -> tuple[dict, dict]:
    """The reference over the sampled requests, in blocks of rows (clips):
    the face net's embedding (worst clip), the loop's and the postnet's mels
    (root mean square over the clips), both against the reference's own
    forward from the same inputs, and ``vocoder_rel``: the generator's
    signal before the ``tanh`` (worst clip) against the reference
    generator's on the program's own mel prefix. Returns (the readings,
    every row's gaps, with each row's signal rms and its mel prefix's)."""
    dtype = getattr(torch, t["precision"])
    serve_round = bf16 if dtype == torch.bfloat16 else exact
    keys = ("speaker_embedding", "mel", "mel_postnet", "signal")
    with no_tf32():
        ref = reference_model(conf, seed, dev, dtype)
        gen = reference_vocoder(conf, seed, dev, dtype)
        S = codebook_slots(conf["data"]["max_video_frames"])
        mouth, faces = _rows(pool, items, "mouth", dev), _rows(pool, items, "faces", dev)
        gumbel = torch.cat([pool[p]["gumbel"].reshape(-1, S, pool[p]["gumbel"].shape[-1]) for p, _, _ in items])
        prog = {k: torch.cat([o[k].float() for _, o, _ in items]) for k in keys}
        rows = {k: [] for k in ("speaker_rel", "mel_rel", "postnet_rel", "vocoder_rel", "signal_rms", "mel_in_rms")}
        n, step = mouth.shape[0], t["check_rows"]
        with torch.no_grad():
            for lo in range(0, n, step):
                sl = slice(lo, lo + step)
                out = ref.infer(Ctx(), serve_round(normalize_mouth(mouth[sl])),
                                serve_round(normalize_face(faces[sl])), gumbel[sl].reshape(-1, gumbel.shape[-1]))
                p = {k: v[sl] for k, v in prog.items()}
                rows["speaker_rel"].append(row_rel(p["speaker_embedding"], out["speaker_embedding"]))
                rows["mel_rel"].append(row_rel(p["mel"], out["mel"]))
                rows["postnet_rel"].append(row_rel(p["mel_postnet"], out["mel_postnet"]))
                want = gen.signal(p["mel_postnet"][..., :t["mel_prefix"]], rows=step)
                rows["vocoder_rel"].append(row_rel(p["signal"], want))
                rows["signal_rms"].append(p["signal"].double().square().mean(dim=1).sqrt())
                mel_in = p["mel_postnet"][..., :t["mel_prefix"]].double()
                rows["mel_in_rms"].append(mel_in.square().mean(dim=(1, 2)).sqrt())
        rows = {k: torch.cat(v).cpu() for k, v in rows.items()}
    readings = {
        "speaker_rel": float(rows["speaker_rel"].max()),
        "mel_rms": float(rows["mel_rel"].square().mean().sqrt()),
        "postnet_rms": float(rows["postnet_rel"].square().mean().sqrt()),
        "vocoder_rel": float(rows["vocoder_rel"].max()),
    }
    return readings, rows


def control(cell, seed: int, dev) -> tuple[dict, dict]:
    """The readings of the float8 control at the cell's size (``control_outputs``)."""
    pool = make_pool(cell.config, cell.traffic, seed, dev)
    items = [(p, None, None) for p in range(min(cell.traffic["check_requests"], len(pool)))]
    served = control_outputs(cell.config, cell.traffic, seed, dev, pool, items)
    readings, rows = check(cell.config, cell.traffic, seed, dev, pool, served)
    return readings, {k: v.tolist() for k, v in rows.items()}
