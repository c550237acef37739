"""Training on staged batches: one train step after another.

A batch is what a loader hands over after ``collate``: uint8 mouth frames
and face crops, raw audio clips of lengths drawn uniformly from the traffic
file's range, their lengths, in pinned host memory; with its random draws
(the codebook's noise, the teacher draws, every dropout mask) on the card.
Each step is the port's: ``collate.to_device`` and ``prepare_batch`` on the
card, then ``train_step`` under the configuration's precision policy with
the traffic's tf ratio. A step fails if its loss is not finite or its
update was skipped. The traffic file gives the batch, the pool of distinct
batches (used in turn), the audio lengths, the tf ratio, the steps the
check follows and the steps the traced window holds.

``correct``: set-up makes one train state from the seed and drives it
through its first steps on distinct batches, through the window's own
call; that same state then runs the window. The reference follows those
steps from the same weights, batches and draws (``check``).
"""

from __future__ import annotations

import contextlib
import statistics
import time

import numpy as np
import torch

from port_bench.harness import compare, weights
from port_bench.harness.flops import codebook_slots
from port_bench.harness.runtime import Record, no_tf32, sync
from port_bench.harness.seeds import rng, sub_seed
from port_bench.harness.spec import port_config
from port_bench.harness.tracing import Tracer, host_timed
from port_bench.reference import train as ref_train
from port_bench.reference.model import Ctx, Lip2SpeechReference
from port_bench.reference.precision import RoundEverywhere, bf16, fp8

KIND = "train"
MOMENT_B1 = 0.9
# the program's spans that a traced run times by the host's clock in its measured window
HOST_SPANS = {"train.backward": ("lip2speech_torch.train.train_step", "backward")}


def make_pool(conf: dict, t: dict, seed: int, dev) -> list[dict]:
    """Distinct batches: the host buffers ``collate`` makes, pinned, and the
    step's draws on the device."""
    from lip2speech_torch.data.collate import collate

    cfg = port_config(conf)
    d, m = conf["data"], conf["model"]
    B, T, M = t["batch"], d["max_video_frames"], d["max_mel_frames"]
    host = rng(seed, "inputs")
    gen = torch.Generator(device=dev).manual_seed(sub_seed(seed, "draws"))
    lo = int(round(t["audio_min_frac"] * d["max_audio_samples"]))
    Fh, S = m["ffn_hidden_dim"], codebook_slots(T)
    chans = [m["postnet_embedding_dim"]] * (m["postnet_n_convolutions"] - 1) + [m["n_mels"]]

    def keep(shape, rate):
        return torch.rand(shape, generator=gen, device=dev) < (1.0 - rate)

    pool = []
    for _ in range(t["pool"]):
        samples = [{
            "mouth": host.integers(0, 256, (T, *d["mouth_size"], 3), dtype=np.uint8),
            "faces": host.integers(0, 256, (d["n_face_crops"], *d["face_size"], 3), dtype=np.uint8),
            "audio": (host.standard_normal(int(host.integers(lo, d["max_audio_samples"] + 1))) * 0.1
                      ).astype(np.float32),
        } for _ in range(B)]
        raw = {k: torch.from_numpy(v) for k, v in collate(samples, cfg.data).items()}
        if dev.type == "cuda":
            raw = {k: v.pin_memory() for k, v in raw.items()}
        u = torch.rand(B * S, m["content_vocab_size"], generator=gen, device=dev)
        draws = {
            "gumbel": -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny))),
            "teacher": torch.rand(M, generator=gen, device=dev),
            "prenet": keep((M, B, Fh // 2), m["prenet_dropout"]),
            "attention": keep((M, B, T), m["attention_dropout"]),
            "rnn": keep((M, B, Fh), m["decoder_rnn_dropout"]),
            "postnet": [keep((B, c, M), m["postnet_dropout"]) for c in chans],
            "encoder": keep((B, T, m["video_feature_dim"]), m["encoder_feature_dropout"]),
        }
        pool.append({"raw": raw, "draws": draws})
    return pool


def program_step(state, cfg, entry: dict, dev, tf_ratio: float, tracer: Tracer) -> dict:
    """One step through the port: the batch to the card, prepared there,
    and the train step. Returns its metrics (0-d tensors on the card)."""
    from lip2speech_torch.data.collate import prepare_batch, to_device
    from lip2speech_torch.train.train_step import train_step

    with tracer.span("bench.prepare"):
        batch = prepare_batch(to_device(entry["raw"], dev), cfg.audio, cfg.data)
    with tracer.span("bench.train_step"):
        return train_step(state, batch, tf_ratio, cfg, draws=entry["draws"])


def build_state(cfg, conf: dict, seed: int, dev):
    from lip2speech_torch.models.lip2speech import Lip2Speech
    from lip2speech_torch.train.train_step import create_train_state

    with torch.device("meta"):
        model = Lip2Speech(cfg.model)
    model = model.to_empty(device=dev)
    model.load_state_dict(weights.state_dict(conf["model"], seed, dev, torch.float32), strict=True)
    return create_train_state(cfg, model)


def trained_stats(model) -> dict:
    """The running statistics of the BatchNorms that train (not the face net's)."""
    return {k: v for k, v in model.named_buffers()
            if k.split(".", 1)[0] in ("encoder", "decoder") and k.endswith(("running_mean", "running_var"))}


def _leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def step_failed(metrics: dict) -> bool:
    return not bool(torch.isfinite(metrics["total"])) or int(metrics.get("notfinite_count", 0)) > 0


def first_steps(state, cfg, pool, dev, t: dict, tracer: Tracer) -> dict:
    """The check's steps, on distinct batches, through the window's call
    (they also warm it up): each step's loss and failure, the raw first
    gradient's leaf norms (the optimizer's first moment over 1 - b1, times
    the global norm over the clip that the step reports), and each leaf's
    and each trained statistic's change."""
    names = list(state.opt.names)
    params = dict(state.model.named_parameters())
    stats = trained_stats(state.model)
    p0 = {n: params[n].detach().clone() for n in names}
    s0 = {k: v.clone() for k, v in stats.items()}
    first = {"losses": [], "failed": []}
    for i in range(t["check_steps"]):
        m = program_step(state, cfg, pool[i], dev, t["tf_ratio"], tracer)
        first["losses"].append(float(m["total"]))
        first["failed"].append(step_failed(m))
        if i == 0:
            scale = max(1.0, float(m["grad_norm"]) / cfg.train.grad_clip)
            flat = state.opt.mu / (1 - MOMENT_B1) * scale
            first["grad"] = _leaf_norms(dict(zip(names, flat.split([params[n].numel() for n in names]))))
    first["change"] = _leaf_norms({n: params[n].detach() - p0[n] for n in names})
    first["stats"] = _leaf_norms({k: stats[k] - s0[k] for k in stats})
    return first


def run(cell, seed: int, seconds: float, trace: bool, dev, t_start: float) -> Record:
    t, conf = cell.traffic, cell.config
    cfg = port_config(conf)
    if cfg.train.bf16 != (t["precision"] == "bfloat16"):
        raise ValueError("the traffic's precision and the configuration's bf16 policy disagree")
    rec = Record(kind=KIND, cell=cell)
    state = build_state(cfg, conf, seed, dev)
    pool = make_pool(conf, t, seed, dev)
    tracer = Tracer()
    first = first_steps(state, cfg, pool, dev, t, tracer)
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rec.setup_s = time.time() - t_start
    outs = []
    with host_timed(rec.host_spans, HOST_SPANS) if trace else contextlib.nullcontext():
        t0 = time.perf_counter()
        i = t["check_steps"]
        while time.perf_counter() - t0 < seconds:
            start = time.perf_counter() - t0
            outs.append((start, program_step(state, cfg, pool[i % len(pool)], dev, t["tf_ratio"], tracer)))
            i += 1
        sync(dev)
        end = time.perf_counter() - t0
    rec.units = [(s, end, t["batch"], not step_failed(m)) for s, m in outs]
    rec.window_s = end
    if trace:
        tracer.hook(state.model.encoder, "bench.encoder")
        tracer.hook(state.model.decoder, "bench.decoder")
        with tracer.window(dev):
            for j in range(t["trace_units"]):
                program_step(state, cfg, pool[(i + j) % len(pool)], dev, t["tf_ratio"], tracer)
        rec.trace, rec.trace_units = tracer.summary, t["trace_units"]
    if dev.type == "cuda":
        rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))
    del state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings, ref = check(conf, t, seed, dev, pool, first)
    rec.correct, rec.checks = compare.verdict(readings, cell.limits)
    rec.correct = rec.correct and rec.failed == 0 and not any(first["failed"])
    rec.extra["leaves"] = {"program": first, "reference": ref}
    rec.extra["diagnostics"] = diagnostics(first, ref)
    return rec


ROUNDINGS = {"fp8": fp8, "bf16": bf16}


def reference_steps(conf: dict, t: dict, seed: int, dev, pool, q_name: str = "exact") -> dict:
    """The reference's first steps from the seed's weights on the pool's
    first batches and draws: their losses, the first raw gradient's leaf
    norms, the change of each leaf and of each BatchNorm statistic. With
    ``q_name`` "fp8" (the control) or "bf16" (the program's policy), every
    operand of a product, every result of the forward and every gradient
    of the backward is rounded to that type; the loss stays f32. In f32
    (``exact``) also each leaf's ``score_share``: the share of its first
    gradient that flows back through the AR loop's attention scores."""
    with torch.device("meta"):
        ref = Lip2SpeechReference(conf["model"])
    ref = ref.to_empty(device=dev)
    ref.load_state_dict(weights.state_dict(conf["model"], seed, dev, torch.float32), strict=True)
    ref.train()
    named = ref_train.optimised(ref)
    p0 = {n: p.detach().clone() for n, p in named}
    stats = trained_stats(ref)
    s0 = {k: v.clone() for k, v in stats.items()}
    opt = ref_train.AMSGrad([p for _, p in named], conf["train"])
    q = ROUNDINGS.get(q_name)
    out = {"losses": []}
    for i in range(t["check_steps"]):
        raw = {k: v.to(dev) for k, v in pool[i]["raw"].items()}
        batch = ref_train.prepare(raw, conf)
        if i == 0 and q is None:
            _, stopped = ref_train.gradients(ref, batch, pool[i]["draws"], conf, t["tf_ratio"],
                                             Ctx(train=True, score_grad=False))
        r = ref_train.train_step(ref, opt, batch, pool[i]["draws"], conf, t["tf_ratio"],
                                 q, RoundEverywhere(q) if q else None)
        out["losses"].append(r["losses"]["total"])
        if i == 0:
            out["grad"] = _leaf_norms(r["grads"])
            if q is None:
                out["score_share"] = {n: _share(g, s) for (n, g), s in zip(r["grads"].items(), stopped)}
                del stopped
    out["change"] = _leaf_norms({n: p.detach() - p0[n] for n, p in named})
    out["stats"] = _leaf_norms({k: stats[k] - s0[k] for k in stats})
    return out


def _share(g, stopped) -> float:
    """||g - stopped|| / ||g||; a leaf with no gradient has none to share."""
    if g is None:
        return 0.0
    diff = g if stopped is None else g - stopped
    return float(torch.linalg.vector_norm(diff.double()) / torch.linalg.vector_norm(g.double()).clamp(min=1e-300))


def moving(ref: dict) -> list[str]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's; the others (a conv bias in front of a train-mode
    BatchNorm) move by round-off alone."""
    median = statistics.median(ref["grad"].values())
    return [n for n, g in ref["grad"].items() if g >= 1e-3 * median]


def score_free(ref: dict) -> list[str]:
    """Moving leaves whose reference gradient does not flow back through the
    AR loop's attention scores (under 1e-4 of it does). At the model's
    initial temperatures the scores run to thousands and each softmax is
    all but one-hot, so the part of a gradient that flows back through them
    comes from rows near a tie, as exp(-gap); any rounding of the scores
    moves those gaps by tens (bf16's spacing there is 16-32) and that part
    by orders. The other leaves (the encoder, the banks, the query and the
    BiLSTM wholly; the loop's LSTMs, prenet and V in part) are compared by
    their change (``PERF.md``)."""
    return [n for n in moving(ref) if ref["score_share"][n] < 1e-4]


def readings_of(prog: dict, ref: dict) -> dict:
    """The gaps: the first step's total loss; the worst score-free leaf's
    gap of the raw first gradient; the median moving leaf's gap of the
    change after the check's steps; the median BatchNorm statistic's gap of
    its change. The change's and the statistics' worst leaves read a tenth
    or more on every seed in bf16, carried from the scores' gradient by
    Adam's normalisation into every later step (``PERF.md``), so their
    median is compared; the worst leaves, the median leaf of the whole raw
    gradient and every step's loss stay in ``diagnostics``."""
    grad = compare.leaf_gaps(prog["grad"], ref["grad"], score_free(ref))
    keep = moving(ref)
    change = compare.leaf_gaps(prog["change"], ref["change"], keep)
    stats = compare.leaf_gaps(prog["stats"], ref["stats"], list(ref["stats"]))
    return {
        "loss_rel": abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
        "grad_gap": max(grad.values()),
        "change_gap": statistics.median(change.values()),
        "stats_gap": statistics.median(stats.values()),
    }


def diagnostics(prog: dict, ref: dict) -> dict:
    """The readings this cell does not compare: every step's loss gap, the
    worst leaf of each kind over every moving leaf, and the median moving
    leaf's gap of the raw first gradient."""
    keep = moving(ref)
    worst = {}
    for key, names in (("grad", keep), ("change", keep), ("stats", list(ref["stats"]))):
        gaps = compare.leaf_gaps(prog[key], ref[key], names)
        n = max(gaps, key=gaps.get)
        worst[f"{key}_worst"] = [n, gaps[n]]
    worst["grad_median"] = statistics.median(compare.leaf_gaps(prog["grad"], ref["grad"], keep).values())
    worst["score_free_leaves"] = len(score_free(ref))
    worst["loss_rel_steps"] = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    return worst


def check(conf: dict, t: dict, seed: int, dev, pool, first: dict) -> tuple[dict, dict]:
    with no_tf32():
        ref = reference_steps(conf, t, seed, dev, pool)
    return readings_of(first, ref), ref

