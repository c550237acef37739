#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Phases, each of which ends the run with a non-zero exit when it fails:

1. build the hand-written CUDA kernel(s) from ``lip2speech_torch/csrc``;
2. hold the AR-decode kernel against its plain PyTorch version at the
   default widths and 300 steps, B in {1, 4, 8, 64, 256}, with f32 weights
   (TF32 off) and with bf16 weights, and time both with CUDA events; print
   the kernel's per-stage times (its stage timer) at B=4 and B=256, bf16;
3. drive the port's inference path (random weights from a seeded
   ``torch.Generator``, default Config, bf16): B=4 requests of 29 mouth
   frames and two face crops -> waveform, counting the kernel's launches;
   check one f32 request on the GPU against the same request on the CPU;
   time a batch at B=4 and B=256, checking that the kernel's weights are
   not packed again; run one long video of about 3 chunks;
4. train: the training step at full width (default Config, bf16 policy,
   B=64, 29 mouth frames, two 160x160 face crops through the frozen face
   net, M=80, tf_ratio 0.5): a seeded batch through ``collate`` on the host
   and ``prepare_batch`` on the card; three steps (finite losses, no
   skipped step, trainable weights moved, the face net bit-identical, the
   step count); the median time of 5 steps with the peak memory; one B=4
   inference on the trained weights, which must pack the AR weights again
   exactly once and agree with the plain decode; one f32 step on the GPU
   against the same step on the CPU, both held against an f64 step (B=2,
   same draws), and the f64 step on the GPU against the CPU's;
5. the training entry point: a synthetic LRW fixture (128 train and 64
   test clips of 29 frames, 19456 audio samples, over 8 words) written by
   the port's ``make_sample_lrw`` in a temporary directory; the loader
   alone over the train split; ``cli.train.train`` at full width (default
   Config, bf16 policy, B=64, loader threads ``min(64, os.cpu_count())``)
   for 6 steps with one eval tick (2 batches of 32 through the AR kernel,
   M=80) and its checkpoint, one step profiled; 4 steps each with 2 and 4
   loader threads; a second call that resumes from the checkpoint for 2
   more steps; the same step on a staged batch (``--reuse_first_batch`` on
   the 64 test clips); ``cli.evaluate`` on the checkpoint over the test
   split. Checks:
   finite losses, the resume's step and best score, ``metrics.jsonl``'s
   train scalars and ``eval/estoi``, one kernel launch per eval batch, the
   kernel against its plain version on one eval batch (f32), a finite
   evaluation, and the device ESTOI against the host's on one batch.
   Prints the step time with the loader and on the staged batch, the
   loader's host time per batch and its stalls, the eval tick split into
   forward, Griffin-Lim and metric, and the idle share of a profiled step;
6. adversarial training (WGAN critic): ``cli.train`` with
   ``train.adversarial=true`` on phase 5's fixture at full width (default
   Config, bf16 policy, B=64) for 6 steps with one eval tick through the AR
   kernel, then 6 adversarial and 6 plain steps each on a staged batch
   (``--reuse_first_batch`` on the test split). Checks: ``g_loss``,
   ``g_d_fm_loss`` and ``d_loss`` in ``metrics.jsonl``, every value finite,
   ``d_loss`` moving, every critic parameter within 0.01, one kernel launch
   per eval batch; and one f32 critic step and the generator terms (with
   their gradient to the fake mel) on the GPU against the same on the CPU
   (``ADV_*``). Prints the adversarial and the plain staged step's ms, the
   critic step's ms alone, the peak memory and the eval tick's launches;
7. the demo and long-video entry points at full width on a fixture of 4
   test clips: ``cli.demo`` with ``--encoding face`` and ``--encoding voice``
   (2 clips each, B=1, 300 decoder steps, 64 Griffin-Lim iterations) and
   ``cli.synthesize --from_lrw --n_clips 4`` (one video of 4 clips, its
   chunks decoded as one batch). Checks: every file written, every
   waveform finite and not empty, one kernel launch per clip (per video)
   and one weight pack per run. Prints ms per clip;
8. the WILD, GRID and AVSpeech corpora: fixtures written by the port's
   writers in a temporary directory (64 WILD segments of 50 frames and 2 s
   of audio, 16 GRID clips in MJPG ``.avi``, 16 AVSpeech clips in ``.mp4``,
   each with tilted landmarks); ``cli.train --dataset WILD`` at full width
   (default Config at the 2-second bucket: 50 frames, 32000 samples, 126
   mel frames; bf16 policy, B=64) for 4 steps with one eval tick, whose 2
   batches of 32 decode through the AR kernel at T=50, M=126, then 4 steps
   on a staged batch (``--reuse_first_batch``); the kernel against its
   plain version on one such eval batch (``TOL['float32']``);
   ``cli.evaluate --dataset GRID`` and ``--dataset AVSpeech`` at the default
   bucket. Checks: finite losses, one eval record, one kernel launch per
   eval batch, a finite score over every clip. Prints the step's ms with
   the loader and on the staged batch, the loader's host ms a batch and the
   eval tick's ms;
9. speaker pretraining: an AVSpeechFace fixture of 48 train and 2 test
   clips; ``cli.speaker_train`` at full width (InceptionResnetV1 at
   160x160, the face decoder to 160, the voice encoder on 32000 samples;
   f32, B=64, the 48 clips repeated to fill the batch) for 4 steps and its
   checkpoint, then ``cli.speaker_test``. Checks: finite losses and
   ``grad_norm``, ``t`` <= 100, the checkpoint and the test's files, finite
   embeddings; and one f32 speaker step (losses, new BatchNorm statistics,
   gradients) on the GPU against the same step on the CPU (B=4, same
   weights, batch and draws), each held against an f64 step on its own
   ReLU kink sides as phase 4 holds the train step (``TRAIN_*``). Prints ms
   a step, the peak memory and the losses;
10. the face detector and the preprocessing tools, on the repo's trained
   weights (``lip2speech_tpu/detect/weights/*.npz``, read by path):
   RFB-320's scores and boxes on the card against the CPU on 32 seeded
   frames of 256x256 through the host resize to 240x320 (``DETECT_TOL``),
   the landmark net on 32 seeded 112x112 crops (``LANDMARK_TOL``), and
   ``FaceDetector`` at the 99.9th percentile of the frames' face scores
   (the same None pattern, boxes and landmarks within 1 px);
   ``prep.face_extractor`` over a 64-frame MJPG ``.avi`` (batch 32, its
   sidecar against the CPU detector's) and a resuming pass;
   ``prep.wild_preprocess.write_segment`` on a 2-second segment with its
   wav beside it; ``prep.speaker_preprocess.video_to_frames`` and
   ``prep.resample.convert_sampling_rate`` on a 22,050 Hz wav. Prints ms
   per 32-frame detector batch and per landmark forward
   (``utils.devtime.device_time``) and frames/s through the extractor.

Timings print with the card's name and power limit. The line before the
last is a JSON object listing each kernel; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside this file, it exits non-zero and prints no result.

Usage: python3 chip_smoke.py [--profile | --kernel-only | --train-only | --cli-only |
                              --adv-only | --demo-only | --corpora-only | --speaker-only |
                              --prep-only]

``--profile`` adds, for each timed batch and for a train step, the device
time by kernel of one batch (torch.profiler) and the device's idle share.
``--kernel-only`` runs phases 1 and 2 alone at B in {4, 256} (with the
per-stage times) and prints no result line; ``--train-only`` runs phases 1
and 4, ``--cli-only`` phases 1 and 5, ``--adv-only`` phases 1 and 6 and
``--demo-only`` phases 1 and 7, ``--corpora-only`` phases 1 and 8 and
``--speaker-only`` phases 1 and 9, ``--prep-only`` phases 1 and 10, and none
of them prints a result line.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 1234
KERNEL_BATCHES = (1, 4, 8, 64, 256)
MAIN_B = 4
TIMED_BATCHES = (MAIN_B, 256)
GL_ITERS = 32
MEL_FRAMES = 80
LONG_VIDEO_FRAMES = 80  # three 29-frame chunks
# published H100 SXM peaks (dense): bf16 tensor cores, f32 without them, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# kernel vs plain version on the same inputs, 300 recurrent steps, max
# absolute error on (mels, stop logits, attention weights):
# f32: only the summation order differs (~1e-7 relative per product) and the
#   recurrence carries it forward; the attention softmax is sharp (scores
#   are scaled by a temperature of sqrt(512)), so its weights move ~100x
#   more than the mels.
# bf16: every product input is rounded to bf16 in both; an f32 difference
#   in the last bit can move a rounding by one bf16 step (2^-8 relative),
#   and that step is carried forward.
TOL = {"float32": (1e-4, 1e-4, 2e-3), "bfloat16": (5e-3, 5e-3, 0.15)}
# f32 pipeline on the GPU vs the CPU (cuDNN convs with TF32 off, the kernel
# vs the plain loop, postnet): mel_postnet within 2e-2 absolute
E2E_MEL_TOL = 2e-2
# phase 4, training: the recipe batch (bench.py:65), tf_ratio of bench.py:247
TRAIN_B = 64
TRAIN_STEPS = 3
TRAIN_TIMED = 5
TRAIN_TF = 0.5
# one f32 train step (TF32 off) on the GPU vs the same step on the CPU, same
# weights, batch and draws, B=2 at full width. Each is held against an f64
# step on the CPU that takes the f32 step's side at every ReLU/PReLU kink of
# the video encoder: a unit whose input lies within f32 rounding of 0 can
# land on the other side in f32, and each such unit moves its channel's
# gradients by a whole element's cotangent. Measured on an H100 machine
# (``train_gpu_vs_cpu`` prints it): 33 (CPU) and 38 (GPU) of 15.7M kinks
# flip; against the free f64 step the encoder's gradients are then up to
# 2.4e-2 (CPU) and 4.5e-2 (GPU) of a tensor's max off, the same with cuDNN
# limited to deterministic algorithms or off; on their own kink sides
# 2.4e-3 and 4.7e-3, about the error of the cotangent reaching the encoder
# (2.0e-3 and 2.5e-3 after the 80-step loop's backward).
# Each of the GPU's losses, gradients and new BatchNorm statistics must be
# as close to its f64 step as the CPU's is to its own, within a factor
# TRAIN_F32_FACTOR, plus TRAIN_REL of the tensor's max (a loss: of itself)
# and TRAIN_FLOOR of the largest value of its kind (for tensors that are 0
# up to rounding, such as the gradients of conv biases in front of a
# train-mode BatchNorm).
TRAIN_F32_FACTOR = 4.0
TRAIN_REL = 1e-4
TRAIN_FLOOR = 1e-6
# the same step in f64 on the GPU against the CPU's f64 step: every loss,
# statistic and gradient within TRAIN_F64_REL of the tensor's max (plus 1%
# of the largest of its kind); 7.4e-12 measured, on an encoder gradient
TRAIN_F64_REL = 1e-9
# phase 5, the training entry point: the fixture's clips and the runs' steps
CLI_TRAIN_CLIPS, CLI_TEST_CLIPS = 128, 64
CLI_SAMPLES = 19456
CLI_STEPS = 6  # the eval tick at the last; step 1 warms up, the last is profiled
CLI_RESUMED_STEPS = 2
CLI_EVAL_BATCHES = 2
# the step with fewer loader threads than the default min(B, CPU count)
CLI_THREAD_SWEEP = (2, 4)
CLI_SWEEP_STEPS = 4
CLI_WORDS = 8  # the fixture's words, written in parallel
# the device ESTOI (float64) against the host's on the same waveforms: the
# bound of tests/test_torch_estoi.py (~4e-11 read on an H100)
ESTOI_TOL = 1e-5
# phase 6: one f32 critic step (TF32 off) and the generator terms on the GPU
# against the CPU, same critic, mels, speaker embedding and patch (B=8, 80
# frames): the same products summed in another order, which the CPU tests
# hold between the port and JAX at the same bounds: the critic's loss and
# the generator terms rtol ADV_RTOL (plus 1e-6), the gradient to the fake
# mel and the new statistics within ADV_RTOL of the tensor's max; an RMSprop
# step moves an entry by up to lr * sqrt(10) either way, so the parameters
# are held by their change: the same sign on ADV_SIGN of the entries the
# CPU moved by more than lr / 2, and within ADV_DELTA in L2 norm
ADV_RTOL, ADV_SIGN, ADV_DELTA = 1e-4, 0.999, 1e-3
ADV_B = 8
ADV_TIMED = 5
# phase 7: the demo's clips for each encoding, and synthesize's clips
DEMO_CLIPS, SYNTH_CLIPS = 2, 4
# phase 8: WILD's 2-second bucket (50 frames at 25 fps, 2 s at 16 kHz, and
# 1 + 32000 // 256 mel frames), the fixtures' clips and the training steps
WILD_BUCKET = dict(max_video_frames=50, max_audio_samples=32000, max_mel_frames=126)
WILD_CLIPS, STREAM_CLIPS = 64, 16
CORPUS_STEPS = 4  # the eval tick at the last; step 1 warms up
# phase 9: the AVSpeechFace fixture, the CLI's steps, the GPU-vs-CPU batch
SPEAKER_CLIPS, SPEAKER_STEPS, SPEAKER_CHECK_B = 48, 4, 4
# phase 10: the face detector on the repo's trained weights, 32 seeded
# frames at LRW's 256x256 (resized to the detector's 240x320 on the host)
# and 32 seeded 112x112 crops for the landmark net (batch 1 each: its
# graph reshapes to (1, -1)); the card against the CPU, TF32 off. The
# convs sum in other orders on cuDNN than on the CPU (f32, a few 1e-7
# on the CPU between the port and JAX): RFB-320's scores and boxes within
# DETECT_TOL, the landmark net's 136 outputs (unit-square coordinates)
# within LANDMARK_TOL; ``FaceDetector`` the same None pattern and boxes
# and landmarks within 1 px (both truncate to integers)
PREP_FRAMES, PREP_SIZE, PREP_VIDEO_FRAMES, PREP_BATCH = 32, 256, 64, 32
DETECT_TOL, LANDMARK_TOL = 1e-4, 1e-4


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ar_decode_work(cfg, B: int, T: int, S: int, M: int, weight_bytes: int) -> tuple[float, float]:
    """(operations, bytes) of one AR decode: every input read once, every
    output written once."""
    F, H, L, NM = cfg.ffn_hidden_dim, cfg.ffn_hidden_dim // 2, cfg.content_latent_dim, cfg.n_mels
    mat = NM * H + H * H + 2 * F * F + F * H + 2 * F * L + 2 * (2 * F * 4 * F) + F * NM + 2 * F
    vec = 3 * H + 2 * H + 2 * F + H + L + 2 * 4 * F + NM + 1
    flops = M * B * (2 * mat + 2 * 2 * T * F + 2 * 2 * S * L)
    inputs = (mat * weight_bytes + vec * 4 + 2 * B * F * 4 + 2 * B * T * F * weight_bytes
              + 2 * B * S * L * weight_bytes + B * F * 4 + B * NM * 4 + M * F * 4 + 8)
    outputs = M * B * (NM + 1 + T) * 4
    return float(flops), float(inputs + outputs)


def bound_ms(flops: float, nbytes: float, dtype_name: str) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def first_crossing(fired):
    """(M, B) bool -> (B,) 1-based first step that fired, M where none did."""
    import torch

    first = torch.argmax(fired.to(torch.int32), dim=0) + 1
    return torch.where(fired.any(dim=0), first, torch.full_like(first, fired.shape[0]))


def lengths_check(ref_stops, got_stops, threshold: float) -> tuple[bool, int, int]:
    """Compare the first gate crossings of two stop-logit runs (M, B, 1).

    Where the reference's logit passes within the measured stop error of the
    threshold before it crosses, rounding decides the step (a near-tie).
    Any run whose logits lie within that error crosses first somewhere in
    [first step ref > thr - err, first step ref > thr + err]; lengths must
    lie in that window widened by one step, which is "equal within one
    step" for every row without a near-tie. Returns (ok, largest gap,
    rows with a near-tie)."""
    z = math.log(threshold / (1.0 - threshold))
    ref, got = ref_stops[..., 0], got_stops[..., 0]
    err = float((ref - got).abs().max())
    lo = first_crossing(ref > z - err)
    hi = first_crossing(ref > z + err)
    n_ref, n_got = first_crossing(ref > z), first_crossing(got > z)
    ok = bool(((n_got >= lo - 1) & (n_got <= hi + 1)).all())
    return ok, int((n_ref - n_got).abs().max()), int((lo != hi).sum())


def phase_build(card: str):
    from lip2speech_torch.kernels import build

    t0 = time.time()
    build.build("ar_decode.cu")
    print(f"build: ar_decode.cu in {time.time() - t0:.1f} s [{card}]")
    for line in build.build_logs.get("ar_decode.cu", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def make_encoder_inputs(cfg, B: int, T: int, gen, device):
    """Unit-norm video features and face embedding, as the encoders emit."""
    import torch

    feats = torch.randn(B, T, cfg.video_feature_dim, generator=gen)
    feats = feats / feats.norm(dim=-1, keepdim=True)
    face = torch.relu(torch.randn(B, cfg.face_embedding_dim, generator=gen))
    face = face / face.norm(dim=-1, keepdim=True)
    visual = torch.cat([feats, face[:, None].expand(-1, T, -1)], dim=-1)
    return visual.to(device), face.to(device)


def phase_kernel(cfg, card: str, dev, batches=KERNEL_BATCHES, reps: int = 5) -> dict:
    """The kernel against its plain version at each B; returns the results
    by (B, dtype name)."""
    import torch

    from lip2speech_torch.kernels import ar_decode as ar
    from lip2speech_torch.models.decoder import Decoder
    from lip2speech_torch.models.lip2speech import init_random_

    gen = torch.Generator().manual_seed(SEED)
    dec = init_random_(Decoder(cfg.model), gen).to(dev).eval()
    T = cfg.data.max_video_frames
    M = cfg.model.max_decoder_steps
    results = {}
    bad = []
    for B in batches:
        with torch.no_grad():
            visual, face = make_encoder_inputs(cfg.model, B, T, gen, dev)
            enc = dec.encode(visual, face, generator=torch.Generator(device=dev).manual_seed(SEED))
            p = dec.ar_params()
            bos = dec.BOS.reshape(1, -1).expand(B, -1)
            S = enc["content_key"].shape[1]
            for wd in (torch.float32, torch.bfloat16):
                name = str(wd).split(".")[-1]
                ref = ar.ar_decode_reference(cfg.model, p, enc, bos, M, wd)
                got = ar.ar_decode_cuda(cfg.model, p, enc, bos, M, wd)
                torch.cuda.synchronize()
                errs = [float((g - r).abs().max()) for g, r in zip(got, ref)]
                len_ok, len_gap, ties = lengths_check(ref[1], got[1], cfg.model.gate_threshold)
                ms = cuda_ms(lambda: ar.ar_decode_cuda(cfg.model, p, enc, bos, M, wd), reps=reps)
                plain = cuda_ms(lambda: ar.ar_decode_reference(cfg.model, p, enc, bos, M, wd), reps=1)
                flops, nbytes = ar_decode_work(cfg.model, B, T, S, M, 2 if wd == torch.bfloat16 else 4)
                bms, by = bound_ms(flops, nbytes, name)
                finite = all(bool(torch.isfinite(g).all()) for g in got)
                print(f"ar_decode B={B} {name}: max|err| mel {errs[0]:.3e} stop {errs[1]:.3e} "
                      f"attn {errs[2]:.3e} (tol {TOL[name]}), lengths gap {len_gap} "
                      f"({ties} near-tie rows); kernel {ms:.3f} ms, plain {plain:.3f} ms, "
                      f"bound {bms:.4f} ms ({by}) [{card}]")
                results[(B, name)] = dict(err=max(errs), ms=ms, plain_ms=plain, bound_ms=bms,
                                          bound_by=by)
                if B in TIMED_BATCHES and wd == torch.bfloat16:
                    print_stages(ar, cfg.model, p, enc, bos, M, wd, B, card)
                if not finite or not len_ok or any(e > t for e, t in zip(errs, TOL[name])):
                    bad.append(f"B={B} {name}: errs {errs} vs {TOL[name]}, lengths ok {len_ok}, "
                               f"finite {finite}")
    if bad:
        fail("kernel disagrees with its plain version: " + "; ".join(bad))
    return results


def print_stages(ar, cfg, p, enc, bos, M: int, wd, B: int, card: str):
    """Per-stage time of one launch (the kernel's stage timer), in us per step."""
    import torch

    names = ar.stage_names()
    ns = torch.zeros(len(names), dtype=torch.int64, device=enc["k"].device)
    ar.ar_decode_cuda(cfg, p, enc, bos, M, wd, stage_ns=ns)
    torch.cuda.synchronize()
    once = ("init", "last")  # slots that occur once a launch; the others once a step
    us = [v / 1e3 / (1 if n in once else M) for n, v in zip(names, ns.tolist())]
    parts = ", ".join(f"{n} {u:.2f}" for n, u in zip(names, us))
    per_step = sum(u for n, u in zip(names, us) if n not in once)
    print(f"ar_decode stages B={B} {str(wd).split('.')[-1]} (us per step; init and last in us): "
          f"{parts}; sum {per_step:.2f} us per step [{card}]")


def make_request(cfg, B: int, gen, device, dtype, frames: int | None = None):
    """Normalised mouth frames (B, T, 96, 96, 3) and face crops
    (B, 2, 160, 160, 3), drawn on ``device`` from ``gen``."""
    import torch

    from lip2speech_torch.ops import image

    d = cfg.data
    T = frames or d.max_video_frames
    mouth = torch.randint(0, 256, (B, T, *d.mouth_size, 3), generator=gen, device=device,
                          dtype=torch.uint8)
    faces = torch.randint(0, 256, (B, d.n_face_crops, *d.face_size, 3), generator=gen,
                          device=device, dtype=torch.uint8)
    return image.normalize_mouth(mouth).to(dtype), image.normalize_face(faces).to(dtype)


def serve(model, cfg, video, faces, gen, gumbel=None, theta=None, compute_dtype=None):
    """One batch through the inference path: model -> 80-frame mel prefix ->
    NNLS + Griffin-Lim -> waveform (as bench.py times the JAX package)."""
    from lip2speech_torch.ops.griffin_lim import mel_to_audio

    out = model(video, faces, gumbel=gumbel, generator=gen)
    mel = out["mel_postnet"].float()[..., :MEL_FRAMES]
    wav = mel_to_audio(mel, cfg.audio, n_iter=GL_ITERS, compute_dtype=compute_dtype,
                       generator=gen, theta=theta)
    return out, wav


def print_profile(fn, B: int, card: str, top: int = 8, ranges: str | None = None):
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's idle share of the call's wall time; with ``ranges``, also
    the host time of the profiler ranges whose names start with it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # a profiler range also shows on the device's timeline: keep kernels only
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not (ranges and e.key.startswith(ranges))]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profile B={B}: wall {wall_ms:.2f} ms (profiled), device busy {busy_ms:.2f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.3f} [{card}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3
        print(f"  {ms:9.3f} ms {ms / busy_ms:6.1%} x{e.count:<5d} {e.key[:90]}")
    if ranges:
        launches = sum(e.count for e in kernels)
        parts = ", ".join(f"{e.key} {e.cpu_time_total / 1e3:.2f} ms" for e in events
                          if e.key.startswith(ranges) and e.device_type == torch.autograd.DeviceType.CPU)
        print(f"  host time by range: {parts}; {launches} kernel launches")


def phase_pipeline(cfg, card: str, dev, timed_batches=TIMED_BATCHES, profile=False) -> int:
    """The port's inference path; returns the kernel launches of the B=4 run.
    With ``profile``, also prints where the device time of one batch goes."""
    import numpy as np
    import torch

    from lip2speech_torch.eval.long_video import synthesize_long_video
    from lip2speech_torch.kernels import ar_decode as ar
    from lip2speech_torch.models.lip2speech import Lip2Speech, init_random_

    bf16 = torch.bfloat16
    M = cfg.model.max_decoder_steps
    cpu_model = init_random_(Lip2Speech(cfg.model), torch.Generator().manual_seed(SEED))
    model = copy.deepcopy(cpu_model).to(dev, bf16)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # the main path: B=4 requests, counted
    video, faces = make_request(cfg, MAIN_B, gen, dev, bf16)
    ar.launches = 0
    out, wav = serve(model, cfg, video, faces, gen, compute_dtype=bf16)
    torch.cuda.synchronize(dev)
    launches = ar.launches
    lengths = out["lengths"]
    n_samples = (MEL_FRAMES - 1) * cfg.audio.hop_length
    print(f"pipeline B={MAIN_B}: wav {tuple(wav.shape)}, lengths {lengths.tolist()}, "
          f"ar_decode launches {launches}")
    if tuple(wav.shape) != (MAIN_B, n_samples) or not bool(torch.isfinite(wav).all()):
        fail(f"pipeline waveform {tuple(wav.shape)} is not a finite ({MAIN_B}, {n_samples})")
    if not bool(((lengths >= 1) & (lengths <= M)).all()):
        fail(f"lengths {lengths.tolist()} outside [1, {M}]")
    if launches < 1:
        fail("the pipeline did not launch the ar_decode kernel")

    # one f32 request on the GPU against the same request on the CPU
    host_gen = torch.Generator().manual_seed(SEED)
    gpu32 = copy.deepcopy(cpu_model).to(dev)
    v1, f1 = make_request(cfg, 1, host_gen, "cpu", torch.float32)
    S = max(1, cfg.data.max_video_frames // 7)
    u = torch.rand(S, cfg.model.content_vocab_size, generator=host_gen)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-30)))
    theta = (torch.rand(1, cfg.audio.n_freqs, MEL_FRAMES, generator=host_gen) * 2 - 1) * math.pi
    out_c, wav_c = serve(cpu_model, cfg, v1, f1, None, gumbel, theta)
    out_g, wav_g = serve(gpu32, cfg, v1.to(dev), f1.to(dev), None, gumbel.to(dev), theta.to(dev))
    mel_err = float((out_g["mel_postnet"].cpu() - out_c["mel_postnet"]).abs().max())
    wav_rel = float((wav_g.cpu() - wav_c).norm() / wav_c.norm())
    len_ok, len_gap, ties = lengths_check(out_c["gate"].transpose(0, 1).cpu(),
                                          out_g["gate"].transpose(0, 1).cpu(),
                                          cfg.model.gate_threshold)
    print(f"f32 request, GPU vs CPU: max|mel_postnet err| {mel_err:.3e} (tol {E2E_MEL_TOL}), "
          f"waveform rel. L2 err {wav_rel:.3e}, lengths {out_g['lengths'].tolist()} vs "
          f"{out_c['lengths'].tolist()} ({ties} near-tie rows)")
    if mel_err > E2E_MEL_TOL or not len_ok or not bool(torch.isfinite(wav_g).all()):
        fail(f"f32 GPU pipeline disagrees with the CPU: mel err {mel_err:.3e}, lengths ok {len_ok}")

    # batch latency (host clock around synchronised batches); the weights
    # were packed for the kernel by the main-path run and are not packed again
    packs = ar.packs
    for B in timed_batches:
        vb, fb = make_request(cfg, B, gen, dev, bf16)
        serve(model, cfg, vb, fb, gen, compute_dtype=bf16)
        torch.cuda.synchronize(dev)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            serve(model, cfg, vb, fb, gen, compute_dtype=bf16)
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        ms = float(np.median(times))
        print(f"pipeline B={B}: {ms:.2f} ms per batch (median of 3: {[round(t, 2) for t in times]}), "
              f"{B / ms * 1e3:.1f} clips/s [{card}]")
        if profile:
            print_profile(lambda: serve(model, cfg, vb, fb, gen, compute_dtype=bf16), B, card)

    if ar.packs != packs:
        fail(f"the AR weights were packed {ar.packs - packs} more times across unchanged batches")

    # one long video of about three chunks
    mouth, face = make_request(cfg, 1, gen, dev, torch.float32, frames=LONG_VIDEO_FRAMES)
    wav_l, mel_l = synthesize_long_video(model, mouth[0].cpu().numpy(), face[0].cpu().numpy(),
                                         cfg, dev, gen, n_gl_iters=GL_ITERS)
    print(f"long video: {LONG_VIDEO_FRAMES} frames -> mel {mel_l.shape}, wav {wav_l.shape}")
    if not np.isfinite(wav_l).all() or mel_l.shape[0] != cfg.audio.n_mels or wav_l.ndim != 1:
        fail("long-video synthesis gave a non-finite or misshapen result")
    return launches


def make_train_batch(cfg, B: int, seed: int, device):
    """A seeded batch as a data loader hands it over: uint8 mouth and face
    crops and audio clips of random lengths up to ``max_audio_samples``,
    through ``collate`` on the host and ``prepare_batch`` on ``device``."""
    import numpy as np

    from lip2speech_torch.data.collate import collate, prepare_batch, to_device

    d = cfg.data
    rng = np.random.RandomState(seed)
    samples = [{
        "mouth": rng.randint(0, 256, (d.max_video_frames, *d.mouth_size, 3), dtype=np.uint8),
        "faces": rng.randint(0, 256, (d.n_face_crops, *d.face_size, 3), dtype=np.uint8),
        "audio": (rng.randn(rng.randint(d.max_audio_samples // 2, d.max_audio_samples + 1))
                  * 0.1).astype(np.float32),
    } for _ in range(B)]
    return prepare_batch(to_device(collate(samples, d), device), cfg.audio, d)


def make_draws(mcfg, B: int, T: int, M: int, video_dim: int, gen) -> dict:
    """Every random draw of a teacher-forced train-mode forward, on the CPU
    from ``gen``, so two devices can be handed the same draws."""
    import torch

    from lip2speech_torch.models.layers import keep_mask

    S = min(T // k if T >= k else 1 for k in (1, 3, 5, 7))  # content codebook slots
    Fh = mcfg.ffn_hidden_dim
    u = torch.rand(B * S, mcfg.content_vocab_size, generator=gen).clamp(min=1e-30)
    chans = [mcfg.postnet_embedding_dim] * (mcfg.postnet_n_convolutions - 1) + [mcfg.n_mels]
    return {
        "gumbel": -torch.log(-torch.log(u)),
        "teacher": torch.rand(M, generator=gen),
        "prenet": keep_mask((M, B, Fh // 2), mcfg.prenet_dropout, gen, "cpu"),
        "attention": keep_mask((M, B, T), mcfg.attention_dropout, gen, "cpu"),
        "rnn": keep_mask((M, B, Fh), mcfg.decoder_rnn_dropout, gen, "cpu"),
        "postnet": [keep_mask((B, c, M), mcfg.postnet_dropout, gen, "cpu") for c in chans],
        "encoder": keep_mask((B, T, video_dim), mcfg.encoder_feature_dropout, gen, "cpu"),
    }


def train_gpu_vs_cpu(cfg, cpu_model, dev):
    """One f32 train step on the GPU and the same step on the CPU (B=2, full
    width, same weights, batch and draws), each held against an f64 step on
    the CPU that takes the f32 step's side at every ReLU/PReLU kink of the
    video encoder; and the same step in f64 on the GPU against the CPU's.
    Fails beyond the tolerances stated at the top. Each comparison prints
    its worst tensor of each kind, the error of the encoder's output and of
    the cotangent reaching it, and how many kinks the f32 step took on the
    other side from the free f64 step. For the record of where the f32
    error comes from, it also prints the f32 steps against the free f64
    step, the GPU's with cuDNN limited to deterministic algorithms and with
    cuDNN off too."""

    import torch

    from lip2speech_torch.train.train_step import create_train_state, loss_and_grad

    cfg32 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, bf16=False))
    B, T = 2, cfg.data.max_video_frames
    batch = make_train_batch(cfg, B, SEED + 1, "cpu")
    draws = make_draws(cfg.model, B, T, batch["mel"].shape[-1], cpu_model.encoder.output_dim,
                       torch.Generator().manual_seed(SEED + 2))

    def run(device, dtype, signs=None):
        """(losses, new statistics, gradients, probe) of one step; with
        ``signs`` (a run's ``probe["signs"]``), each encoder ReLU/PReLU
        takes the given side of its kink."""
        model = copy.deepcopy(cpu_model).to(device, dtype)
        state = create_train_state(cfg32, model)
        probe = {"signs": []}
        given = None if signs is None else iter([s.to(device) for s in signs])

        def kink(m, args, out):
            x = args[0]  # for an in-place ReLU, relu(x): positive where x is
            if given is None:
                probe["signs"].append((x > 0).cpu())
                return None
            side = next(given)
            if isinstance(m, torch.nn.ReLU):
                return x * side
            return torch.where(side, x, m.weight.view(1, -1, *[1] * (x.ndim - 2)) * x)

        def probe_at(name):  # a module's output and the cotangent reaching it
            def hook(m, args, out):
                probe[name] = out.detach().double().cpu()
                out.register_hook(lambda g: probe.__setitem__(name + " cotangent", g.double().cpu()))
            return hook

        for m in model.encoder.modules():
            if isinstance(m, (torch.nn.ReLU, torch.nn.PReLU)):
                if signs is not None and isinstance(m, torch.nn.ReLU):
                    m.inplace = False
                m.register_forward_hook(kink)
        model.encoder.register_forward_hook(probe_at("features"))
        model.encoder.trunk.register_forward_hook(probe_at("trunk"))

        def put(x):
            x = x.to(device)
            return x.to(dtype) if x.is_floating_point() else x

        b = {k: put(v) for k, v in batch.items()}
        d = {k: [put(m) for m in v] if isinstance(v, list) else put(v) for k, v in draws.items()}
        losses, stats, grads = loss_and_grad(state, b, TRAIN_TF, cfg32, d)
        grads = dict(zip(state.opt.names, grads))
        return [{k: v.detach().double().cpu() for k, v in part.items()}
                for part in (losses, stats, grads)] + [probe]

    def tops(want):  # the largest value of each kind, for the floor of a near-zero tensor
        return [max(float(v.abs().max()) for v in part.values()) for part in want[:3]]

    def rel(got, want, top=0.0):
        """max |got - want| over the tensor's max plus 1% of its kind's."""
        return float((got - want).abs().max()) / (float(want.abs().max()) + 0.01 * top or 1.0)

    def report(label, got, want):
        """Prints the run's error against ``want`` (``rel``); returns the worst."""
        p, top = got[3], tops(want)
        worst = {}
        for part, kind in ((0, "losses"), (1, "BN statistics"), (2, "decoder gradients"),
                           (2, "encoder gradients")):
            keys = [k for k in want[part] if part < 2 or k.startswith("encoder.") == (kind[0] == "e")]
            worst[kind] = max((rel(got[part][k], want[part][k], top[part]), k) for k in keys)
        flips = sum(int((a != b).sum()) for a, b in zip(p["signs"], free[3]["signs"]))
        print(f"train step B={B}, {label}: " + ", ".join(
            f"{kind} {e:.3e} ({k})" for kind, (e, k) in worst.items())
            + "; " + ", ".join(f"{k} {rel(p[k], want[3][k]):.3e}" for k in (
                "trunk", "features", "features cotangent", "trunk cotangent"))
            + f"; kinks on the other side from the free f64 step: {flips} of "
            f"{sum(s.numel() for s in p['signs'])}")
        return max(e for e, _ in worst.values())

    free, cpu, gpu = run("cpu", torch.float64), run("cpu", torch.float32), run(dev, torch.float32)
    ref_cpu, ref_gpu = run("cpu", torch.float64, cpu[3]["signs"]), run("cpu", torch.float64, gpu[3]["signs"])
    report("CPU f32 against CPU f64 on its kink sides", cpu, ref_cpu)
    report("GPU f32 against CPU f64 on its kink sides", gpu, ref_gpu)
    report("CPU f32 against the free CPU f64", cpu, free)
    report("GPU f32 against the free CPU f64", gpu, free)
    for label, flags in (("cuDNN deterministic", dict(deterministic=True)),
                         ("cuDNN off", dict(enabled=False))):
        with torch.backends.cudnn.flags(**{"enabled": True, "benchmark": False,
                                           "deterministic": False, "allow_tf32": False, **flags}):
            report(f"GPU f32 with {label} against the free CPU f64", run(dev, torch.float32), free)
    worst64 = report("GPU f64 against CPU f64", run(dev, torch.float64), free)
    if worst64 > TRAIN_F64_REL:
        fail(f"the f64 train step on the GPU is {worst64:.3e} off the CPU's (tol {TRAIN_F64_REL})")
    worst = []
    for part, kind in enumerate(("losses", "BN statistics", "gradients")):
        top = max(float(v.abs().max()) for v in ref_gpu[part].values())
        ratio, name = max(
            (float((gpu[part][k] - r).abs().max())
             / (TRAIN_F32_FACTOR * float((cpu[part][k] - ref_cpu[part][k]).abs().max())
                + TRAIN_REL * float(r.abs().max()) + TRAIN_FLOOR * top), k)
            for k, r in ref_gpu[part].items())
        worst.append(ratio)
        print(f"train f32 step B={B}, against f64 on its kink sides: {kind} ({len(ref_gpu[part])}): "
              f"the GPU's error is at most {ratio:.3f} of its tolerance ({name}: GPU "
              f"{float((gpu[part][name] - ref_gpu[part][name]).abs().max()):.3e}, CPU f32 "
              f"{float((cpu[part][name] - ref_cpu[part][name]).abs().max()):.3e}, max "
              f"{float(ref_gpu[part][name].abs().max()):.3e})")
    if max(worst) > 1.0:
        fail("the f32 train step on the GPU disagrees with the CPU")


def phase_train(cfg, card: str, dev, batch_size: int = TRAIN_B, timed: int = TRAIN_TIMED,
                profile: bool = False):
    """The port's training step at full width (see the module docstring)."""
    import numpy as np
    import torch

    from lip2speech_torch.kernels import ar_decode as ar
    from lip2speech_torch.models.lip2speech import Lip2Speech, init_random_
    from lip2speech_torch.train.train_step import create_train_state, train_step

    cuda = torch.device(dev).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    cpu_model = init_random_(Lip2Speech(cfg.model), torch.Generator().manual_seed(SEED))
    model = copy.deepcopy(cpu_model).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # one inference on the untrained weights packs them for the AR kernel
    video4, faces4 = make_request(cfg, MAIN_B, gen, dev, torch.float32)
    model(video4, faces4, generator=gen)

    state = create_train_state(cfg, model)
    batch = make_train_batch(cfg, batch_size, SEED, dev)
    face_before = {k: v.clone() for k, v in model.state_dict().items() if k.startswith("vgg_face.")}
    # matrices and kernels: every one has a gradient at these shapes
    trained_before = {n: p.detach().clone() for n, p in zip(state.opt.names, state.opt.params)
                      if p.ndim >= 2}
    history = [train_step(state, batch, TRAIN_TF, cfg) for _ in range(TRAIN_STEPS)]
    sync()
    for i, m in enumerate(history):
        print(f"train step {i}: " + ", ".join(f"{k} {float(v):.4f}" for k, v in m.items()))
        if not all(bool(torch.isfinite(v).all()) for v in m.values()) or int(m["notfinite_count"]):
            fail(f"train step {i} gave a non-finite loss or skipped its update")
    params = dict(model.named_parameters())
    moved = sum(not torch.equal(v, params[k].detach()) for k, v in trained_before.items())
    face_same = all(torch.equal(v, model.state_dict()[k]) for k, v in face_before.items())
    print(f"train: {moved} of {len(trained_before)} trainable matrices moved, face net "
          f"{'bit-identical' if face_same else 'CHANGED'} ({len(face_before)} tensors), "
          f"step {state.step}")
    if moved < len(trained_before) or not face_same or state.step != TRAIN_STEPS:
        fail("the train steps did not move the model as they should")
    del trained_before, face_before

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        m = train_step(state, batch, TRAIN_TF, cfg)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.median(times))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else float("nan")
    print(f"train B={batch_size} bf16: {ms:.2f} ms per step (median of {timed}: "
          f"{[round(t, 2) for t in times]}), {batch_size / ms * 1e3:.1f} clips/s, "
          f"peak memory {peak:.2f} GiB [{card}]")
    if not bool(torch.isfinite(m["total"])):
        fail("a timed train step gave a non-finite loss")
    if profile and cuda:
        print_profile(lambda: train_step(state, batch, TRAIN_TF, cfg), batch_size, card, top=12,
                      ranges="train.")

    # inference on the trained weights: the AR kernel must see them
    model.eval()
    packs = ar.packs
    with torch.no_grad():
        out = model(video4, faces4, generator=gen)
        sync()
        repacked = ar.packs - packs
        dec = model.decoder
        feats = model.encoder(video4)
        emb = model.vgg_face.inference(faces4[:, 0].permute(0, 3, 1, 2))
        visual = torch.cat([feats, emb[:, None].expand(-1, feats.shape[1], -1)], -1)
        enc = dec.encode(visual, emb, generator=gen)
        p, bos = dec.ar_params(), dec.BOS.reshape(1, -1).expand(MAIN_B, -1)
        M = cfg.model.max_decoder_steps
        ref = ar.ar_decode_reference(cfg.model, p, enc, bos, M, torch.float32)
        got = ar.ar_decode(cfg.model, p, enc, bos, M, torch.float32)
        sync()
    errs = [float((g - r).abs().max()) for g, r in zip(got, ref)]
    len_ok, _, _ = lengths_check(ref[1], got[1], cfg.model.gate_threshold)
    print(f"inference on the trained weights (B={MAIN_B}, f32): AR weights packed {repacked} "
          f"time(s); kernel vs plain max|err| mel {errs[0]:.3e} stop {errs[1]:.3e} "
          f"attn {errs[2]:.3e} (tol {TOL['float32']}), lengths {out['lengths'].tolist()}")
    if repacked != 1 or not len_ok or any(e > t for e, t in zip(errs, TOL["float32"])):
        fail("inference after training did not decode with the trained weights")

    train_gpu_vs_cpu(cfg, cpu_model, dev)


def _cli_args(root: str, tmp: str, name: str, dev, *extra: str):
    from lip2speech_torch.cli import train as train_cli

    return train_cli.parse_args([
        "--root", root, "--device", str(dev), "--batch_size", str(TRAIN_B), "--log_interval", "1",
        "--eval_batches", str(CLI_EVAL_BATCHES), "--run_dir", os.path.join(tmp, f"run_{name}"),
        "--ckpt_dir", os.path.join(tmp, f"ckpt_{name}"), *extra])


def write_fixture(root: str):
    """The synthetic LRW fixture: CLI_TRAIN_CLIPS train and CLI_TEST_CLIPS
    test clips over CLI_WORDS words, the words written in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    from lip2speech_torch.data import make_sample_lrw

    jobs = [(f"WORD{w}", split, n // CLI_WORDS, 1000 * (split == "test") + w)
            for split, n in (("train", CLI_TRAIN_CLIPS), ("test", CLI_TEST_CLIPS))
            for w in range(CLI_WORDS)]
    with ThreadPoolExecutor(min(len(jobs), os.cpu_count() or 8)) as pool:
        list(pool.map(lambda j: make_sample_lrw(root, word=j[0], split=j[1], n_clips=j[2],
                                                n_samples=CLI_SAMPLES, seed=j[3]), jobs))


def _overrides(cfg) -> list[str]:
    """``--override`` arguments that turn the default Config into ``cfg``."""
    from lip2speech_torch.config import Config

    out = []
    for section in dataclasses.fields(cfg):
        ours, default = getattr(cfg, section.name), getattr(Config(), section.name)
        for f in dataclasses.fields(ours):
            if getattr(ours, f.name) != getattr(default, f.name):
                out += ["--override", f"{section.name}.{f.name}={getattr(ours, f.name)!r}"]
    return out


def _step_rows(run_dir: str) -> tuple[list[dict], list[dict]]:
    """(train records, eval records) of a run's metrics.jsonl."""
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if "total" in r], [r for r in rows if "eval/estoi" in r]


def eval_batch_checks(cfg, model, ds, dev, card: str) -> dict:
    """On the first eval batch (32 test clips, f32 weights): the AR kernel
    against its plain version at the eval tick's shape (M=80), with their
    times and the bound; and the device ESTOI against the host's on the
    waveforms of that batch."""
    import numpy as np
    import torch

    from lip2speech_torch.data.collate import collate, prepare_batch, to_device
    from lip2speech_torch.eval import evaluate
    from lip2speech_torch.kernels import ar_decode as ar
    from lip2speech_torch.ops import estoi as estoi_ops

    B = min(32, len(ds))
    raw = collate([ds[i] for i in range(B)], cfg.data)
    batch = prepare_batch(to_device(raw, dev), cfg.audio, cfg.data)
    M = batch["mel"].shape[-1]
    model.eval()
    with torch.no_grad():
        feats = model.encoder(batch["video"])
        emb = model.vgg_face.inference(batch["faces"][:, 0].permute(0, 3, 1, 2))
        visual = torch.cat([feats, emb[:, None].expand(-1, feats.shape[1], -1)], -1)
        dec = model.decoder
        enc = dec.encode(visual, emb, generator=torch.Generator(device=dev).manual_seed(SEED))
        p, bos = dec.ar_params(), dec.BOS.reshape(1, -1).expand(B, -1)
        f32 = torch.float32
        ref = ar.ar_decode_reference(cfg.model, p, enc, bos, M, f32)
        got = ar.ar_decode_cuda(cfg.model, p, enc, bos, M, f32)
        torch.cuda.synchronize(dev)
        errs = [float((g - r).abs().max()) for g, r in zip(got, ref)]
        ms = cuda_ms(lambda: ar.ar_decode_cuda(cfg.model, p, enc, bos, M, f32), reps=5)
        plain = cuda_ms(lambda: ar.ar_decode_reference(cfg.model, p, enc, bos, M, f32), reps=1)
    flops, nbytes = ar_decode_work(cfg.model, B, enc["k"].shape[1], enc["content_key"].shape[1],
                                   M, 4)
    bms, by = bound_ms(flops, nbytes, "float32")
    print(f"ar_decode on an eval batch (B={B}, T={enc['k'].shape[1]}, M={M}, f32): max|err| mel "
          f"{errs[0]:.3e} stop "
          f"{errs[1]:.3e} attn {errs[2]:.3e} (tol {TOL['float32']}); kernel {ms:.3f} ms, plain "
          f"{plain:.3f} ms, bound {bms:.4f} ms ({by}) [{card}]")
    if any(e > t for e, t in zip(errs, TOL["float32"])) or not all(
            bool(torch.isfinite(g).all()) for g in got):
        fail("the AR kernel disagrees with its plain version on an eval batch")

    program = evaluate.eval_program(model, cfg, GL_ITERS, "estoi")
    with torch.no_grad():
        weights = program.weights()
        mel = program.forward(batch, weights, SEED)["mel_postnet"]
        torch.cuda.synchronize(dev)
        fwd_ms = []
        for _ in range(3):  # with no loader running
            t0 = time.perf_counter()
            program.forward(batch, weights, SEED)
            torch.cuda.synchronize(dev)
            fwd_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        wav = program.invert(mel, None, torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize(dev)
        gl_ms = (time.perf_counter() - t0) * 1e3
    print(f"eval forward of a batch of {B}, no loader running: {[round(t, 2) for t in fwd_ms]} ms; "
          f"NNLS + {GL_ITERS} Griffin-Lim iterations {gl_ms:.2f} ms [{card}]")
    with torch.no_grad():
        t0 = time.perf_counter()
        dev_scores = program.score(batch["audio"], wav, batch["audio_lengths"]).cpu().numpy()
        dev_ms = (time.perf_counter() - t0) * 1e3
    wav_np, gt = wav.cpu().numpy(), raw["audio"]
    t0 = time.perf_counter()
    host = np.array([estoi_ops.estoi(gt[i, :n], wav_np[i, :n], cfg.audio.sample_rate)
                     for i, n in enumerate(raw["audio_lengths"])])
    host_ms = (time.perf_counter() - t0) * 1e3
    gap = float(np.abs(dev_scores - host).max())
    print(f"ESTOI of an eval batch (B={B}): device (float64) {dev_ms:.2f} ms, host {host_ms:.2f} ms; "
          f"max |device - host| {gap:.3e} (tol {ESTOI_TOL}), mean {host.mean():.4f} [{card}]")
    if not np.isfinite(dev_scores).all() or gap > ESTOI_TOL:
        fail("the device ESTOI disagrees with the host's")
    return {"err": max(errs), "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by}


def phase_cli(cfg, card: str, dev) -> dict:
    """The training entry point at full width (see the module docstring);
    returns the AR kernel's eval-path numbers for the kernels line."""
    import contextlib
    import io

    import numpy as np
    import torch

    from lip2speech_torch.cli import evaluate as eval_cli
    from lip2speech_torch.cli import train as train_cli
    from lip2speech_torch.cli.common import load_model
    from lip2speech_torch.data import Loader, get_dataset
    from lip2speech_torch.eval.evaluate import evaluate_net
    from lip2speech_torch.kernels import ar_decode as ar

    print(f"cli: os.cpu_count() {os.cpu_count()}, loader threads {min(TRAIN_B, os.cpu_count() or 8)}")
    with tempfile.TemporaryDirectory(prefix="lip2speech_cli_") as tmp:
        root = os.path.join(tmp, "lrw")
        t0 = time.time()
        write_fixture(root)
        print(f"cli: fixture of {CLI_TRAIN_CLIPS} + {CLI_TEST_CLIPS} clips in {time.time() - t0:.1f} s")

        # the loader alone, on an idle host
        loader = Loader(get_dataset("LRW", root, mode="train", cfg=cfg.data), TRAIN_B, cfg.data,
                        num_workers=min(TRAIN_B, os.cpu_count() or 8), pin_memory=dev.type == "cuda")
        for _ in loader:
            pass
        st = loader.stats
        print(f"cli loader alone: {st['batches']} batches, "
              f"{st['host_s'] / st['batches'] * 1e3:.2f} ms of host time each [{card}]")

        # the main path: train with the loader, one eval tick, a checkpoint
        ar.launches = 0
        t0 = time.time()
        first = train_cli.train(_cli_args(root, tmp, "main", dev, "--max_iters", str(CLI_STEPS),
                                          "--eval_interval", str(CLI_STEPS),
                                          "--profile_step", str(CLI_STEPS)), cfg)
        torch.cuda.synchronize(dev)
        eval_launches = ar.launches
        wall = time.time() - t0
        rows, evals = _step_rows(os.path.join(tmp, "run_main"))
        ms = [r["step_time"] * 1e3 for r in rows[1:-1]]  # not the warm-up, not the profiled step
        loader = first["loader"]
        prof = first["profile"]
        print(f"cli train B={TRAIN_B}: {len(rows)} steps and an eval tick in {wall:.1f} s; "
              f"{float(np.median(ms)):.2f} ms per step with the loader (median of steps 2-"
              f"{CLI_STEPS - 1}: {[round(t, 2) for t in ms]}), losses "
              f"{[round(r['total'], 3) for r in rows]}, eval ESTOI {first['best_score']:.4f}, "
              f"ar_decode launches {eval_launches} [{card}]")
        print(f"cli loader: {loader['batches']} batches, {loader['host_s'] / loader['batches'] * 1e3:.2f} "
              f"ms of host time each (decode + collate + pin), {loader['stalls']} stalls, "
              f"{loader['wait_s']:.2f} s waited in all [{card}]")
        print(f"cli profiled step {CLI_STEPS}: wall {prof['wall_ms']:.2f} ms, device busy "
              f"{prof['device_ms']:.2f} ms, idle share {prof['idle_share']:.3f}, "
              f"{prof['launches']:.0f} kernel launches [{card}]")
        want = {"mel_loss", "postnet_mel_loss", "gate_loss", "KLD", "total", "grad_norm",
                "tf_ratio", "epoch", "step_time"}
        if len(rows) != CLI_STEPS or not all(want <= set(r) for r in rows) or len(evals) != 1:
            fail(f"metrics.jsonl lacks the train scalars or eval/estoi: {len(rows)} steps, "
                 f"{len(evals)} eval records")
        if not all(math.isfinite(r[k]) for r in rows for k in want):
            fail("the CLI's training gave a non-finite loss")
        eval_batches = min(CLI_EVAL_BATCHES, -(-CLI_TEST_CLIPS // min(32, TRAIN_B)))
        if eval_launches != eval_batches:
            fail(f"the eval tick launched the AR kernel {eval_launches} times for "
                 f"{eval_batches} batches")

        # the same run with fewer loader threads
        for threads in CLI_THREAD_SWEEP:
            name = f"threads{threads}"
            res = train_cli.train(_cli_args(root, tmp, name, dev, "--max_iters",
                                            str(CLI_SWEEP_STEPS), "--eval_interval", "1000",
                                            "--num_workers", str(threads)), cfg)
            sweep, _ = _step_rows(os.path.join(tmp, f"run_{name}"))
            ms_t = [r["step_time"] * 1e3 for r in sweep[1:]]
            st = res["loader"]
            print(f"cli train B={TRAIN_B}, {threads} loader threads: "
                  f"{float(np.median(ms_t)):.2f} ms per step (steps 2-{CLI_SWEEP_STEPS}: "
                  f"{[round(t, 2) for t in ms_t]}); loader {st['host_s'] / st['batches'] * 1e3:.2f} "
                  f"ms of host time a batch, {st['stalls']} stalls, {st['wait_s']:.2f} s waited "
                  f"[{card}]")

        # resume from the checkpoint
        second = train_cli.train(_cli_args(root, tmp, "main", dev, "--max_iters",
                                           str(CLI_STEPS + CLI_RESUMED_STEPS),
                                           "--eval_interval", "1000"), cfg)
        rows2, _ = _step_rows(os.path.join(tmp, "run_main"))
        print(f"cli resume: started at step {second['start_step']} with best score "
              f"{second['start_best_score']:.4f}, ended at {second['final_step']}; losses "
              f"{[round(r['total'], 3) for r in rows2[len(rows):]]}")
        if (second["start_step"] != CLI_STEPS or second["start_best_score"] != first["best_score"]
                or second["final_step"] != CLI_STEPS + CLI_RESUMED_STEPS
                or not all(math.isfinite(r["total"]) for r in rows2)):
            fail("the resumed run did not start where the first one saved")

        # the same step on a staged batch
        train_cli.train(_cli_args(root, tmp, "staged", dev, "--max_iters", str(CLI_STEPS),
                                  "--eval_interval", "1000", "--train_split", "test",
                                  "--reuse_first_batch"), cfg)
        staged, _ = _step_rows(os.path.join(tmp, "run_staged"))
        ms_staged = [r["step_time"] * 1e3 for r in staged[1:]]
        print(f"cli train B={TRAIN_B} on a staged batch: {float(np.median(ms_staged)):.2f} ms per "
              f"step (median of steps 2-{CLI_STEPS}: {[round(t, 2) for t in ms_staged]}); with the "
              f"loader {float(np.median(ms)):.2f} ms [{card}]")

        # cli/evaluate on the checkpoint
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            t0 = time.time()
            eval_cli.main(["--root", root, "--model_path", os.path.join(tmp, "ckpt_main"),
                           "--device", str(dev), *_overrides(cfg)])
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        print(f"cli evaluate: {json.dumps(line)} in {time.time() - t0:.1f} s")
        if line.get("n_clips") != CLI_TEST_CLIPS or not math.isfinite(line.get("estoi", math.nan)):
            fail(f"cli.evaluate printed {line}")

        # the eval tick's split, the kernel and the metrics on one eval batch
        model, _ = load_model(cfg, os.path.join(tmp, "ckpt_main"), dev)
        ds = get_dataset("LRW", root, mode="test", cfg=cfg.data)
        for device_estoi in (False, True):
            stats = {}
            t0 = time.perf_counter()
            evaluate_net(model, ds, cfg, batch_size=32, max_batches=CLI_EVAL_BATCHES,
                         device_estoi=device_estoi, stats=stats)
            wall = time.perf_counter() - t0
            print(f"cli eval tick ({'device' if device_estoi else 'host'} metric), "
                  f"{stats['batches']} batches of 32 in {wall * 1e3:.2f} ms; ms for each batch: "
                  + ", ".join(f"{k[:-2]} {[round(x * 1e3, 2) for x in v]}" for k, v in stats.items()
                              if k.endswith("_s")) + f" [{card}]")
        return {"launches": eval_launches, **eval_batch_checks(cfg, model, ds, dev, card)}


def adversarial_gpu_vs_cpu(cfg, dev, card: str) -> float:
    """One f32 critic step and the generator terms (with their gradient to
    the fake mel) on the GPU against the same on the CPU; fails beyond the
    ``ADV_*`` bounds. Returns the critic step's ms alone on the card at the
    training shape (B=64, 80 frames; CUDA events, mean of ``ADV_TIMED``
    steps after one warm-up)."""
    import torch

    from lip2speech_torch.train.adversarial import (CriticState, RMSprop, critic_step,
                                                    generator_terms, init_critic)

    gen = torch.Generator().manual_seed(SEED + 3)
    T = MEL_FRAMES
    real = torch.randn(ADV_B, cfg.model.n_mels, T, generator=gen) - 5.0
    fake = real + torch.randn(ADV_B, cfg.model.n_mels, T, generator=gen)
    spk = torch.relu(torch.randn(ADV_B, cfg.model.face_embedding_dim, generator=gen))
    spk = spk / spk.norm(dim=-1, keepdim=True)
    patch = (torch.tensor(51), torch.tensor(25))  # start > T - P: the rolled slice
    cpu = init_critic(cfg, torch.Generator().manual_seed(SEED))
    start = {k: v.clone() for k, v in cpu.disc.state_dict().items()}

    def run(critic, device):
        x = [v.to(device) for v in (real, fake, spk)]
        p = tuple(v.to(device) for v in patch)
        f = x[1].clone().requires_grad_(True)
        terms = generator_terms(critic, x[0], f, x[2], p)
        (grad,) = torch.autograd.grad(terms["g_loss"] + terms["g_d_fm_loss"], f)
        d = critic_step(critic, x[0], x[1], x[2], p)
        return ({k: float(v) for k, v in terms.items()} | {"d_loss": float(d)}, grad.cpu(),
                {k: v.cpu() for k, v in critic.disc.state_dict().items()})

    disc = copy.deepcopy(cpu.disc).to(dev)
    gpu = CriticState(disc, RMSprop(cfg.train.adversarial_critic_lr, disc.parameters()))
    want, gwant, swant = run(cpu, "cpu")
    got, ggot, sgot = run(gpu, dev)
    worst = {}
    for k, w in want.items():
        worst[k] = abs(got[k] - w) / (ADV_RTOL * abs(w) + 1e-6)
    scale = float(gwant.abs().max()) or 1.0
    worst["grad"] = float((ggot - gwant).abs().max()) / scale / ADV_RTOL
    sign, delta = 1.0, 0.0
    for k, w in swant.items():
        if "running_" in k:
            worst[k] = float((sgot[k] - w).abs().max()) / (float(w.abs().max()) or 1.0) / ADV_RTOL
            continue
        if float(sgot[k].abs().max()) > 0.01:
            fail(f"the GPU critic's {k} is not clamped to 0.01")
        dc, dg = (w - start[k]).double(), (sgot[k] - start[k]).double()
        moved = dc.abs() > cfg.train.adversarial_critic_lr / 2
        if moved.any():
            sign = min(sign, float((torch.sign(dg[moved]) == torch.sign(dc[moved])).double().mean()))
            delta = max(delta, float((dg - dc).norm() / dc.norm()))
    name = max(worst, key=worst.get)
    print(f"adversarial f32, GPU vs CPU (B={ADV_B}, {T} frames): d_loss {got['d_loss']:.6e} vs "
          f"{want['d_loss']:.6e}, g_loss {got['g_loss']:.6e} vs {want['g_loss']:.6e}, g_d_fm_loss "
          f"{got['g_d_fm_loss']:.6e} vs {want['g_d_fm_loss']:.6e}; worst {name} at "
          f"{worst[name]:.3f} of its tolerance (rtol {ADV_RTOL}); critic change: same sign on "
          f"{sign:.5f} of moved entries (tol {ADV_SIGN}), L2 {delta:.3e} (tol {ADV_DELTA})")
    if worst[name] > 1.0 or sign < ADV_SIGN or delta > ADV_DELTA:
        fail("the adversarial step on the GPU disagrees with the CPU")

    # the critic step alone at the training shape: B=64, 80 frames, on the card
    g = torch.Generator(device=dev).manual_seed(SEED)
    shape = (TRAIN_B, cfg.model.n_mels, T)
    x = (torch.randn(shape, generator=g, device=dev) - 5.0,
         torch.randn(shape, generator=g, device=dev) - 4.0,
         torch.rand(TRAIN_B, cfg.model.face_embedding_dim, generator=g, device=dev))
    p = tuple(v.to(dev) for v in patch)
    return cuda_ms(lambda: critic_step(gpu, *x, p), reps=ADV_TIMED)


def phase_adversarial(cfg, card: str, dev) -> dict:
    """Adversarial training through the CLI at full width (see the module
    docstring); returns the AR kernel's launches in its eval tick."""
    import numpy as np
    import torch

    from lip2speech_torch.cli import train as train_cli
    from lip2speech_torch.kernels import ar_decode as ar

    adv_cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, adversarial=True))
    with tempfile.TemporaryDirectory(prefix="lip2speech_adv_") as tmp:
        root = os.path.join(tmp, "lrw")
        t0 = time.time()
        write_fixture(root)
        print(f"adversarial: fixture of {CLI_TRAIN_CLIPS} + {CLI_TEST_CLIPS} clips in "
              f"{time.time() - t0:.1f} s")

        # the main path: adversarial steps with the loader, one eval tick
        torch.cuda.reset_peak_memory_stats(dev)
        ar.launches = 0
        t0 = time.time()
        res = train_cli.train(_cli_args(root, tmp, "adv", dev, "--max_iters", str(CLI_STEPS),
                                        "--eval_interval", str(CLI_STEPS)), adv_cfg)
        torch.cuda.synchronize(dev)
        eval_launches = ar.launches
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        rows, evals = _step_rows(os.path.join(tmp, "run_adv"))
        ms = [r["step_time"] * 1e3 for r in rows[1:-1]]
        print(f"adversarial cli B={TRAIN_B}: {len(rows)} steps and an eval tick in {wall:.1f} s; "
              f"{float(np.median(ms)):.2f} ms per step with the loader (steps 2-{CLI_STEPS - 1}: "
              f"{[round(t, 2) for t in ms]}); d_loss {[round(r['d_loss'], 6) for r in rows]}, "
              f"g_loss {[round(r['g_loss'], 6) for r in rows]}, g_d_fm_loss "
              f"{[round(r['g_d_fm_loss'], 4) for r in rows]}, eval ESTOI {res['best_score']:.4f}, "
              f"ar_decode launches {eval_launches}, peak memory {peak:.2f} GiB [{card}]")
        want = {"g_loss", "g_d_fm_loss", "d_loss", "total", "grad_norm", "notfinite_count"}
        if len(rows) != CLI_STEPS or not all(want <= set(r) for r in rows) or len(evals) != 1:
            fail(f"metrics.jsonl lacks the adversarial scalars or eval/estoi: {len(rows)} steps, "
                 f"{len(evals)} eval records")
        if not all(math.isfinite(v) for r in rows + evals for v in r.values()):
            fail("the adversarial run logged a non-finite value")
        if len({r["d_loss"] for r in rows}) < 2:
            fail("the critic's loss did not move")
        critic = res["critic"].disc
        peak_w = max(float(p.abs().max()) for p in critic.parameters())
        n_params = sum(p.numel() for p in critic.parameters())
        print(f"adversarial critic: {n_params} parameters, max |w| {peak_w:.6f} (clamp 0.01)")
        if peak_w > 0.01:
            fail(f"a critic parameter left the 0.01 clamp: {peak_w}")
        eval_batches = min(CLI_EVAL_BATCHES, -(-CLI_TEST_CLIPS // min(32, TRAIN_B)))
        if eval_launches != eval_batches:
            fail(f"the adversarial eval tick launched the AR kernel {eval_launches} times for "
                 f"{eval_batches} batches")

        # the adversarial and the plain step on a staged batch, in this process
        staged = {}
        for name, run_cfg in (("adv_staged", adv_cfg), ("plain_staged", cfg)):
            torch.cuda.reset_peak_memory_stats(dev)
            train_cli.train(_cli_args(root, tmp, name, dev, "--max_iters", str(CLI_STEPS),
                                      "--eval_interval", "1000", "--train_split", "test",
                                      "--reuse_first_batch"), run_cfg)
            steps, _ = _step_rows(os.path.join(tmp, f"run_{name}"))
            staged[name] = ([r["step_time"] * 1e3 for r in steps[1:]],
                            torch.cuda.max_memory_allocated(dev) / 2**30)
        (adv_ms, adv_peak), (plain_ms, plain_peak) = staged["adv_staged"], staged["plain_staged"]
        print(f"adversarial step B={TRAIN_B} on a staged batch: {float(np.median(adv_ms)):.2f} ms "
              f"(steps 2-{CLI_STEPS}: {[round(t, 2) for t in adv_ms]}), peak {adv_peak:.2f} GiB; "
              f"plain step {float(np.median(plain_ms)):.2f} ms ({[round(t, 2) for t in plain_ms]}), "
              f"peak {plain_peak:.2f} GiB [{card}]")

    critic_ms = adversarial_gpu_vs_cpu(cfg, dev, card)
    print(f"critic step alone (B={TRAIN_B}, {MEL_FRAMES} frames, f32): {critic_ms:.3f} ms by CUDA "
          f"events [{card}]")
    return {"launches": eval_launches}


def phase_demo(cfg, card: str, dev) -> dict:
    """The demo and long-video entry points at full width (see the module
    docstring); returns the AR kernel's launches on each."""
    import numpy as np
    from scipy.io import wavfile

    from lip2speech_torch.cli import demo, synthesize
    from lip2speech_torch.data import make_sample_lrw
    from lip2speech_torch.kernels import ar_decode as ar

    def check_wav(path: str):
        if not os.path.exists(path):
            fail(f"{path} was not written")
        sr, wav = wavfile.read(path)
        if sr != cfg.audio.sample_rate or len(wav) == 0 or not np.isfinite(wav).all():
            fail(f"{path}: {len(wav)} samples at {sr} Hz, finite {np.isfinite(wav).all()}")
        return len(wav)

    launches = {}
    with tempfile.TemporaryDirectory(prefix="lip2speech_demo_") as tmp:
        root = os.path.join(tmp, "lrw")
        make_sample_lrw(root, split="test", n_clips=SYNTH_CLIPS, n_samples=CLI_SAMPLES)
        for encoding in ("face", "voice"):
            out = os.path.join(tmp, encoding)
            ar.launches, packs = 0, ar.packs
            t0 = time.time()
            clips = demo.main(["--root", root, "--device", str(dev), "--encoding", encoding,
                               "--n_clips", str(DEMO_CLIPS), "--out", out, *_overrides(cfg)])
            launches[encoding], packed = ar.launches, ar.packs - packs
            wall = time.time() - t0
            files = set(os.listdir(out))
            for i in range(DEMO_CLIPS):
                lengths = [check_wav(os.path.join(out, f"clip{i}_{k}.wav"))
                           for k in ("gt", "gt_gl", "pred")]
                for png in ("mel_predicted", "mel_target", "alignment", "gate"):
                    if f"{png}_{i}.png" not in files:
                        fail(f"the demo did not write {png}_{i}.png")
            print(f"demo --encoding {encoding}: {len(clips)} clips in {wall:.1f} s (model set-up "
                  f"included); ms per clip {[round(c['ms'], 2) for c in clips]}; stop steps "
                  f"{[c['stop_step'] for c in clips]}; last clip's wavs {lengths} samples; "
                  f"ar_decode launches {launches[encoding]}, weight packs {packed} [{card}]")
            if len(clips) != DEMO_CLIPS or launches[encoding] != DEMO_CLIPS or packed != 1:
                fail(f"the demo ({encoding}) ran {len(clips)} clips with {launches[encoding]} "
                     f"kernel launches and {packed} weight packs")

        path = os.path.join(tmp, "synth.wav")
        ar.launches, packs = 0, ar.packs
        t0 = time.time()
        wav = synthesize.main(["--from_lrw", root, "--n_clips", str(SYNTH_CLIPS), "--out", path,
                               "--device", str(dev), *_overrides(cfg)])
        launches["synthesize"], packed = ar.launches, ar.packs - packs
        n = check_wav(path)
        print(f"synthesize --from_lrw --n_clips {SYNTH_CLIPS}: {n} samples in "
              f"{(time.time() - t0) * 1e3:.2f} ms (model set-up included), ar_decode launches "
              f"{launches['synthesize']}, weight packs {packed} [{card}]")
        if n != len(wav) or launches["synthesize"] != 1 or packed != 1:
            fail(f"synthesize wrote {n} samples with {launches['synthesize']} kernel launches and "
                 f"{packed} weight packs")
    return launches


def phase_corpora(cfg, card: str, dev) -> dict:
    """The WILD, GRID and AVSpeech readers through the entry points at full
    width (see the module docstring); returns the AR kernel's launches on
    each eval path and its numbers on one eval batch at T=50, M=126."""
    import contextlib
    import io

    import numpy as np
    import torch

    from lip2speech_torch.cli import evaluate as eval_cli
    from lip2speech_torch.cli import train as train_cli
    from lip2speech_torch.cli.common import load_model
    from lip2speech_torch.data import get_dataset, make_sample_streaming, make_sample_wild
    from lip2speech_torch.kernels import ar_decode as ar

    wild_cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, **WILD_BUCKET))
    out = {}
    with tempfile.TemporaryDirectory(prefix="lip2speech_corpora_") as tmp:
        roots = {"WILD": os.path.join(tmp, "wild"), "GRID": os.path.join(tmp, "grid"),
                 "AVSpeech": os.path.join(tmp, "avspeech")}
        t0 = time.time()
        make_sample_wild(roots["WILD"], n_clips=WILD_CLIPS, seed=SEED)
        make_sample_streaming(roots["GRID"], n_clips=STREAM_CLIPS, seed=SEED + 1)
        make_sample_streaming(os.path.join(roots["AVSpeech"], "test"), n_clips=STREAM_CLIPS,
                              ext=".mp4", seed=SEED + 2)
        print(f"corpora: fixtures of {WILD_CLIPS} WILD, {STREAM_CLIPS} GRID and {STREAM_CLIPS} "
              f"AVSpeech clips in {time.time() - t0:.1f} s")
        for name, root in roots.items():  # the videos decode and seek on this machine's cv2
            ds = get_dataset(name, root, mode="test", cfg=cfg.data,
                             rng=np.random.default_rng(SEED))
            s = ds[0]
            print(f"corpora: {name} sample mouth {s['mouth'].shape}, faces {s['faces'].shape}, "
                  f"audio {s['audio'].shape}")

        # the main path: train on WILD at the 2-second bucket, one eval tick
        ar.launches = 0
        t0 = time.time()
        res = train_cli.train(_cli_args(roots["WILD"], tmp, "wild", dev, "--dataset", "WILD",
                                        "--max_iters", str(CORPUS_STEPS),
                                        "--eval_interval", str(CORPUS_STEPS)), wild_cfg)
        torch.cuda.synchronize(dev)
        out["wild"] = ar.launches
        wall = time.time() - t0
        rows, evals = _step_rows(os.path.join(tmp, "run_wild"))
        ms = [r["step_time"] * 1e3 for r in rows[1:]]
        st = res["loader"]
        print(f"corpora train --dataset WILD B={TRAIN_B}, T=50, M=126: {len(rows)} steps and an "
              f"eval tick in {wall:.1f} s; {float(np.median(ms)):.2f} ms per step with the loader "
              f"(steps 2-{CORPUS_STEPS}: {[round(t, 2) for t in ms]}); losses "
              f"{[round(r['total'], 3) for r in rows]}; loader {st['host_s'] / st['batches'] * 1e3:.2f} "
              f"ms of host time a batch, {st['stalls']} stalls; eval tick "
              f"{evals[0]['step_time'] * 1e3 if evals else float('nan'):.2f} ms, ESTOI "
              f"{res['best_score']:.4f}, ar_decode launches {out['wild']} [{card}]")
        eval_batches = min(CLI_EVAL_BATCHES, -(-WILD_CLIPS // min(32, TRAIN_B)))
        if len(rows) != CORPUS_STEPS or len(evals) != 1 or not all(
                math.isfinite(r["total"]) for r in rows):
            fail(f"the WILD run logged {len(rows)} steps and {len(evals)} eval records, "
                 "or a non-finite loss")
        if out["wild"] != eval_batches:
            fail(f"the WILD eval tick launched the AR kernel {out['wild']} times for "
                 f"{eval_batches} batches")

        # the same step on a staged batch (the 64 segments are one batch)
        train_cli.train(_cli_args(roots["WILD"], tmp, "wild_staged", dev, "--dataset", "WILD",
                                  "--max_iters", str(CORPUS_STEPS), "--eval_interval", "1000",
                                  "--reuse_first_batch"), wild_cfg)
        staged, _ = _step_rows(os.path.join(tmp, "run_wild_staged"))
        ms_staged = [r["step_time"] * 1e3 for r in staged[1:]]
        print(f"corpora train --dataset WILD B={TRAIN_B} on a staged batch: "
              f"{float(np.median(ms_staged)):.2f} ms per step (steps 2-{CORPUS_STEPS}: "
              f"{[round(t, 2) for t in ms_staged]}); with the loader {float(np.median(ms)):.2f} ms "
              f"[{card}]")

        # the kernel against its plain version on one eval batch at T=50, M=126
        model, _ = load_model(wild_cfg, os.path.join(tmp, "ckpt_wild"), dev)
        wild_ds = get_dataset("WILD", roots["WILD"], mode="test", cfg=wild_cfg.data)
        out.update(eval_batch_checks(wild_cfg, model, wild_ds, dev, card))

        # cli.evaluate on GRID and AVSpeech at the default bucket
        for name in ("GRID", "AVSpeech"):
            buf = io.StringIO()
            ar.launches = 0
            t0 = time.time()
            with contextlib.redirect_stdout(buf):
                eval_cli.main(["--dataset", name, "--root", roots[name], "--model_path",
                               os.path.join(tmp, "ckpt_wild"), "--device", str(dev),
                               *_overrides(cfg)])
            torch.cuda.synchronize(dev)
            out[name] = ar.launches
            line = json.loads(buf.getvalue().strip().splitlines()[-1])
            print(f"corpora evaluate --dataset {name}: {json.dumps(line)} in "
                  f"{time.time() - t0:.1f} s, ar_decode launches {out[name]} [{card}]")
            if (line.get("n_clips") != STREAM_CLIPS or not math.isfinite(line.get("estoi", math.nan))
                    or out[name] != 1):
                fail(f"cli.evaluate --dataset {name} printed {line} with {out[name]} kernel launches")
    return out


class ReluSides:
    """Stands in for ``torch.nn.functional`` in the speaker models' modules:
    it records the side of 0 of every ReLU input, or, given a run's
    ``signs``, makes each ReLU take that side (``x * side``: the gradient
    passes where the recorded input was positive)."""

    MODULES = ("lip2speech_torch.models.face", "lip2speech_torch.speaker.models",
               "lip2speech_torch.speaker.losses")

    def __init__(self, signs=None):
        import torch.nn.functional

        self._f = torch.nn.functional
        self.signs = []
        self._given = None if signs is None else iter(signs)

    def __getattr__(self, name):
        return getattr(self._f, name)

    def relu(self, x, inplace=False):
        if self._given is None:
            self.signs.append((x > 0).cpu())
            return self._f.relu(x)
        return x * next(self._given).to(x.device)

    def __enter__(self):
        for name in self.MODULES:
            sys.modules[name].F = self
        return self

    def __exit__(self, *exc):
        for name in self.MODULES:
            sys.modules[name].F = self._f


def speaker_gpu_vs_cpu(cfg, cpu_model, batch: dict, card: str, dev):
    """One f32 speaker step (losses, new statistics, gradients) on the GPU
    and on the CPU, same weights, batch and draws, each held against an f64
    step on the CPU that takes its side at every ReLU kink; fails beyond
    phase 4's ``TRAIN_*`` bounds."""
    import torch

    from lip2speech_torch.speaker.train_loop import GROUPS, speaker_draws, speaker_loss_and_grad

    B = batch["speech"].shape[0]
    draws = speaker_draws(B, torch.Generator().manual_seed(SEED + 5), "cpu")
    names = [n for g in GROUPS for n, _ in
             ([("t", None)] if g == "t" else getattr(cpu_model, g).named_parameters(prefix=g))]

    def run(device, dtype, signs=None):
        model = copy.deepcopy(cpu_model).to(device, dtype)
        b = {k: v.to(device) for k, v in batch.items()}
        d = {k: v.to(device) for k, v in draws.items()}
        with ReluSides(signs) as sides:
            losses, stats, grads = speaker_loss_and_grad(model, b, d)
        grads = dict(zip(names, [g for group in GROUPS for g in grads[group]]))
        return [{k: v.detach().double().cpu() for k, v in part.items()}
                for part in (losses, stats, grads)] + [sides.signs]

    free, cpu, gpu = run("cpu", torch.float64), run("cpu", torch.float32), run(dev, torch.float32)
    ref_cpu, ref_gpu = run("cpu", torch.float64, cpu[3]), run("cpu", torch.float64, gpu[3])
    for label, got in (("CPU", cpu), ("GPU", gpu)):
        flips = sum(int((a != b).sum()) for a, b in zip(got[3], free[3]))
        print(f"speaker step B={B}, {label} f32: ReLU kinks on the other side from the free f64 "
              f"step: {flips} of {sum(x.numel() for x in got[3])}")
    worst = []
    for part, kind in enumerate(("losses", "BN statistics", "gradients")):
        top = max(float(v.abs().max()) for v in ref_gpu[part].values())
        ratio, name = max(
            (float((gpu[part][k] - r).abs().max())
             / (TRAIN_F32_FACTOR * float((cpu[part][k] - ref_cpu[part][k]).abs().max())
                + TRAIN_REL * float(r.abs().max()) + TRAIN_FLOOR * top), k)
            for k, r in ref_gpu[part].items())
        worst.append(ratio)
        print(f"speaker f32 step B={B}, against f64 on its kink sides: {kind} ({len(ref_gpu[part])}): "
              f"the GPU's error is at most {ratio:.3f} of its tolerance ({name}: GPU "
              f"{float((gpu[part][name] - ref_gpu[part][name]).abs().max()):.3e}, CPU f32 "
              f"{float((cpu[part][name] - ref_cpu[part][name]).abs().max()):.3e}, max "
              f"{float(ref_gpu[part][name].abs().max()):.3e}) [{card}]")
    if max(worst) > 1.0:
        fail("the f32 speaker step on the GPU disagrees with the CPU")


def phase_speaker(cfg, card: str, dev) -> None:
    """Speaker pretraining through its entry points at full width (see the
    module docstring)."""
    import numpy as np
    import torch

    from lip2speech_torch.cli import speaker_test, speaker_train
    from lip2speech_torch.data import make_sample_avspeech_face
    from lip2speech_torch.data.collate import to_device
    from lip2speech_torch.speaker import (AVSpeechFace, collate_speaker, init_speaker_training,
                                          speaker_train_step)
    from lip2speech_torch.train import checkpoint as ckpt

    with tempfile.TemporaryDirectory(prefix="lip2speech_speaker_") as tmp:
        root = os.path.join(tmp, "avspeech")
        t0 = time.time()
        make_sample_avspeech_face(root, "train", n_clips=SPEAKER_CLIPS, n_frames=60, seed=SEED)
        make_sample_avspeech_face(root, "test", n_clips=2, n_frames=60, seed=SEED + 1)
        print(f"speaker: fixture of {SPEAKER_CLIPS} + 2 clips in {time.time() - t0:.1f} s")

        # the main path: the pretraining CLI, then the qualitative test
        torch.cuda.reset_peak_memory_stats(dev)
        run_dir, ckpt_dir = os.path.join(tmp, "run"), os.path.join(tmp, "ckpt")
        t0 = time.time()
        state = speaker_train.main(["--root", root, "--batch_size", str(TRAIN_B), "--max_iters",
                                    str(SPEAKER_STEPS), "--log_interval", "1", "--device", str(dev),
                                    "--run_dir", run_dir, "--ckpt_dir", ckpt_dir])
        torch.cuda.synchronize(dev)
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        ms = [r["step_time"] * 1e3 for r in rows[1:]]
        print(f"speaker train B={TRAIN_B} f32: {len(rows)} steps in {wall:.1f} s (set-up "
              f"included); {float(np.median(ms)):.2f} ms per step with the host's reads (steps "
              f"2-{SPEAKER_STEPS}: {[round(t, 2) for t in ms]}); loss "
              f"{[round(r['loss'], 4) for r in rows]}, c_loss {[round(r['c_loss'], 4) for r in rows]}, "
              f"rec_loss {[round(r['rec_loss'], 4) for r in rows]}, t "
              f"{[round(r['t'], 6) for r in rows]}, peak memory {peak:.2f} GiB [{card}]")
        want = {"c_loss", "l2_loss", "rec_loss", "loss", "grad_norm", "t"}
        if len(rows) != SPEAKER_STEPS or not all(want <= set(r) for r in rows):
            fail(f"the speaker run logged {len(rows)} steps without {want}")
        if not all(math.isfinite(r[k]) for r in rows for k in want) or rows[-1]["t"] > 100.0:
            fail("the speaker run logged a non-finite value or t > 100")
        if ckpt.available_steps(ckpt_dir) != [SPEAKER_STEPS] or state.step != SPEAKER_STEPS:
            fail(f"the speaker checkpoints are {ckpt.available_steps(ckpt_dir)}")

        # the same step on a staged batch (no reads), on the trained state
        ds = AVSpeechFace(root, "train", cfg.data, rng=np.random.default_rng(SEED))
        staged = to_device(collate_speaker([ds[i % len(ds)] for i in range(TRAIN_B)]), dev)
        times = []
        for _ in range(3):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            speaker_train_step(state, staged)
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"speaker step B={TRAIN_B} f32 on a staged batch: {float(np.median(times)):.2f} ms "
              f"(median of 3: {[round(t, 2) for t in times]}) [{card}]")

        out = os.path.join(tmp, "test_out")
        emb = speaker_test.main(["--root", root, "--out", out, "--device", str(dev)])
        files = sorted(os.listdir(out))
        print(f"speaker test: {files}, |face emb| {float(np.linalg.norm(emb['face_embedding'])):.4f}, "
              f"|speech emb| {float(np.linalg.norm(emb['speech_embedding'])):.4f}")
        if files != ["face.jpg", "face_embedding.npy", "speech_embedding.npy"] or not all(
                np.isfinite(v).all() and v.shape == (1, 256) for v in emb.values()):
            fail("cli.speaker_test did not write finite embeddings")

        check = collate_speaker([ds[i] for i in range(SPEAKER_CHECK_B)])
        cpu_model = init_speaker_training(cfg, torch.Generator().manual_seed(SEED))
        speaker_gpu_vs_cpu(cfg, cpu_model, {k: torch.from_numpy(v) for k, v in check.items()},
                           card, dev)


def seeded_frames(n: int, size: int, seed: int):
    """Random RGB frames, every fourth smoothed (it scores lower: frames
    without a face at the threshold the phase picks)."""
    import cv2
    import numpy as np

    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (n, size, size, 3)).astype(np.uint8)
    for i in range(3, n, 4):
        frames[i] = cv2.GaussianBlur(frames[i], (0, 0), 6)
    return frames


def write_mjpg(path: str, frames) -> None:
    import cv2

    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 25,
                          (frames.shape[2], frames.shape[1]))
    for f in frames:
        out.write(f[:, :, ::-1])
    out.release()


def same_detections(got, want) -> tuple[bool, int]:
    """(same None pattern with boxes and landmarks within 1 px, largest px gap)."""
    import numpy as np

    if [r is None for r in got] != [r is None for r in want]:
        return False, -1
    gap = max([0] + [int(max(np.abs(g[0] - w[0]).max(), np.abs(g[1] - w[1]).max()))
                     for g, w in zip(got, want) if w is not None])
    return gap <= 1, gap


def phase_prep(card: str, dev) -> None:
    """The face detector and the preprocessing tools (see the module
    docstring)."""
    import numpy as np
    import torch
    from scipy.io import wavfile

    from lip2speech_torch.detect import FaceDetector
    from lip2speech_torch.prep import face_extractor, resample, speaker_preprocess
    from lip2speech_torch.prep import wild_preprocess
    from lip2speech_torch.utils.devtime import device_time

    cpu = torch.device("cpu")
    t0 = time.time()
    det_cpu = FaceDetector(device=cpu)
    det = FaceDetector(device=dev)
    print(f"prep: two detectors (CPU and {dev}) from the repo's weights in "
          f"{time.time() - t0:.1f} s")

    # RFB-320 on the card against the CPU, 32 frames through the host resize
    frames = seeded_frames(PREP_FRAMES, PREP_SIZE, SEED)
    x = torch.from_numpy(np.ascontiguousarray(FaceDetector.detector_input(frames)))
    want = det_cpu.detect_fn(x)
    x_dev = x.to(dev)
    got = det.detect_fn(x_dev)
    err = max(float((got[k].cpu() - want[k]).abs().max()) for k in ("scores", "boxes"))
    print(f"prep: RFB-320 B={PREP_FRAMES} 240x320 on {dev} vs CPU: max abs err {err:.3e} "
          f"(tol {DETECT_TOL})")
    if not err <= DETECT_TOL:
        fail(f"RFB-320 on the card is {err:.3e} off the CPU")
    ms = device_time(det.detect_fn, x_dev, n=10, repeats=5) * 1e3
    print(f"prep: RFB-320 {ms:.3f} ms per {PREP_FRAMES}-frame batch on the card "
          f"(devtime.device_time) [{card}]")

    # the landmark net, batch 1 each
    crops = np.random.RandomState(SEED + 1).uniform(
        0, 1, (PREP_FRAMES, 1, 3, 112, 112)).astype(np.float32)
    lerr = 0.0
    for c in crops:
        c = torch.from_numpy(c)
        out = det.landmark_fn(c.to(dev))
        lerr = max(lerr, float((out.cpu() - det_cpu.landmark_fn(c)).abs().max()))
        if out.shape != (1, 136):
            fail(f"the landmark net gave {tuple(out.shape)}")
    print(f"prep: landmark net {PREP_FRAMES} crops at batch 1 on {dev} vs CPU: max abs err "
          f"{lerr:.3e} (tol {LANDMARK_TOL})")
    if not lerr <= LANDMARK_TOL:
        fail(f"the landmark net on the card is {lerr:.3e} off the CPU")
    ms = device_time(det.landmark_fn, torch.from_numpy(crops[0]).to(dev), n=20, repeats=5) * 1e3
    print(f"prep: landmark net {ms:.3f} ms per forward (batch 1) on the card "
          f"(devtime.device_time) [{card}]")

    # the whole detector at a threshold that gives detections
    thr = float(np.percentile(want["scores"][..., 1].numpy(), 99.9))
    det.threshold = det_cpu.threshold = thr
    res, ref = det(frames), det_cpu(frames)
    ok, gap = same_detections(res, ref)
    found = sum(r is not None for r in ref)
    print(f"prep: FaceDetector(threshold={thr:.4f}) on {PREP_FRAMES} frames: {found} with a "
          f"face, largest gap to the CPU {gap} px")
    if not ok or found == 0:
        fail(f"FaceDetector on the card differs from the CPU (gap {gap}) or found no face")

    with tempfile.TemporaryDirectory(prefix="lip2speech_prep_") as tmp:
        # face_extractor over a 64-frame MJPG video, then a resuming pass
        video = os.path.join(tmp, "clip.avi")
        write_mjpg(video, seeded_frames(PREP_VIDEO_FRAMES, PREP_SIZE, SEED + 2))
        sidecar = os.path.join(tmp, "clip.json")
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        n = face_extractor.extract_faces_for_video(det, video, sidecar, PREP_BATCH)
        wall = time.perf_counter() - t0
        with open(sidecar) as f:
            first = f.read()
        ref_sidecar = os.path.join(tmp, "cpu.json")
        face_extractor.extract_faces_for_video(det_cpu, video, ref_sidecar, PREP_BATCH)
        with open(ref_sidecar) as f:
            ref_info = json.load(f)
        info = json.loads(first)
        keys_ok = sorted(info) == sorted(ref_info)
        gap = max([0] + [int(np.abs(np.subtract(info[k][f], ref_info[k][f])).max())
                         for k in info if k in ref_info for f in ("face_coords", "landmarks")])
        print(f"prep: face_extractor {PREP_VIDEO_FRAMES} frames (batch {PREP_BATCH}) in "
              f"{wall * 1e3:.1f} ms, {PREP_VIDEO_FRAMES / wall:.1f} frames/s, {n} with a face; "
              f"largest gap to the CPU's sidecar {gap} px [{card}]")
        if n == 0 or not keys_ok or gap > 1:
            fail("face_extractor's sidecar on the card differs from the CPU's")
        # where the extractor's time goes, on the host's clock: the decode, the
        # detector's host resize of a batch, one landmark crop
        import cv2

        t0 = time.perf_counter()
        cap = cv2.VideoCapture(video)
        decoded = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            decoded.append(f[:, :, ::-1])
        cap.release()
        t_decode = time.perf_counter() - t0
        t0 = time.perf_counter()
        FaceDetector.detector_input(np.stack(decoded[:PREP_BATCH]))
        t_resize = time.perf_counter() - t0
        box = np.array(info[sorted(info, key=int)[0]]["face_coords"])
        t0 = time.perf_counter()
        for _ in range(10):
            FaceDetector.landmark_crop(decoded[0], box)
        t_crop = (time.perf_counter() - t0) / 10
        print(f"prep: face_extractor's host parts: decode {PREP_VIDEO_FRAMES} frames "
              f"{t_decode * 1e3:.1f} ms, resize of a {PREP_BATCH}-frame batch "
              f"{t_resize * 1e3:.1f} ms, one landmark crop {t_crop * 1e3:.3f} ms [{card}]")
        calls = []

        def counting(batch):
            calls.append(len(batch))
            return det(batch)

        n2 = face_extractor.extract_faces_for_video(counting, video, sidecar, PREP_BATCH)
        with open(sidecar) as f:
            if f.read() != first or n2 != n or sum(calls) != PREP_VIDEO_FRAMES - n:
                fail("face_extractor's resuming pass changed the sidecar or detected again")

        # write_segment on a 2-second segment, its wav beside it (no ffmpeg)
        seg = os.path.join(tmp, "seg_00000.avi")
        write_mjpg(seg, seeded_frames(50, PREP_SIZE, SEED + 3))
        rng = np.random.RandomState(SEED)
        wavfile.write(os.path.join(tmp, "seg_00000.wav"), 16000,
                      (0.1 * rng.randn(32000)).astype(np.float32))
        t0 = time.perf_counter()
        if not wild_preprocess.write_segment(seg, det):
            fail("write_segment found no face")
        wall = time.perf_counter() - t0
        mel = np.load(os.path.join(tmp, "seg_00000.npz"))["data"]
        with open(os.path.join(tmp, "seg_00000.json")) as f:
            seg_faces = len(json.load(f))
        print(f"prep: write_segment 50 frames + 2 s in {wall * 1e3:.1f} ms: mel "
              f"{mel.shape}, {seg_faces} faces [{card}]")
        if mel.shape != (1, 80, 126) or not np.isfinite(mel).all() or not os.path.isfile(
                os.path.join(tmp, "seg_00000.done")):
            fail("write_segment wrote no finite mel or no .done marker")

        # the frame dump and the resampler
        if speaker_preprocess.video_to_frames(video) != PREP_VIDEO_FRAMES or len(
                os.listdir(os.path.join(tmp, "clip", "frames"))) != PREP_VIDEO_FRAMES:
            fail("video_to_frames did not dump every frame")
        wav_dir = os.path.join(tmp, "wavs")
        os.makedirs(wav_dir)
        wavfile.write(os.path.join(wav_dir, "a.wav"), 22050,
                      (0.1 * rng.randn(22050)).astype(np.float32))
        converted = resample.convert_sampling_rate(wav_dir)
        sr, data = wavfile.read(os.path.join(wav_dir, "a.wav"))
        print(f"prep: video_to_frames {PREP_VIDEO_FRAMES} frames; convert_sampling_rate "
              f"{converted} file to {sr} Hz, {len(data)} samples")
        if converted != 1 or sr != 16000 or len(data) != 16000:
            fail("convert_sampling_rate did not resample the 22050 Hz wav")


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    if not os.path.isdir(os.path.join(ROOT, "lip2speech_torch")):
        fail("lip2speech_torch is not beside chip_smoke.py")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from lip2speech_torch.config import Config

    cfg = Config()
    dev = torch.device("cuda")
    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    phase_build(card)
    profile = "--profile" in sys.argv[1:]
    if "--kernel-only" in sys.argv[1:]:
        phase_kernel(cfg, card, dev, batches=TIMED_BATCHES)
        print(card)
        return 0
    if "--train-only" in sys.argv[1:]:
        phase_train(cfg, card, dev, profile=profile)
        print(card)
        return 0
    if "--cli-only" in sys.argv[1:]:
        phase_cli(cfg, card, dev)
        print(card)
        return 0
    if "--adv-only" in sys.argv[1:]:
        phase_adversarial(cfg, card, dev)
        print(card)
        return 0
    if "--demo-only" in sys.argv[1:]:
        phase_demo(cfg, card, dev)
        print(card)
        return 0
    if "--corpora-only" in sys.argv[1:]:
        phase_corpora(cfg, card, dev)
        print(card)
        return 0
    if "--speaker-only" in sys.argv[1:]:
        phase_speaker(cfg, card, dev)
        print(card)
        return 0
    if "--prep-only" in sys.argv[1:]:
        phase_prep(card, dev)
        print(card)
        return 0
    results = phase_kernel(cfg, card, dev)
    launches = phase_pipeline(cfg, card, dev, profile=profile)
    phase_train(cfg, card, dev, profile=profile)
    at_eval = phase_cli(cfg, card, dev)
    at_adv = phase_adversarial(cfg, card, dev)
    at_demo = phase_demo(cfg, card, dev)
    at_corpora = phase_corpora(cfg, card, dev)
    phase_speaker(cfg, card, dev)
    phase_prep(card, dev)

    at_main = results[(MAIN_B, "bfloat16")]
    kernels = [{
        "name": "ar_decode",
        "route": "cuda",
        "source": "lip2speech_torch/csrc/ar_decode.cu",
        "replaces": "lip2speech_tpu/ops/pallas_decoder.py:47",
        "launches": launches,
        "max_abs_err": at_main["err"],
        "ms": at_main["ms"],
        "plain_ms": at_main["plain_ms"],
        "bound_ms": at_main["bound_ms"],
        "bound_by": at_main["bound_by"],
        # no single PyTorch call computes the AR decode
        "library_ms": None,
        # the eval path (phase 5): launches in the CLI's eval tick; the rest
        # on one eval batch, B=32, M=80, f32
        "eval_launches": at_eval["launches"],
        "eval_max_abs_err": at_eval["err"],
        "eval_ms": at_eval["ms"],
        "eval_plain_ms": at_eval["plain_ms"],
        "eval_bound_ms": at_eval["bound_ms"],
        # launches on the later entry points: the adversarial CLI's eval tick
        # (phase 6), the demo's clips by encoding and one long video (phase 7)
        "adversarial_eval_launches": at_adv["launches"],
        "demo_face_launches": at_demo["face"],
        "demo_voice_launches": at_demo["voice"],
        "synthesize_launches": at_demo["synthesize"],
        # the corpora (phase 8): launches in the WILD CLI's eval tick and in
        # cli.evaluate on GRID and AVSpeech; the kernel on one WILD eval
        # batch, B=32, T=50, M=126, f32
        "wild_eval_launches": at_corpora["wild"],
        "grid_eval_launches": at_corpora["GRID"],
        "avspeech_eval_launches": at_corpora["AVSpeech"],
        "wild_eval_max_abs_err": at_corpora["err"],
        "wild_eval_ms": at_corpora["ms"],
        "wild_eval_plain_ms": at_corpora["plain_ms"],
        "wild_eval_bound_ms": at_corpora["bound_ms"],
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
