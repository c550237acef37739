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
   (``utils.devtime.device_time``) and frames/s through the extractor;
11. data parallelism on the one card (``lip2speech_torch/parallel``): two
   ranks, each a process of this script (``--dp-rank``) with the
   environment ``torch.distributed.run`` gives a rank, over gloo, run (b)
   the first f32 step (TF32 off, global B=16, 8 a rank) against one rank on
   the whole batch with the same draws, then the bf16 step on a staged
   batch of 64 on one rank and on two, and the gradient bucket's and a
   forward's BatchNorm moment all-reduces alone; (a) ``cli.train`` on
   phase 5's fixture at full width, global B=64 bf16, 4 steps with an eval
   tick (each rank decodes its 16 rows of each eval batch through the AR
   kernel) and a resume for 1 more step, then the kernel against its plain
   version on each rank's rows of the first eval batch, the ranks in turn;
   (d) ``cli.speaker_train`` at B=64 f32 for 2 steps on phase 9's fixture.
   Then (c) one rank of (a)'s program in an NCCL group for one step.
   Checks: (b) within ``DP_*``; only rank 0 logs (one record a step);
   one kernel launch a rank per eval batch; both ranks resume at the saved
   step and end with the same parameters (a digest), as do the speaker
   ranks; finite losses. Prints each with the card's name and power limit.
12. tensor parallelism on the one card (``lip2speech_torch/parallel/tensor.py``):
   ``ops.image.align_face_batched`` on 32 seeded 160x160 crops, card
   against CPU (``ALIGN_*``); then ranks over gloo as in phase 11: (a) a 1
   x 2 grid (data x model; the K/V banks and ``conv_last`` sharded over the
   two ranks, which both hold all rows) against one rank on the first f32
   step at B=16 (``DP_*``, and ``TRAIN_F64_REL`` in f64), the replicated
   tensors the same on both ranks; the bf16 step on a staged batch of 64
   on one rank and on the grid with each one's peak memory, beside the
   memory reckoned to be sharded away; a forward's 11 all-gathers and a
   backward's 11 model-group all-reduces alone, at the shapes the step
   gave them; (b) ``cli.train`` on phase 5's fixture as a 2 x 2 grid, four
   ranks of 32 rows, B=64 bf16, 3 steps with an eval tick (each rank
   decodes its data index's 16 rows of each eval batch through the AR
   kernel); then a digest of the gathered state, the kernel against its
   plain version on each rank's rows (the ranks encode together, then take
   the card in turn) and the staged step's ms on the grid; then one rank
   resumes the grid's checkpoint, holding the gathered state bit for bit.
   Checks: the step within the bounds, one kernel launch a rank per eval
   batch, rank 0's records alone, the same digest on every rank, finite
   losses, the resume.
13. the port's last public surface on the card: ``models.get_network`` at
   full width (random weights from the seed) against ``Lip2Speech`` built
   from the same generator, one B=4 bf16 request each through the AR kernel
   (the mels bit for bit, one launch a network), and the kernel against its
   plain version on that request; ``ops.stft.istft(stft(x))`` at n_fft 1024
   and hop 256 on 16 one-second clips, against the CPU (``STFT_REL``) and x
   (``ROUND_TRIP_TOL``); ``ops.image.resize_bilinear`` of a (64, 29, 96, 96,
   3) video to 88x88 and 160x160 in f32 and bf16 against the CPU
   (``RESIZE_TOL``), and to its own size bit for bit;
   ``cli.common.common_config`` with ``--override mesh.model_parallel=1``.

Timings print with the card's name and power limit. The line before the
last is a JSON object listing each kernel; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside this file, it exits non-zero and prints no result.

Usage: python3 chip_smoke.py [--profile | --kernel-only | --train-only | --cli-only |
                              --adv-only | --demo-only | --corpora-only | --speaker-only |
                              --prep-only | --dp-only | --tp-only | --api-only]

``--profile`` adds, for each timed batch and for a train step, the device
time by kernel of one batch (torch.profiler) and the device's idle share.
``--kernel-only`` runs phases 1 and 2 alone at B in {4, 256} (with the
per-stage times) and prints no result line; ``--train-only`` runs phases 1
and 4, ``--cli-only`` phases 1 and 5, ``--adv-only`` phases 1 and 6 and
``--demo-only`` phases 1 and 7, ``--corpora-only`` phases 1 and 8 and
``--speaker-only`` phases 1 and 9, ``--prep-only`` phases 1 and 10, ``--dp-only``
phases 1 and 11, ``--tp-only`` phases 1 and 12, ``--api-only`` phases 1 and
13, and none of them prints a result line. ``--dp-rank`` is the entry of one
rank of phases 11 and 12.
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
# phase 11, data parallelism: ranks on the one card, over gloo (NCCL runs one
# rank a card); the CLI's steps, the resume's, the speaker CLI's
DP_RANKS, DP_STEPS, DP_RESUMED, DP_SPEAKER_STEPS = 2, 4, 1, 2
# one rank against two on the first f32 step (TF32 off), global batch
# DP_CHECK_B, the same draws: the losses within DP_LOSS_RTOL plus
# DP_LOSS_ATOL (the KLD is a small difference of logs: ~1e-5, and 2.8e-8
# apart in a CPU rehearsal; tests/test_torch_train_step.py's floor), the new
# statistics within DP_STAT_RTOL (plus TRAIN_FLOOR of the
# largest of their kind: running means behind a BatchNorm are 0 up to
# rounding); the parameters by JAX's caps for its DP step against one
# device (tests/test_train_step.py:258-265): no entry more than
# 2.5 * lr apart, and at most total / 2000 (decoder) or total / 50
# (encoder) entries more than lr / 20 apart (AMSGrad's first step is
# ~sign(g) * lr, so an entry whose gradient is 0 up to rounding may flip)
DP_CHECK_B, DP_LOSS_RTOL, DP_LOSS_ATOL, DP_STAT_RTOL = 16, 1e-5, 1e-6, 1e-4
# the gradient norms (the whole, the encoder's, the decoder's) within
# DP_NORM_RTOL: the f32 gradients come back through the 80-step loop's
# backward and the encoder's ReLU kinks, where the other reduction order of a
# batch of 8 against 16 moves them: 3.483e-04 to 3.490e-04 on the whole,
# 3.502e-04 to 3.504e-04 on the encoder's and 2.141e-04 on the decoder's
# measured on an H100, so about 3x the largest reading (JAX's own DP test,
# tests/test_train_step.py:254, allows 1e-2). The same step in f64 must agree
# within TRAIN_F64_REL (losses and gradient norms): there only the order of
# the reductions differs
DP_NORM_RTOL = 1e-3
DP_TIMED = 3
DP_TIMEOUT_S = 600
# phase 12, tensor parallelism: ranks on the one card over gloo, as phase 11's.
# (a) a 1 x 2 grid (data x model) against one rank on the first f32 step at
# DP_CHECK_B, within phase 11's DP_* bounds (and TRAIN_F64_REL in f64);
# (b) cli.train on a 2 x 2 grid for TP_STEPS steps with an eval tick
TP_CHECK_GRID, TP_CLI_GRID, TP_STEPS = (1, 2), (2, 2), 3
# align_face_batched on the card against the CPU, pixel values 0-255: within
# ALIGN_TOL, but for at most ALIGN_EDGE_VALUES values whose sampling position
# lies within rounding of the image's edge (inside on one side only)
ALIGN_TOL, ALIGN_EDGE_VALUES = 1e-2, 60

# phase 13: istft(stft(x)) on SURFACE_CLIPS one-second clips of unit-variance
# noise at n_fft 1024, hop 256, the card against the CPU within STFT_REL of
# the largest value (the CPU tests hold both against JAX within 1e-5) and
# against x within ROUND_TRIP_TOL (1.2e-06 measured on the CPU at n_fft 512)
SURFACE_CLIPS, SURFACE_SAMPLES = 16, 16000
STFT_REL, ROUND_TRIP_TOL = 1e-5, 1e-4
# resize_bilinear of a (RESIZE_B, T, 96, 96, 3) video on [0, 1] to each size,
# the card against the CPU: f32 within the CPU tests' bound against JAX; bf16
# is resized in f32 and rounded, so within one bf16 step below 1
RESIZE_B, RESIZE_SIZES = 64, (88, 160)
RESIZE_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8}


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


def encode_rows(model, batch, dev) -> tuple[dict, dict, object]:
    """(the AR loop's parameters, the decoder's encoded inputs, the BOS rows)
    of a prepared eval batch (or a request's ``video`` and ``faces``), in
    eval mode with the model's weights. A tensor-parallel model runs its
    banks' collectives here."""
    import torch

    B = batch["video"].shape[0]
    model.eval()
    with torch.no_grad():
        feats = model.encoder(batch["video"])
        emb = model.vgg_face.inference(batch["faces"][:, 0].permute(0, 3, 1, 2))
        visual = torch.cat([feats, emb[:, None].expand(-1, feats.shape[1], -1)], -1)
        dec = model.decoder
        enc = dec.encode(visual, emb, generator=torch.Generator(device=dev).manual_seed(SEED))
        return dec.ar_params(), enc, dec.BOS.reshape(1, -1).expand(B, -1)


def ar_decode_on_rows(cfg, model, batch, dev, label: str, card: str) -> dict:
    """The AR kernel against its plain version on a prepared eval batch
    (f32 weights, the mels' M steps), with their times and the bound;
    fails beyond ``TOL['float32']``."""
    p, enc, bos = encode_rows(model, batch, dev)
    return ar_decode_check(cfg, p, enc, bos, batch["mel"].shape[-1], dev, label, card)


def ar_decode_check(cfg, p, enc, bos, M: int, dev, label: str, card: str,
                    wd=None) -> dict:
    """``ar_decode_on_rows`` on the encoded inputs (``encode_rows``), with
    weights of type ``wd`` (f32 by default; bf16 within ``TOL['bfloat16']``
    and the lengths within ``lengths_check``)."""
    import torch

    from lip2speech_torch.kernels import ar_decode as ar

    wd = wd or torch.float32
    name = str(wd).split(".")[-1]
    B = bos.shape[0]
    with torch.no_grad():
        ref = ar.ar_decode_reference(cfg.model, p, enc, bos, M, wd)
        got = ar.ar_decode_cuda(cfg.model, p, enc, bos, M, wd)
        torch.cuda.synchronize(dev)
        errs = [float((g - r).abs().max()) for g, r in zip(got, ref)]
        len_ok = lengths_check(ref[1], got[1], cfg.model.gate_threshold)[0]
        ms = cuda_ms(lambda: ar.ar_decode_cuda(cfg.model, p, enc, bos, M, wd), reps=5)
        plain = cuda_ms(lambda: ar.ar_decode_reference(cfg.model, p, enc, bos, M, wd), reps=1)
    flops, nbytes = ar_decode_work(cfg.model, B, enc["k"].shape[1], enc["content_key"].shape[1],
                                   M, 2 if wd == torch.bfloat16 else 4)
    bms, by = bound_ms(flops, nbytes, name)
    print(f"ar_decode on {label} (B={B}, T={enc['k'].shape[1]}, M={M}, {name}): max|err| mel "
          f"{errs[0]:.3e} stop "
          f"{errs[1]:.3e} attn {errs[2]:.3e} (tol {TOL[name]}); kernel {ms:.3f} ms, plain "
          f"{plain:.3f} ms, bound {bms:.4f} ms ({by}) [{card}]")
    if any(e > t for e, t in zip(errs, TOL[name])) or not len_ok or not all(
            bool(torch.isfinite(g).all()) for g in got):
        fail(f"the AR kernel disagrees with its plain version on {label}")
    return {"err": max(errs), "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by}


def eval_rows(cfg, ds, rows, dev) -> tuple[dict, dict]:
    """(the collated clips ``rows`` of ``ds``, prepared on ``dev``)."""
    from lip2speech_torch.data.collate import collate, prepare_batch, to_device

    raw = collate([ds[i] for i in rows], cfg.data)
    return raw, prepare_batch(to_device(raw, dev), cfg.audio, cfg.data)


def eval_batch_checks(cfg, model, ds, dev, card: str) -> dict:
    """On the first eval batch (32 test clips, f32 weights): the AR kernel
    against its plain version at the eval tick's shape (M=80), with their
    times and the bound; and the device ESTOI against the host's on the
    waveforms of that batch."""
    import numpy as np
    import torch

    from lip2speech_torch.eval import evaluate
    from lip2speech_torch.ops import estoi as estoi_ops

    B = min(32, len(ds))
    raw, batch = eval_rows(cfg, ds, range(B), dev)
    k1 = ar_decode_on_rows(cfg, model, batch, dev, "an eval batch", card)

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
    return k1


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


def free_ports(n: int) -> list[int]:
    """``n`` distinct free ports on this host."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for sock in socks:
            sock.bind(("127.0.0.1", 0))
        return [sock.getsockname()[1] for sock in socks]
    finally:
        for sock in socks:
            sock.close()


def next_group_port():
    """Point ``MASTER_PORT`` at the next of the ports ``run_ranks`` handed
    this rank: a group started right after another on the same port could
    reach the previous group's store before rank 0 has closed it."""
    ports = os.environ["DP_PORTS"].split(",")
    i = int(os.environ.get("DP_PORT_INDEX", "0"))
    os.environ["MASTER_PORT"], os.environ["DP_PORT_INDEX"] = ports[i], str(i + 1)


def run_ranks(world: int, job: str, tmp: str, dev, cfg) -> list[dict]:
    """Run ``world`` ranks of ``job`` (``dp_rank``), each a process of this
    script with the environment ``torch.distributed.run`` gives a rank.
    Fails as soon as a rank exits non-zero (the others are killed), and
    after ``DP_TIMEOUT_S``. Returns each rank's result. On the CPU (a
    rehearsal) the ranks get this process's constants and ``cfg``."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", WORLD_SIZE=str(world),
               LOCAL_WORLD_SIZE=str(world), DP_PORTS=",".join(map(str, free_ports(8))))
    if str(dev) == "cpu":
        env["CHIP_SMOKE_REHEARSAL"] = json.dumps({"overrides": _overrides(cfg), "constants": {
            k: globals()[k] for k in ("TRAIN_B", "DP_CHECK_B", "SPEAKER_CLIPS", "CLI_EVAL_BATCHES")}})
    procs, logs = [], []
    for rank in range(world):
        logs.append(open(os.path.join(tmp, f"{job}_rank{rank}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-rank", job, tmp, str(dev)],
            env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)), stdout=logs[-1],
            stderr=subprocess.STDOUT))
    deadline = time.monotonic() + DP_TIMEOUT_S
    while any(p.poll() is None for p in procs) and not any(p.poll() for p in procs):
        if time.monotonic() > deadline:
            break
        time.sleep(0.5)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    for f in logs:
        f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        for r in range(world):
            with open(os.path.join(tmp, f"{job}_rank{r}.log")) as f:
                sys.stderr.write(f"--- {job} rank {r} (exit {procs[r].returncode}):\n"
                                 f"{f.read()[-6000:]}\n")
        fail(f"the {world}-rank {job} run failed on rank(s) {bad}")
    results = []
    for rank in range(world):
        with open(os.path.join(tmp, f"{job}_rank{rank}.json")) as f:
            results.append(json.load(f))
    return results


def state_hash(module) -> str:
    """A digest of every tensor of ``module``'s state (or of a state dict),
    bit for bit."""
    import hashlib

    import torch

    h = hashlib.sha256()
    sd = module if isinstance(module, dict) else module.state_dict()
    for k, v in sorted(sd.items()):
        h.update(k.encode())
        h.update(v.detach().reshape(-1).contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def param_caps(before: dict, want: dict, got: dict, lr: float) -> dict:
    """JAX's statistics of a DP step against one device's, by part
    (``encoder``, ``decoder``): the worst entry's distance between the
    trained parameters ``got`` and ``want``, the entries more than lr / 20
    apart and the total; and, of the changes from ``before``, the share of
    the one-rank change's entries above lr / 2 whose sign the other shares,
    and their relative L2 distance (``change_agreement``)."""
    import torch

    out = {}
    want, got = ({k: v.detach() for k, v in d.items()} for d in (want, got))
    for part in ("encoder", "decoder"):
        worst, bad, total, agree, n_big, diff2, norm2 = 0.0, 0, 0, 0, 0, 0.0, 0.0
        for k in before:
            if not k.startswith(part + "."):
                continue
            d = (got[k] - want[k]).abs().double()
            worst = max(worst, float(d.max()))
            bad += int((d > 0.05 * lr).sum())
            total += d.numel()
            ref, have = (want[k] - before[k]).double(), (got[k] - before[k]).double()
            big = ref.abs() > 0.5 * lr
            agree += int((torch.sign(have[big]) == torch.sign(ref[big])).sum())
            n_big += int(big.sum())
            diff2 += float(((have - ref) ** 2).sum())
            norm2 += float((ref ** 2).sum())
        out[part] = {"worst": worst, "bad": bad, "total": total,
                     "sign": agree / max(n_big, 1), "l2": (diff2 / max(norm2, 1e-300)) ** 0.5}
    return out


LOSSES = ("mel_loss", "postnet_mel_loss", "gate_loss", "KLD", "total")


def stats_over_tolerance(mine: dict, theirs: dict) -> float:
    """The largest distance of a BatchNorm statistic in ``mine`` from
    ``theirs`` over its tolerance: ``DP_STAT_RTOL`` of the tensor's largest
    entry plus ``TRAIN_FLOOR`` of the largest of its kind (<= 1 within)."""
    def kind(k):
        return k.rsplit(".", 1)[-1]

    peak = {}
    for k, v in theirs.items():
        peak[kind(k)] = max(peak.get(kind(k), 0.0), float(v.abs().max()))
    return max(float((mine[k] - v).abs().max())
               / (DP_STAT_RTOL * float(v.abs().max()) + TRAIN_FLOOR * peak[kind(k)])
               for k, v in theirs.items())


def median_ms(fn, dev, reps: int = DP_TIMED) -> float:
    """The median host ms of ``reps`` synchronised calls of ``fn`` after one
    warm-up."""
    import numpy as np
    import torch

    fn()
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


def dp_step_check(cfg, dev, card: str) -> dict:
    """Phase 11 (b): the first f32 step on one rank against two, the same
    global batch and draws; then the bf16 step's ms on one rank against
    two on a staged batch, and the collectives' ms."""
    import torch

    from lip2speech_torch.models.layers import FlaxRuleBatchNorm
    from lip2speech_torch.models.lip2speech import Lip2Speech, init_random_
    from lip2speech_torch.parallel import dist as pdist
    from lip2speech_torch.train.train_step import (apply_update, batch_norm_stats,
                                                   create_train_state, loss_and_grad,
                                                   step_draws, train_step)

    def step_with_norms(st, b, group):
        """``train_step``'s two halves, and the norms of the encoder's and
        the decoder's gradients (over every rank's share)."""
        gen = step_draws(SEED, st.step, dev, group, b["mel"].shape[0])
        losses, stats, grads = loss_and_grad(st, b, TRAIN_TF, cfg32, None, gen, group)
        g = pdist.all_reduce_(st.opt.flatten(grads, dtype=None), group)
        enc = torch.cat([torch.full((p.numel(),), n.startswith("encoder."), device=dev)
                         for n, p in zip(st.opt.names, st.opt.params)])
        norms = [float(torch.sqrt(torch.sum(g[m] ** 2))) for m in (enc, ~enc)]
        return apply_update(st, cfg32, losses, stats, grads, group), norms

    def f64_step(rows, group):
        """The losses and gradient norms of the same first step in f64."""
        model = init_random_(Lip2Speech(cfg.model), torch.Generator().manual_seed(SEED))
        st = create_train_state(cfg32, model.double().to(dev))
        b = {k: v.double() if v.is_floating_point() else v for k, v in rows.items()}
        metrics, norms = step_with_norms(st, b, group)
        return [float(metrics[k]) for k in LOSSES] + norms

    next_group_port()
    dp = pdist.init_from_env(str(dev), "gloo")
    try:
        cfg32 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, bf16=False))
        model = init_random_(Lip2Speech(cfg.model), torch.Generator().manual_seed(SEED))
        state = create_train_state(cfg32, model.to(dev))
        batch = make_train_batch(cfg, DP_CHECK_B, SEED + 5, dev)
        batch.pop("audio"), batch.pop("audio_lengths")
        local = {k: pdist.local_rows(v, dp.rank, dp.world) for k, v in batch.items()}
        before = {n: p.detach().clone() for n, p in zip(state.opt.names, state.opt.params)}
        out = {}
        if dp.rank == 0:
            ref = copy.deepcopy(state)
            want, want_norms = step_with_norms(ref, batch, None)
        got, got_norms = step_with_norms(state, local, dp)
        out["same_on_ranks"] = pdist.same_on_all_ranks(list(state.model.state_dict().values()), dp)
        if dp.rank == 0:
            out["losses"] = {k: [float(got[k]), float(want[k])] for k in LOSSES}
            out["grad_norm"] = [float(got["grad_norm"]), float(want["grad_norm"])]
            out["part_norms"] = {part: [g, w] for part, g, w in
                                 zip(("encoder", "decoder"), got_norms, want_norms)}
            out["stats"] = stats_over_tolerance(batch_norm_stats(state.model),
                                                batch_norm_stats(ref.model))
            out["params"] = param_caps(before, dict(zip(ref.opt.names, ref.opt.params)),
                                       dict(zip(state.opt.names, state.opt.params)),
                                       cfg.train.learning_rate)
            del ref
        del before
        # the same step in f64: only the order of the reductions differs
        if dp.rank == 0:
            want64 = f64_step(batch, None)
        got64 = f64_step(local, dp)
        if dp.rank == 0:
            out["f64"] = max(abs(g - w) / abs(w) for g, w in zip(got64, want64))
        # the bf16 step on a staged batch: one rank on the whole batch, then two
        batch = make_train_batch(cfg, TRAIN_B, SEED + 6, dev)
        batch.pop("audio"), batch.pop("audio_lengths")
        local = {k: pdist.local_rows(v, dp.rank, dp.world) for k, v in batch.items()}

        def timed(fn):
            return median_ms(fn, dev)

        if dp.rank == 0:
            alone = copy.deepcopy(state)
            out["one_rank_ms"] = timed(lambda: train_step(alone, batch, TRAIN_TF, cfg))
            del alone
        pdist.barrier(dp)
        out["two_rank_ms"] = timed(lambda: train_step(state, local, TRAIN_TF, cfg, dp=dp))
        # the collectives alone: the gradient bucket, a forward's BatchNorm moments
        g = torch.zeros(sum(p.numel() for p in state.opt.params), device=dev)
        out["grad_mib"] = g.numel() * 4 / 2**20
        out["grad_allreduce_ms"] = timed(lambda: pdist.all_reduce_(g, dp))
        moments = [torch.zeros(2 * m.num_features + 1, device=dev)
                   for part in (state.model.encoder, state.model.decoder)
                   for m in part.modules() if isinstance(m, FlaxRuleBatchNorm)]
        out["bn_layers"] = len(moments)

        def bn_round():
            for t in moments:
                pdist.all_reduce_(t, dp)

        out["bn_allreduce_ms"] = timed(bn_round)
        return out
    finally:
        pdist.shutdown(dp)


def dp_cli(cfg, tmp: str, dev, card: str) -> dict:
    """Phase 11 (a): this rank of ``cli.train`` over gloo (steps, an eval
    tick through K1, a resume); K1 against its plain version on this
    rank's rows of the first eval batch."""
    import torch

    from lip2speech_torch.cli import train as train_cli
    from lip2speech_torch.data import get_dataset
    from lip2speech_torch.kernels import ar_decode as ar
    from lip2speech_torch.parallel import dist as pdist

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    root = os.path.join(tmp, "lrw")
    extra = ("--dist_backend", "gloo")
    # the main path: the kernel's launches count from here
    next_group_port()
    ar.launches = 0
    first = train_cli.train(_cli_args(root, tmp, "dp", dev, "--max_iters", str(DP_STEPS),
                                      "--eval_interval", str(DP_STEPS), *extra), cfg)
    if str(dev) != "cpu":
        torch.cuda.synchronize(dev)
    launches = ar.launches
    per = min(32, TRAIN_B) // world
    ds = get_dataset("LRW", root, mode="test", cfg=cfg.data)
    _, batch = eval_rows(cfg, ds, range(rank * per, (rank + 1) * per), dev)
    next_group_port()
    dp = pdist.init_from_env(str(dev), "gloo")  # the ranks take the card in turn
    try:
        for turn in range(world):
            if turn == rank:
                k1 = ar_decode_on_rows(cfg, first["state"].model, batch, dev,
                                       f"rank {rank}'s eval rows", card)
            pdist.barrier(dp)
    finally:
        pdist.shutdown(dp)
    next_group_port()
    second = train_cli.train(_cli_args(root, tmp, "dp", dev, "--max_iters",
                                       str(DP_STEPS + DP_RESUMED), "--eval_interval", "1000",
                                       *extra), cfg)
    return {"launches": launches, "k1": k1, "best": first["best_score"],
            "start": second["start_step"], "start_best": second["start_best_score"],
            "final": second["final_step"], "hash": state_hash(second["state"].model)}


def dp_speaker(cfg, tmp: str, dev) -> dict:
    """Phase 11 (d): this rank of ``cli.speaker_train`` over gloo."""
    from lip2speech_torch.cli import speaker_train

    next_group_port()
    state = speaker_train.train(speaker_train.parse_args([
        "--root", os.path.join(tmp, "avspeech"), "--batch_size", str(TRAIN_B), "--max_iters",
        str(DP_SPEAKER_STEPS), "--log_interval", "1", "--device", str(dev), "--dist_backend",
        "gloo", "--run_dir", os.path.join(tmp, "run_speaker"), "--ckpt_dir",
        os.path.join(tmp, "ckpt_speaker")]), cfg)
    return {"step": state.step, "hash": state_hash(state.model)}


def dp_rank(job: str, tmp: str, device: str) -> int:
    """One rank of phase 11, started by ``run_ranks``: ``main`` runs (b),
    (a) and (d) over gloo, ``nccl`` one step of (a)'s program in an NCCL
    group. Writes the rank's result as JSON beside its log."""
    import torch

    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from lip2speech_torch.config import Config, config_with_overrides

    cfg, dev = Config(), torch.device(device)
    rehearsal = json.loads(os.environ.get("CHIP_SMOKE_REHEARSAL", "null"))
    if rehearsal is not None:
        cfg = config_with_overrides(*rehearsal["overrides"][1::2])
        globals().update(rehearsal["constants"])
        _rehearse_on_cpu()
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        card = card_line()
    else:
        card = "the CPU (a rehearsal)"
    if job == "main":
        out = {"step": dp_step_check(cfg, dev, card), "cli": dp_cli(cfg, tmp, dev, card),
               "speaker": dp_speaker(cfg, tmp, dev)}
    elif job == "tp_step":
        out = {"tp_step": tp_step_check(cfg, dev, card)}
    elif job == "tp_cli":
        out = {"tp_cli": tp_cli(cfg, tmp, dev, card)}
    else:
        from lip2speech_torch.cli import train as train_cli

        next_group_port()
        res = train_cli.train(_cli_args(os.path.join(tmp, "lrw"), tmp, "nccl", dev, "--max_iters",
                                        "1", "--eval_interval", "1000", "--multihost",
                                        "--dist_backend", "nccl"), cfg)
        out = {"final": res["final_step"]}
    with open(os.path.join(tmp, f"{job}_rank{os.environ['RANK']}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _rehearse_on_cpu():
    """A rank of a CPU rehearsal: the kernel's plain version in its place,
    host clocks for the device's."""
    import torch

    from lip2speech_torch.kernels import ar_decode as ar

    real = ar.ar_decode_reference

    def counted(*a, **k):
        ar.launches += 1
        return real(*a, **k)

    ar.ar_decode_cuda = counted
    import lip2speech_torch.models.decoder as decoder_mod

    decoder_mod.ar_decode = lambda cfg, p, enc, bos, n, weight_dtype=None: counted(
        cfg, p, enc, bos, n, weight_dtype)
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.empty_cache = lambda: None
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.max_memory_allocated = lambda *a, **k: 0

    def host_ms(fn, reps):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps

    globals()["cuda_ms"] = host_ms


def phase_dp(cfg, card: str, dev) -> dict:
    """Data parallelism on the card (see the module docstring); returns the
    AR kernel's numbers on the ranks' eval ticks for the kernels line."""
    import numpy as np

    from lip2speech_torch.data import make_sample_avspeech_face

    if str(dev) != "cpu":
        import torch

        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="lip2speech_dp_") as tmp:
        t0 = time.time()
        write_fixture(os.path.join(tmp, "lrw"))
        make_sample_avspeech_face(os.path.join(tmp, "avspeech"), "train", n_clips=SPEAKER_CLIPS,
                                  n_frames=60, seed=SEED)
        print(f"dp: fixtures in {time.time() - t0:.1f} s")
        t0 = time.time()
        ranks = run_ranks(DP_RANKS, "main", tmp, dev, cfg)
        print(f"dp: {DP_RANKS} ranks over gloo on one card, (b) + (a) + (d) in "
              f"{time.time() - t0:.1f} s (process start-up included)")

        faults = []  # every result prints before the phase fails

        # (b) one rank against two, the first f32 step
        st = ranks[0]["step"]
        # each loss's distance over its tolerance
        loss_rel = max(abs(g - w) / (DP_LOSS_RTOL * abs(w) + DP_LOSS_ATOL)
                       for g, w in st["losses"].values())
        norm_rel = {k: abs(g - w) / w for k, (g, w) in
                    [("total", st["grad_norm"]), *st["part_norms"].items()]}
        lr = cfg.train.learning_rate
        caps = {"encoder": 50, "decoder": 2000}
        print(f"dp step f32 B={DP_CHECK_B} ({DP_CHECK_B // DP_RANKS} a rank) against one rank: "
              f"total {st['losses']['total'][0]:.6f} / {st['losses']['total'][1]:.6f}, the losses "
              f"at {loss_rel:.3f} of their tolerance; gradient norms rel " + ", ".join(
                  f"{k} {v:.3e}" for k, v in norm_rel.items()) + f" (tol {DP_NORM_RTOL} each); "
              f"statistics at {st['stats']:.3f} of their tolerance; "
              + "; ".join(f"{part}: worst {p['worst']:.3e} (cap {2.5 * lr:.1e}), {p['bad']} of "
                          f"{p['total']} entries over lr/20 (cap {max(10, p['total'] // caps[part])}),"
                          f" sign {p['sign']:.5f}, L2 {p['l2']:.3e}"
                          for part, p in st["params"].items()) + f"; the same step in f64: "
              f"losses and gradient norms rel {st['f64']:.3e} (tol {TRAIN_F64_REL}) [{card}]")
        if not all(r["step"]["same_on_ranks"] for r in ranks):
            faults.append("the ranks' parameters differ after a data-parallel step")
        if loss_rel > 1.0 or st["stats"] > 1.0 or max(norm_rel.values()) > DP_NORM_RTOL or (
                st["f64"] > TRAIN_F64_REL) or any(
                p["worst"] > 2.5 * lr or p["bad"] > max(10, p["total"] // caps[part])
                for part, p in st["params"].items()):
            faults.append("the two-rank step disagrees with the one-rank step")
        print(f"dp step bf16 B={TRAIN_B} on a staged batch: one rank {st['one_rank_ms']:.2f} ms, "
              f"{DP_RANKS} ranks ({TRAIN_B // DP_RANKS} each) on the one card over gloo "
              f"{ranks[0]['step']['two_rank_ms']:.2f} / {ranks[1]['step']['two_rank_ms']:.2f} ms; "
              f"the {st['grad_mib']:.1f} MiB gradient all-reduce {st['grad_allreduce_ms']:.2f} ms; "
              f"the {st['bn_layers']} BatchNorm moment all-reduces of a forward "
              f"{st['bn_allreduce_ms']:.2f} ms [{card}]")

        # (a) the training CLI on two ranks
        cli = [r["cli"] for r in ranks]
        rows, evals = _step_rows(os.path.join(tmp, "run_dp"))
        steps = [r["step"] for r in rows]
        eval_batches = min(CLI_EVAL_BATCHES, -(-CLI_TEST_CLIPS // min(32, TRAIN_B)))
        print(f"dp cli B={TRAIN_B} ({TRAIN_B // DP_RANKS} a rank): steps logged {steps}, "
              f"{float(np.median([r['step_time'] * 1e3 for r in rows[1:DP_STEPS]])):.2f} ms per step "
              f"with the loader (median of steps 2-{DP_STEPS}), eval ESTOI {cli[0]['best']:.4f}; "
              f"ar_decode launches by rank {[c['launches'] for c in cli]} for {eval_batches} eval "
              f"batches; resumed at {[c['start'] for c in cli]}, ended at "
              f"{[c['final'] for c in cli]}; checkpoints {sorted(os.listdir(os.path.join(tmp, 'ckpt_dp')))} "
              f"[{card}]")
        for r, c in enumerate(cli):
            print(f"dp rank {r}: ar_decode on its eval rows: max|err| {c['k1']['err']:.3e}, kernel "
                  f"{c['k1']['ms']:.3f} ms, plain {c['k1']['plain_ms']:.3f} ms, bound "
                  f"{c['k1']['bound_ms']:.4f} ms [{card}]")
        if steps != list(range(1, DP_STEPS + DP_RESUMED + 1)) or len(evals) != 1:
            faults.append(f"metrics.jsonl holds steps {steps} and {len(evals)} eval records: "
                          "not rank 0's alone")
        if not all(math.isfinite(r["total"]) for r in rows):
            faults.append("the data-parallel CLI logged a non-finite loss")
        if any(c["launches"] != eval_batches for c in cli):
            faults.append("a rank's eval tick did not launch the AR kernel once per batch")
        if any(c["start"] != DP_STEPS or c["final"] != DP_STEPS + DP_RESUMED
               or c["start_best"] != cli[0]["best"] for c in cli):
            faults.append("a rank did not resume where rank 0 saved")
        if len({c["hash"] for c in cli}) != 1:
            faults.append("the ranks end the CLI run with different parameters")

        # (d) the speaker CLI on two ranks
        sp = [r["speaker"] for r in ranks]
        with open(os.path.join(tmp, "run_speaker", "metrics.jsonl")) as f:
            srows = [json.loads(line) for line in f]
        print(f"dp speaker B={TRAIN_B} f32 ({TRAIN_B // DP_RANKS} a rank): steps "
              f"{[r['step'] for r in srows]}, loss {[round(r['loss'], 4) for r in srows]}, ms "
              f"{[round(r['step_time'] * 1e3, 2) for r in srows]}; the same weights on every rank: "
              f"{len({s['hash'] for s in sp}) == 1} [{card}]")
        if [r["step"] for r in srows] != list(range(1, DP_SPEAKER_STEPS + 1)) or not all(
                math.isfinite(r["loss"]) for r in srows):
            faults.append("the data-parallel speaker CLI logged other steps or a non-finite loss")
        if len({s["hash"] for s in sp}) != 1 or any(s["step"] != DP_SPEAKER_STEPS for s in sp):
            faults.append("the speaker ranks end with different weights")

        # (c) one rank in an NCCL group
        if str(dev) != "cpu":
            t0 = time.time()
            nccl = run_ranks(1, "nccl", tmp, dev, cfg)[0]
            nrows, _ = _step_rows(os.path.join(tmp, "run_nccl"))
            print(f"dp nccl: one rank, {len(nrows)} step in {time.time() - t0:.1f} s (start-up "
                  f"included), total {nrows[0]['total']:.4f} [{card}]")
            if nccl["final"] != 1 or len(nrows) != 1 or not math.isfinite(nrows[0]["total"]):
                faults.append("the one-rank NCCL run did not take its step")
        if faults:
            fail("; ".join(faults))
        return {"launches": [c["launches"] for c in cli], "err": max(c["k1"]["err"] for c in cli)}

def regroup_(state, dp) -> None:
    """Point a tensor-parallel train state's column-parallel convs and
    optimizer at ``dp``, a new group of the same grid (the run's group has
    been shut down)."""
    from lip2speech_torch.parallel import tensor

    for m in state.model.modules():
        if isinstance(m, tensor.ColumnParallel) and m.tp is not None:
            m.tp = dp
    state.opt.tp = dp


def tp_part_norms(st, g, grid) -> list[float]:
    """The encoder's and the decoder's gradient norms of the flat gradient
    ``g`` (summed over the data group), the shards' squares summed over the
    model group."""
    import torch
    import torch.distributed as dist

    enc = torch.cat([torch.full((p.numel(),), n.startswith("encoder."), device=g.device)
                     for n, p in zip(st.opt.names, st.opt.params)])
    shard = st.opt.shard_mask
    sq = g.double() ** 2
    out = []
    for part in (enc, ~enc):
        if shard is None:
            out.append(float(torch.sqrt(sq[part].sum())))
            continue
        sums = torch.stack([sq[part & ~shard].sum(), sq[part & shard].sum()])
        dist.all_reduce(sums[1:], group=grid.model_group)
        out.append(float(torch.sqrt(sums.sum())))
    return out


def tp_step_check(cfg, dev, card: str) -> dict:
    """Phase 12 (a), on a 1 x 2 grid: the first f32 step against one rank on
    the whole batch, the same draws, then in f64; the bf16 step's ms and
    peak memory on the grid and on one rank on a staged batch; the sharded
    convs' collectives alone."""
    import torch
    import torch.distributed as dist

    from lip2speech_torch.models.lip2speech import Lip2Speech, init_random_
    from lip2speech_torch.parallel import dist as pdist
    from lip2speech_torch.parallel import tensor
    from lip2speech_torch.train.train_step import (apply_update, batch_norm_stats,
                                                   create_train_state, loss_and_grad,
                                                   step_draws, train_step)

    cfg32 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, bf16=False))

    def make(grid, c=cfg32, dtype=torch.float32):
        model = init_random_(Lip2Speech(cfg.model), torch.Generator().manual_seed(SEED))
        model.to(dev, dtype)
        tensor.shard_(model, grid)
        return create_train_state(c, model)

    def step_with_norms(st, b, grid):
        gen = step_draws(SEED, st.step, dev, grid, b["mel"].shape[0])
        losses, stats, grads = loss_and_grad(st, b, TRAIN_TF, cfg32, None, gen, grid)
        norms = tp_part_norms(st, pdist.all_reduce_(st.opt.flatten(grads, dtype=None), grid), grid)
        return apply_update(st, cfg32, losses, stats, grads, grid), norms

    def params(st):
        full = dict(tensor.full_named_parameters(st.model))
        return {n: full[n].detach().clone() for n in st.opt.names}

    next_group_port()
    dp = pdist.init_from_env(str(dev), "gloo", n_model=TP_CHECK_GRID[1])
    try:
        out = {"grid": [dp.n_data, dp.n_model]}
        batch = make_train_batch(cfg, DP_CHECK_B, SEED + 5, dev)
        batch.pop("audio"), batch.pop("audio_lengths")
        state = make(dp)
        out["sharded"] = len(tensor.layout(state.model)[1])
        before = params(state)
        got, got_norms = step_with_norms(state, batch, dp)
        held, shards = tensor.state_parts(state.model)
        out["same_on_ranks"] = pdist.same_on_all_ranks(held, dp, shards)
        after, mine = params(state), batch_norm_stats(state.model)
        if dp.rank == 0:
            ref = make(None)
            want, want_norms = step_with_norms(ref, batch, None)
            out["losses"] = {k: [float(got[k]), float(want[k])] for k in LOSSES}
            out["grad_norm"] = [float(got["grad_norm"]), float(want["grad_norm"])]
            out["part_norms"] = {part: [g, w] for part, g, w in
                                 zip(("encoder", "decoder"), got_norms, want_norms)}
            out["stats"] = stats_over_tolerance(mine, batch_norm_stats(ref.model))
            out["params"] = param_caps(before, dict(zip(ref.opt.names, ref.opt.params)), after,
                                       cfg.train.learning_rate)
            del ref
        del state, before, after, mine
        # the same step in f64: only the order of the reductions differs
        b64 = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
        metrics, norms = step_with_norms(make(dp, dtype=torch.float64), b64, dp)
        got64 = [float(metrics[k]) for k in LOSSES] + norms
        if dp.rank == 0:
            metrics, norms = step_with_norms(make(None, dtype=torch.float64), b64, None)
            want64 = [float(metrics[k]) for k in LOSSES] + norms
            out["f64"] = max(abs(g - w) / abs(w) for g, w in zip(got64, want64))
        del metrics, b64
        torch.cuda.empty_cache()

        # the bf16 step on a staged batch: the grid, then one rank alone
        batch = make_train_batch(cfg, TRAIN_B, SEED + 6, dev)
        batch.pop("audio"), batch.pop("audio_lengths")
        state = make(dp, c=cfg)
        shapes = {"gather": [], "reduce": []}
        real = (tensor.gather_channels, tensor.copy_to_model)

        def record(kind, fn):
            def wrapped(x, grid):
                shapes[kind].append((tuple(x.shape), x.dtype))
                return fn(x, grid)
            return wrapped

        tensor.gather_channels = record("gather", real[0])
        tensor.copy_to_model = record("reduce", real[1])
        train_step(state, batch, TRAIN_TF, cfg, dp=dp)  # also the timer's warm-up
        tensor.gather_channels, tensor.copy_to_model = real
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out["grid_ms"] = median_ms(lambda: train_step(state, batch, TRAIN_TF, cfg, dp=dp), dev)
        out["grid_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        # the collectives alone, at the shapes the step gave them
        gathers = [torch.zeros(s, dtype=t, device=dev) for s, t in shapes["gather"]]
        reduces = [torch.zeros(s, dtype=t, device=dev) for s, t in shapes["reduce"]]
        out["n_gather"], out["n_reduce"] = len(gathers), len(reduces)
        out["gather_mib"] = sum(x.numel() * x.element_size() for x in gathers) * dp.n_model / 2**20
        out["reduce_mib"] = sum(x.numel() * x.element_size() for x in reduces) / 2**20

        def gather_round():
            for x in gathers:
                tensor.gather(x, dp, 1)

        def reduce_round():
            for x in reduces:
                dist.all_reduce(x, group=dp.model_group)

        out["gather_ms"] = median_ms(gather_round, dev)
        out["reduce_ms"] = median_ms(reduce_round, dev)
        del state, gathers, reduces
        torch.cuda.empty_cache()
        pdist.barrier(dp)
        if dp.rank == 0:
            alone = make(None, c=cfg)
            torch.cuda.reset_peak_memory_stats(dev)
            out["one_ms"] = median_ms(lambda: train_step(alone, batch, TRAIN_TF, cfg), dev)
            out["one_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
            sharded = sum(p.numel() for n, p in alone.model.named_parameters()
                          if n in tensor.partition_params(
                              {n: tuple(p.shape) for n, p in alone.model.named_parameters()},
                              dp.n_model))
            out["sharded_params"] = sharded
            del alone
        pdist.barrier(dp)
        return out
    finally:
        pdist.shutdown(dp)


def tp_cli(cfg, tmp: str, dev, card: str) -> dict:
    """Phase 12 (b): this rank of ``cli.train`` on a 2 x 2 grid over gloo
    (steps, an eval tick through K1); then, in a new group of the same grid,
    a digest of the gathered state, K1 against its plain version on this
    rank's data index's rows of the first eval batch (the ranks encode
    together, then take the card in turn), and the bf16 step's ms on a
    staged batch."""
    import torch

    from lip2speech_torch.cli import train as train_cli
    from lip2speech_torch.data import get_dataset
    from lip2speech_torch.kernels import ar_decode as ar
    from lip2speech_torch.parallel import dist as pdist
    from lip2speech_torch.parallel import tensor
    from lip2speech_torch.train.train_step import train_step

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    n_data, n_model = TP_CLI_GRID
    root = os.path.join(tmp, "lrw")
    extra = ("--dist_backend", "gloo", "--data_parallel", str(n_data), "--model_parallel",
             str(n_model))
    # the main path: the kernel's launches count from here
    next_group_port()
    ar.launches = 0
    first = train_cli.train(_cli_args(root, tmp, "tp", dev, "--max_iters", str(TP_STEPS),
                                      "--eval_interval", str(TP_STEPS), *extra), cfg)
    if str(dev) != "cpu":
        torch.cuda.synchronize(dev)
    launches = ar.launches
    d = rank // n_model
    per = min(32, TRAIN_B) // n_data
    ds = get_dataset("LRW", root, mode="test", cfg=cfg.data)
    _, rows = eval_rows(cfg, ds, range(d * per, (d + 1) * per), dev)
    state = first["state"]
    next_group_port()
    dp = pdist.init_from_env(str(dev), "gloo", n_model=n_model)
    try:
        regroup_(state, dp)
        digest = state_hash(tensor.full_state_dict(state.model))
        p, enc, bos = encode_rows(state.model, rows, dev)
        for turn in range(world):
            if turn == rank:
                k1 = ar_decode_check(cfg, p, enc, bos, rows["mel"].shape[-1], dev,
                                     f"rank {rank}'s eval rows (data index {d})", card)
            pdist.barrier(dp)
        del p, enc, bos
        batch = make_train_batch(cfg, TRAIN_B, SEED + 6, dev)
        batch.pop("audio"), batch.pop("audio_lengths")
        local = {k: pdist.local_rows(v, dp.data_index, dp.n_data) for k, v in batch.items()}
        grid_ms = median_ms(lambda: train_step(state, local, TRAIN_TF, cfg, dp=dp), dev)
    finally:
        pdist.shutdown(dp)
    return {"launches": launches, "k1": k1, "best": first["best_score"],
            "final": first["final_step"], "hash": digest, "ms": grid_ms}


def align_check(dev, card: str) -> None:
    """``ops.image.align_face_batched`` on the card against the CPU: 32 seeded
    160x160 face crops, landmarks with eye lines tilted both ways."""
    import numpy as np
    import torch

    from lip2speech_torch.ops.image import align_face_batched

    rng = np.random.RandomState(SEED)
    n, size = 32, 160
    crops = torch.from_numpy(rng.randint(0, 256, (n, size, size, 3)).astype(np.float32))
    lm = rng.uniform(40, 120, (n, 68, 2))
    tilt = np.linspace(-0.5, 0.5, n)
    lm[:, 36:42] = np.array([55.0, 70.0]) + rng.uniform(-4, 4, (n, 6, 2))
    lm[:, 42:48] = (np.stack([55 + 50 * np.cos(tilt), 70 + 50 * np.sin(tilt)], -1)[:, None]
                    + rng.uniform(-4, 4, (n, 6, 2)))
    lm = torch.from_numpy(np.round(lm).astype(np.int32))
    want = align_face_batched(crops, lm)
    got = align_face_batched(crops.to(dev), lm.to(dev))
    ms = median_ms(lambda: align_face_batched(crops.to(dev), lm.to(dev)), dev)
    err = (got.cpu() - want).abs()
    # bilinear sampling is continuous, so a sampling position rounded to the
    # other side of a pixel moves the value by rounding; only a position on
    # the image's edge (inside on one side, outside on the other) moves it more
    off = int((err > ALIGN_TOL).sum())
    print(f"align_face_batched on {n} crops of {size}x{size}: max |card - CPU| "
          f"{float(err.max()):.3e}, {off} of {err.numel()} values over {ALIGN_TOL} "
          f"(at most {ALIGN_EDGE_VALUES}); {ms:.3f} ms a batch with the copies [{card}]")
    if off > ALIGN_EDGE_VALUES or not bool(torch.isfinite(got).all()):
        fail("align_face_batched on the card disagrees with the CPU")


def phase_tp(cfg, card: str, dev) -> dict:
    """Tensor parallelism on the card (see the module docstring); returns the
    AR kernel's numbers on the ranks' eval ticks for the kernels line."""
    import numpy as np

    from lip2speech_torch.cli import train as train_cli

    if str(dev) != "cpu":
        import torch

        torch.cuda.empty_cache()
        align_check(dev, card)
    with tempfile.TemporaryDirectory(prefix="lip2speech_tp_") as tmp:
        t0 = time.time()
        write_fixture(os.path.join(tmp, "lrw"))
        print(f"tp: fixture in {time.time() - t0:.1f} s")
        faults = []  # every result prints before the phase fails

        # (a) the 1 x 2 grid against one rank
        t0 = time.time()
        ranks = run_ranks(TP_CHECK_GRID[0] * TP_CHECK_GRID[1], "tp_step", tmp, dev, cfg)
        print(f"tp: (a) on a {TP_CHECK_GRID[0]} x {TP_CHECK_GRID[1]} grid over gloo on one card "
              f"in {time.time() - t0:.1f} s (process start-up included)")
        st = ranks[0]["tp_step"]
        loss_rel = max(abs(g - w) / (DP_LOSS_RTOL * abs(w) + DP_LOSS_ATOL)
                       for g, w in st["losses"].values())
        norm_rel = {k: abs(g - w) / w for k, (g, w) in
                    [("total", st["grad_norm"]), *st["part_norms"].items()]}
        lr = cfg.train.learning_rate
        caps = {"encoder": 50, "decoder": 2000}
        print(f"tp step f32 B={DP_CHECK_B} on a 1 x 2 grid ({st['sharded']} kernels sharded) "
              f"against one rank: total {st['losses']['total'][0]:.6f} / "
              f"{st['losses']['total'][1]:.6f}, the losses at {loss_rel:.3f} of their tolerance; "
              f"gradient norms rel " + ", ".join(f"{k} {v:.3e}" for k, v in norm_rel.items())
              + f" (tol {DP_NORM_RTOL} each); statistics at {st['stats']:.3f} of their "
              "tolerance; " + "; ".join(
                  f"{part}: worst {p['worst']:.3e} (cap {2.5 * lr:.1e}), {p['bad']} of "
                  f"{p['total']} entries over lr/20 (cap {max(10, p['total'] // caps[part])}), "
                  f"sign {p['sign']:.5f}, L2 {p['l2']:.3e}" for part, p in st["params"].items())
              + f"; the same step in f64: losses and gradient norms rel {st['f64']:.3e} "
              f"(tol {TRAIN_F64_REL}); replicated tensors the same on both ranks: "
              f"{all(r['tp_step']['same_on_ranks'] for r in ranks)} [{card}]")
        if not all(r["tp_step"]["same_on_ranks"] for r in ranks) or st["sharded"] != 11:
            faults.append("the grid's ranks hold different replicated tensors, or not 11 shards")
        if loss_rel > 1.0 or st["stats"] > 1.0 or max(norm_rel.values()) > DP_NORM_RTOL or (
                st["f64"] > TRAIN_F64_REL) or any(
                p["worst"] > 2.5 * lr or p["bad"] > max(10, p["total"] // caps[part])
                for part, p in st["params"].items()):
            faults.append("the 1 x 2 grid's step disagrees with the one-rank step")
        away = st["sharded_params"] // 2
        print(f"tp step bf16 B={TRAIN_B} on a staged batch: one rank {st['one_ms']:.2f} ms, peak "
              f"{st['one_peak_gib']:.3f} GiB; 1 x 2 grid (each rank all {TRAIN_B} rows) "
              f"{ranks[0]['tp_step']['grid_ms']:.2f} / {ranks[1]['tp_step']['grid_ms']:.2f} ms, "
              f"peak {st['grid_peak_gib']:.3f} / {ranks[1]['tp_step']['grid_peak_gib']:.3f} GiB "
              f"a rank (reckoned: {away} parameters sharded away x 22 B = {away * 22 / 2**20:.1f} "
              f"MiB less: f32 weight, gradient and three moments, and the bf16 copy); a forward's "
              f"{st['n_gather']} all-gathers ({st['gather_mib']:.1f} MiB gathered) "
              f"{st['gather_ms']:.2f} ms, a backward's {st['n_reduce']} model-group all-reduces "
              f"({st['reduce_mib']:.1f} MiB) {st['reduce_ms']:.2f} ms [{card}]")

        # (b) cli.train on a 2 x 2 grid, then one rank resumes from its checkpoint
        t0 = time.time()
        world = TP_CLI_GRID[0] * TP_CLI_GRID[1]
        cli = [r["tp_cli"] for r in run_ranks(world, "tp_cli", tmp, dev, cfg)]
        rows, evals = _step_rows(os.path.join(tmp, "run_tp"))
        steps = [r["step"] for r in rows]
        eval_batches = min(CLI_EVAL_BATCHES, -(-CLI_TEST_CLIPS // min(32, TRAIN_B)))
        print(f"tp: (b) {world} ranks in {time.time() - t0:.1f} s (process start-up included)")
        print(f"tp cli B={TRAIN_B} on a {TP_CLI_GRID[0]} x {TP_CLI_GRID[1]} grid "
              f"({TRAIN_B // TP_CLI_GRID[0]} rows a rank): steps logged {steps}, "
              f"{float(np.median([r['step_time'] * 1e3 for r in rows[1:]])):.2f} ms per step with "
              f"the loader (median of steps 2-{TP_STEPS}), eval ESTOI {cli[0]['best']:.4f}; "
              f"ar_decode launches by rank {[c['launches'] for c in cli]} for {eval_batches} eval "
              f"batches; the bf16 step on a staged batch {[round(c['ms'], 2) for c in cli]} ms by "
              f"rank [{card}]")
        for r, c in enumerate(cli):
            print(f"tp rank {r}: ar_decode on its eval rows: max|err| {c['k1']['err']:.3e}, kernel "
                  f"{c['k1']['ms']:.3f} ms, plain {c['k1']['plain_ms']:.3f} ms, bound "
                  f"{c['k1']['bound_ms']:.4f} ms [{card}]")
        t0 = time.time()
        one = train_cli.train(_cli_args(os.path.join(tmp, "lrw"), tmp, "tp", dev, "--max_iters",
                                        str(TP_STEPS), "--eval_interval", "1000"), cfg)
        same = state_hash(one["state"].model) == cli[0]["hash"]
        print(f"tp resume on one rank from the grid's checkpoint at step {one['start_step']} in "
              f"{time.time() - t0:.1f} s: the grid's gathered state bit for bit: {same} [{card}]")
        if steps != list(range(1, TP_STEPS + 1)) or len(evals) != 1:
            faults.append(f"the grid's metrics.jsonl holds steps {steps} and {len(evals)} eval "
                          "records: not rank 0's alone")
        if not all(math.isfinite(r["total"]) for r in rows):
            faults.append("the grid's CLI logged a non-finite loss")
        if any(c["launches"] != eval_batches for c in cli):
            faults.append("a grid rank's eval tick did not launch the AR kernel once per batch")
        if len({c["hash"] for c in cli}) != 1 or any(c["final"] != TP_STEPS for c in cli):
            faults.append("the grid's ranks end with different gathered states (digests "
                          f"{[c['hash'][:12] for c in cli]}, steps {[c['final'] for c in cli]})")
        if not same or one["start_step"] != TP_STEPS:
            faults.append("one rank did not resume the grid's checkpoint bit for bit")
        if faults:
            fail("; ".join(faults))
        return {"launches": [c["launches"] for c in cli],
                "err": max(c["k1"]["err"] for c in cli)}


def phase_surface(cfg, card: str, dev) -> dict:
    """Phase 13, the port's last public surface on the card (see the module
    docstring); returns the AR kernel's launches and its error on the
    network's request for the kernels line."""
    import argparse

    import torch

    from lip2speech_torch import default_config
    from lip2speech_torch.cli import common as cli_common
    from lip2speech_torch.kernels import ar_decode as ar
    from lip2speech_torch.models import Lip2Speech, get_network
    from lip2speech_torch.models.lip2speech import init_random_
    from lip2speech_torch.ops import image
    from lip2speech_torch.ops import stft as stft_ops

    # (a) get_network against Lip2Speech, one B=MAIN_B bf16 request each
    bf16 = torch.bfloat16
    nets = [init_random_(build(cfg.model), torch.Generator().manual_seed(SEED)).to(dev, bf16)
            for build in (get_network, Lip2Speech)]
    gen = torch.Generator().manual_seed(SEED + 13)
    video, faces = make_request(cfg, MAIN_B, gen, "cpu", bf16)
    S = max(1, cfg.data.max_video_frames // 7)
    u = torch.rand(MAIN_B * S, cfg.model.content_vocab_size, generator=gen)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-30)))
    video, faces, gumbel = video.to(dev), faces.to(dev), gumbel.to(dev)
    ar.launches = 0
    outs = [net(video, faces, gumbel=gumbel, generator=torch.Generator(device=dev).manual_seed(SEED))
            for net in nets]
    torch.cuda.synchronize(dev)
    launches = ar.launches
    same = all(torch.equal(outs[0][k], outs[1][k]) for k in ("mel", "mel_postnet", "gate", "lengths"))
    mel = outs[0]["mel_postnet"]
    print(f"surface: get_network(cfg) B={MAIN_B} bf16 on {mel.device}: mel_postnet "
          f"{tuple(mel.shape)}, lengths {outs[0]['lengths'].tolist()}, ar_decode launches "
          f"{launches} (one a network), bit-equal to Lip2Speech(cfg): {same}")
    if mel.device.type != dev.type or not bool(torch.isfinite(mel.float()).all()):
        fail("get_network's request did not run on the card or is not finite")
    if launches != len(nets) or not same:
        fail(f"get_network: {launches} kernel launches, bit-equal to Lip2Speech {same}")
    p, enc, bos = encode_rows(nets[0], {"video": video, "faces": faces}, dev)
    k1 = ar_decode_check(cfg, p, enc, bos, cfg.model.max_decoder_steps, dev,
                         "get_network's request", card, bf16)

    # (b) istft(stft(x)) on the card against the CPU and against x
    n_fft, hop = cfg.audio.n_fft, cfg.audio.hop_length
    x = torch.randn(SURFACE_CLIPS, SURFACE_SAMPLES, generator=gen)

    def round_trip(x):
        spec = stft_ops.stft(x, n_fft, hop)
        return stft_ops.istft(spec, n_fft, hop, length=x.shape[-1])

    want = round_trip(x)
    xd = x.to(dev)
    got = round_trip(xd)
    rel = float((got.cpu() - want).abs().max() / want.abs().max())
    back = float((got.cpu() - x).abs().max())
    ms = cuda_ms(lambda: round_trip(xd), reps=5)
    print(f"surface: istft(stft(x)) {SURFACE_CLIPS}x{SURFACE_SAMPLES} samples, n_fft {n_fft}, "
          f"hop {hop} on {got.device}: card vs CPU {rel:.3e} of the largest (tol {STFT_REL}), "
          f"max|y - x| {back:.3e} (tol {ROUND_TRIP_TOL}); {ms:.3f} ms [{card}]")
    if got.device.type != dev.type or rel > STFT_REL or back > ROUND_TRIP_TOL:
        fail("istft(stft(x)) on the card disagrees with the CPU or with x")

    # (c) resize_bilinear of a video batch, card against CPU, f32 and bf16
    T, (h, w) = cfg.data.max_video_frames, cfg.data.mouth_size
    clips = torch.rand(RESIZE_B, T, h, w, 3, generator=gen)
    for dt in (torch.float32, bf16):
        name = str(dt).split(".")[-1]
        host, vd = clips.to(dt), clips.to(dev, dt)
        if not torch.equal(image.resize_bilinear(vd, h, w), vd):
            fail(f"resize_bilinear to the same size changed the {name} video")
        for size in RESIZE_SIZES:
            got = image.resize_bilinear(vd, size, size)
            want = image.resize_bilinear(host, size, size)
            err = float((got.cpu().float() - want.float()).abs().max())
            ms = cuda_ms(lambda: image.resize_bilinear(vd, size, size), reps=5)
            print(f"surface: resize_bilinear ({RESIZE_B}, {T}, {h}, {w}, 3) -> {size}x{size} "
                  f"{name} on {got.device}: max|card - CPU| {err:.3e} (tol {RESIZE_TOL[name]}); "
                  f"{ms:.3f} ms [{card}]")
            if got.device.type != dev.type or got.dtype != dt or err > RESIZE_TOL[name]:
                fail(f"resize_bilinear {name} to {size} on the card disagrees with the CPU")

    # (d) the CLIs' config with --override mesh.*
    args = cli_common.add_common_args(argparse.ArgumentParser()).parse_args(
        ["--root", ROOT, "--override", "mesh.model_parallel=1"])
    got_cfg = cli_common.common_config(args)
    print(f"surface: cli.common.common_config --override mesh.model_parallel=1 -> {got_cfg.mesh}")
    if got_cfg.mesh.model_parallel != 1 or got_cfg != default_config():
        fail("--override mesh.model_parallel=1 did not give the default config")
    return {"launches": launches, "err": k1["err"]}


def main() -> int:
    if sys.argv[1:2] == ["--dp-rank"]:
        return dp_rank(*sys.argv[2:5])
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
    if "--dp-only" in sys.argv[1:]:
        phase_dp(cfg, card, dev)
        print(card)
        return 0
    if "--tp-only" in sys.argv[1:]:
        phase_tp(cfg, card, dev)
        print(card)
        return 0
    if "--api-only" in sys.argv[1:]:
        phase_surface(cfg, card, dev)
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
    at_dp = phase_dp(cfg, card, dev)
    at_tp = phase_tp(cfg, card, dev)
    at_surface = phase_surface(cfg, card, dev)

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
        # data parallelism (phase 11): launches in each rank's eval tick of
        # the two-rank CLI run on the one card; the largest error of the
        # kernel against its plain version on a rank's eval rows (B=16, f32)
        "dp_eval_launches": at_dp["launches"],
        "dp_eval_max_abs_err": at_dp["err"],
        # tensor parallelism (phase 12): launches in each rank's eval tick of
        # the 2 x 2 grid's CLI run; the largest error of the kernel against
        # its plain version on a rank's eval rows (B=16, f32)
        "tp_eval_launches": at_tp["launches"],
        "tp_eval_max_abs_err": at_tp["err"],
        # the public surface (phase 13): launches of get_network's and
        # Lip2Speech's B=4 bf16 requests; the kernel against its plain
        # version on that request (bf16, M=300)
        "surface_launches": at_surface["launches"],
        "surface_max_abs_err": at_surface["err"],
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
