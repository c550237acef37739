"""Evaluation: batched forward -> Griffin-Lim inversion -> mean ESTOI.

Counterpart of ``lip2speech_tpu/eval/evaluate.py``, on one process or,
under data parallelism, on each rank's shard of the clips. The forward
runs in eval mode with the ground-truth mels and ``tf_ratio=1``, which no
teacher frame passes, so the decoder runs free for the mels' length: ``Decoder.forward`` sends it through ``kernels.ar_decode``, the
CUDA kernel for tensors on the card. The postnet output is inverted (NNLS,
then Griffin-Lim) and scored per clip against the ground-truth waveform,
on the host in float64 (``ops.estoi.estoi``) or, with ``device_estoi``, on
the device (``ops.estoi.estoi_batch``).

Random draws: the content codebook's gumbel noise comes from a generator
seeded by ``seed``, the same for every batch as in the JAX package; each
batch's Griffin-Lim phase from a generator seeded by (seed, batch index),
unless the caller hands the phases in (``thetas``).

Several processes (``dp``, JAX's ``evaluate.py:113-205``): when the batch
divides among the data indices, each rank reads its data index's rows of
every batch (the loader's shard), pads its part of a ragged tail with its
row 0, and scores its real rows; else every rank reads every batch. The
draws of a rank's rows are the rows of the global batch's draws
(``parallel.RowDraws``), and the score is the sum of the data group's
scores over their count, the same on every rank. Under tensor parallelism
the ranks of a model group decode the same rows (the group's first rank's
batch: the readers draw face crops at random), each through the AR kernel,
as GSPMD's replicated compute does, and are counted once.
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch
from torch.func import functional_call

from lip2speech_torch.config import Config
from lip2speech_torch.data.collate import prepare_batch, to_device
from lip2speech_torch.data.loader import Loader
from lip2speech_torch.ops import estoi as estoi_ops
from lip2speech_torch.ops.griffin_lim import mel_to_audio
from lip2speech_torch.parallel.dist import (DataParallel, RowDraws, agree_over_model_group_,
                                            all_reduce_)
from lip2speech_torch.train.train_step import cast_floats, step_generator


class EvalProgram:
    """The eval tick's device work for one (model, cfg, Griffin-Lim
    iterations, metric): made once by :func:`eval_program` and reused by
    every tick."""

    def __init__(self, model: torch.nn.Module, cfg: Config, n_gl_iters: int, metric: str):
        self.model = model
        self.cfg = cfg
        self.n_gl_iters = n_gl_iters
        self.batch_metric = estoi_ops.estoi_batch if metric == "estoi" else estoi_ops.stoi_batch

    def weights(self) -> dict | None:
        """bf16 copies of the model's weights and statistics under
        ``cfg.train.bf16`` (made once a tick: the kernel packs them once),
        else None: the model's own."""
        if not self.cfg.train.bf16:
            return None
        state = dict(self.model.named_parameters())
        state.update(self.model.named_buffers())
        return cast_floats({k: v.detach() for k, v in state.items()}, torch.bfloat16)

    @torch.no_grad()
    def forward(self, batch: dict, weights: dict | None, seed: int,
                rows: tuple[int, int] | None = None) -> dict:
        """The model's eval-mode forward on a prepared batch; the outputs
        as the model gives them, ``mel_postnet`` (B, n_mels, M) among them.
        ``rows`` = (start, total): the batch is rows ``[start, start + B)``
        of a global batch of ``total``, whose draws it takes."""
        model = self.model
        gen = torch.Generator(device=batch["mel"].device).manual_seed(seed)
        if rows is not None:
            gen = RowDraws(gen, rows[0], batch["mel"].shape[0], rows[1])
        inputs = {k: batch[k] for k in ("video", "faces", "mel")}
        if weights is not None:
            inputs = cast_floats(inputs, torch.bfloat16)
        kwargs = dict(mels=inputs["mel"], tf_ratio=1.0, generator=gen)
        was_training = model.training
        model.eval()
        try:
            if weights is None:
                return model(inputs["video"], inputs["faces"], **kwargs)
            return functional_call(model, weights, (inputs["video"], inputs["faces"]), kwargs)
        finally:
            model.train(was_training)

    def invert(self, mel: torch.Tensor, theta: torch.Tensor | None, generator) -> torch.Tensor:
        """(B, n_mels, M) log-mel -> (B, (M - 1) * hop) waveform, f32."""
        return mel_to_audio(mel.float(), self.cfg.audio, n_iter=self.n_gl_iters,
                            generator=generator, theta=theta)

    def score(self, clean: torch.Tensor, wav: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """The batched metric of each row on the device, float64."""
        return self.batch_metric(clean, wav, lengths, fs=self.cfg.audio.sample_rate)


@functools.lru_cache(maxsize=8)
def eval_program(model: torch.nn.Module, cfg: Config, n_gl_iters: int, metric: str) -> EvalProgram:
    return EvalProgram(model, cfg, n_gl_iters, metric)


def _pad_rows(v, reps: int):
    """Append ``reps`` copies of row 0 (numpy array or tensor)."""
    if torch.is_tensor(v):
        return torch.cat([v, v[:1].expand(reps, *v.shape[1:])])
    return np.concatenate([v, np.repeat(v[:1], reps, 0)])


def evaluate_net(model: torch.nn.Module, dataset, cfg: Config, batch_size: int = 32,
                 n_gl_iters: int = 32, max_batches: int | None = None, seed: int = 0,
                 device_estoi: bool = False, metric: str = "estoi", thetas=None,
                 stats: dict | None = None, dp: DataParallel | None = None) -> float:
    """Mean ESTOI (or STOI, or PESQ on the host) of ``model`` over
    ``dataset``, on the model's device. A ragged last batch is padded by
    repeating its row 0 and scored on its real rows. ``thetas[i]`` is
    batch i's initial Griffin-Lim phase (B, n_freqs, M), B the global
    batch. With ``stats``, the device is synchronised after each stage and
    ``stats`` gets ``prepare_s`` (waiting for the loader, the copy to the
    device and ``prepare_batch``), ``forward_s``, ``griffin_lim_s``,
    ``metric_s`` (wall seconds of each batch), ``batches`` and this rank's
    per-clip ``scores``. Under ``dp`` every rank calls it and gets the mean
    over every data index's clips (the module docstring)."""
    assert metric in ("estoi", "stoi", "pesq"), metric
    from lip2speech_torch.eval.metrics import get_waveform_metric

    if metric == "pesq" and device_estoi:
        raise ValueError("pesq has no on-device variant; drop --device_estoi")
    host_fn = get_waveform_metric(metric)
    dev = next(model.parameters()).device
    program = eval_program(model, cfg, n_gl_iters, "stoi" if metric == "stoi" else "estoi")
    weights = program.weights()
    # JAX's rule: shard the loader only when the batch splits evenly
    shard = dp is not None and batch_size % dp.n_data == 0
    loader = Loader(dataset, batch_size, cfg.data, shuffle=False, drop_last=False,
                    num_workers=min(8, os.cpu_count() or 8), pin_memory=dev.type == "cuda",
                    shard_index=dp.data_index if shard else 0,
                    shard_count=dp.n_data if shard else 1)
    local_batch = loader.local_batch_size
    clock = {"prepare_s": [], "forward_s": [], "griffin_lim_s": [], "metric_s": []}
    t = [time.perf_counter()]

    def lap(name):
        if stats is None:
            return
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        clock[name].append(now - t[0])
        t[0] = now

    scores = []
    n_batches = 0
    for bi, raw in enumerate(loader):
        if max_batches is not None and bi >= max_batches:
            break
        n_valid = raw["mouth_u8"].shape[0]
        if n_valid < local_batch:
            raw = {k: _pad_rows(v, local_batch - n_valid) for k, v in raw.items()}
        # where this rank's rows sit in the global batch, for its draws
        start = loader.shard_rows(min(batch_size, len(dataset) - bi * batch_size))[0]
        rows = (start, batch_size) if shard else None
        on_dev = to_device(raw, dev)
        agree_over_model_group_(on_dev.values(), dp)  # the face crops drawn once a model group
        batch = prepare_batch(on_dev, cfg.audio, cfg.data)
        lap("prepare_s")
        mel = program.forward(batch, weights, seed, rows)["mel_postnet"]
        lap("forward_s")
        theta = None if thetas is None else thetas[bi][start: start + local_batch].to(dev)
        gen = step_generator(seed, bi, dev)
        wav = program.invert(mel, theta, gen if rows is None else RowDraws(gen, start, local_batch,
                                                                          batch_size))
        lap("griffin_lim_s")
        if device_estoi:
            scores.extend(program.score(batch["audio"], wav, batch["audio_lengths"])
                          .tolist()[:n_valid])
        else:
            gt = np.asarray(raw["audio"])
            lengths = np.asarray(raw["audio_lengths"])
            wav_np = wav.cpu().numpy()
            for i in range(n_valid):
                n = int(lengths[i])
                scores.append(host_fn(gt[i, :n], wav_np[i, :n], cfg.audio.sample_rate))
        lap("metric_s")
        n_batches += 1
    if stats is not None:
        stats.update(clock, batches=n_batches, scores=list(scores))
    if dp is not None:
        # JAX's process_allgather of (sum, count), summed over the data group
        totals = torch.tensor([float(np.sum(scores)), float(len(scores))], dtype=torch.float64,
                              device=dp.device)
        all_reduce_(totals, dp)
        agree_over_model_group_([totals], dp)  # one score, so one decision, on every rank
        total, count = totals.tolist()
        return total / max(count, 1.0)
    return float(np.mean(scores)) if scores else 0.0
