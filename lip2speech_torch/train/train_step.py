"""The train step (PyTorch).

Counterpart of ``lip2speech_tpu/train/train_step.py:30-56, 179-336``: the
teacher-forced forward in train mode -> the loss dict -> gradients -> the
guarded AMSGrad update (``train/optim.py``) -> the new BatchNorm running
statistics, kept only when the step is taken (``guard_batch_stats``).

bf16 policy (``cast_floats``): the master weights and the BatchNorm
statistics stay f32; the forward runs on bf16 copies of them and of the
batch (``torch.func.functional_call``), so the gradients land in f32 on the
masters; the outputs and the new statistics are cast back to f32, and the
loss is taken in f32 against the f32 targets.

The stages are the spans (``utils/trace.py``) ``train.forward``,
``train.loss``, ``train.backward``, ``train.optimizer`` (with
``train.grad_all_reduce``) and ``train.batch_stats``.

Random draws. The JAX step derives its keys from ``fold_in(rng, step)``;
here a step without explicit ``draws`` draws them from a generator seeded
by ``(seed, step)``, so a resumed run draws what the uninterrupted run
would have drawn. The JAX and torch streams never agree: a parity test
hands both sides the same draws.

Data parallelism (``dp``, ``parallel/dist.py``): each rank runs the step
on its data index's rows of the global batch. The per-row draws are made
at the global shape from the step's generator and cut to those rows
(``parallel.RowDraws``); the BatchNorm moments and the clipped cotangents'
norms cover the global batch (``layers.data_parallel``); the losses are
the rank's shares, logged as their sum; and the flat gradient vector is
summed over the data group, in the gradients' own type, before the
optimizer reads it, so the guard, the norm and the update are the same on
every rank.

Tensor parallelism (``parallel/tensor.py``): a model whose banks and
``conv_last`` were sharded by ``tensor.shard_`` before
``create_train_state`` runs them column-parallel over its model group. The
ranks of a model group hold the same rows, so after the data group's sum a
shard's gradient is complete and a replicated gradient is the same on every
rank of the group up to the order of summation, and the model group's
first rank's replicated gradients and new statistics are kept on all of
them; the optimizer's norm sums the shards over the model group
(``train/optim.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import functional_call

from lip2speech_torch.config import Config
from lip2speech_torch.models.layers import FlaxRuleBatchNorm, data_parallel
from lip2speech_torch.models.lip2speech import Lip2Speech
from lip2speech_torch.parallel import tensor
from lip2speech_torch.parallel.dist import (DataParallel, RowDraws, agree_over_model_group_,
                                            all_reduce_)
from lip2speech_torch.train.losses import global_losses, lip2speech_loss
from lip2speech_torch.train.optim import AMSGrad, all_finite, fold_lstm_biases_, is_trainable
from lip2speech_torch.utils import trace


def cast_floats(tree: dict, dtype) -> dict:
    """f32 tensors of ``tree`` cast to ``dtype``; other entries as they are."""
    return {k: v.to(dtype) if torch.is_tensor(v) and v.dtype == torch.float32 else v
            for k, v in tree.items()}


def uncast_floats(tree: dict) -> dict:
    """bf16 tensors of ``tree`` cast back to f32."""
    return {k: v.float() if torch.is_tensor(v) and v.dtype == torch.bfloat16 else v
            for k, v in tree.items()}


@dataclasses.dataclass
class TrainState:
    """The model (f32 master weights and BatchNorm statistics), the
    optimizer and the number of steps taken."""

    model: Lip2Speech
    opt: AMSGrad
    step: int = 0


def create_train_state(cfg: Config, model: Lip2Speech) -> TrainState:
    """The state of a run starting from ``model``, whose LSTM biases are
    folded into ``bias_ih`` (``optim.fold_lstm_biases_``); the optimizer
    keeps the shards of a model that ``tensor.shard_`` sharded."""
    fold_lstm_biases_(model)
    return TrainState(model=model,
                      opt=AMSGrad(cfg.train, model.named_parameters(), tensor.layout(model)))


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator seeded by (seed, step), as ``fold_in(rng, step)``."""
    mixed = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(mixed & (2**63 - 1))


def batch_norms(model: torch.nn.Module) -> dict[str, FlaxRuleBatchNorm]:
    """Every trainable BatchNorm of ``model``, by module name."""
    return {n: m for n, m in model.named_modules() if isinstance(m, FlaxRuleBatchNorm)}


def batch_norm_stats(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The running statistics of every trainable BatchNorm, by buffer name."""
    out = {}
    for name, m in batch_norms(model).items():
        out[f"{name}.running_mean"], out[f"{name}.running_var"] = m.running_mean, m.running_var
    return out


def forward_losses(state: TrainState, batch: dict, tf_ratio, cfg: Config,
                   draws: dict | None = None, generator=None, dp: DataParallel | None = None):
    """The train-mode forward and the loss dict, with their graph.
    ``batch`` holds video (B,T,H,W,3), faces (B,2,160,160,3) or
    speaker_embedding (B,256), mel (B,80,M), gate (B,M) and mel_mask (B,M).
    Returns (the outputs in f32, the losses, the new BatchNorm statistics by
    buffer name); terms added to ``losses["total"]`` before ``backward``
    join the gradients. Under ``dp`` the batch is this rank's rows, the
    statistics are the global batch's and the losses this rank's shares."""
    model = state.model
    bf16 = cfg.train.bf16
    was_training = model.training
    model.train()
    norms = batch_norms(model)
    for m in norms.values():
        m.new_stats = None
    named = dict(model.named_parameters())
    weights = {n: p if is_trainable(n) else p.detach() for n, p in named.items()}
    weights.update(dict(model.named_buffers()))
    fwd_batch = batch
    if bf16:
        weights = cast_floats(weights, torch.bfloat16)
        fwd_batch = cast_floats(batch, torch.bfloat16)
    try:
        with trace.span("train.forward"), data_parallel(model, dp):
            outputs = functional_call(
                model, weights, (fwd_batch["video"], fwd_batch.get("faces")),
                dict(speaker_embedding=fwd_batch.get("speaker_embedding"), generator=generator,
                     mels=fwd_batch["mel"], tf_ratio=tf_ratio, draws=draws))
        new_stats = {}
        for name, m in norms.items():
            if m.new_stats is not None:
                new_stats[f"{name}.running_mean"], new_stats[f"{name}.running_var"] = m.new_stats
                m.new_stats = None
    finally:
        model.train(was_training)
    outputs = uncast_floats(outputs) if bf16 else outputs
    with trace.span("train.loss"):
        losses = lip2speech_loss(
            outputs, batch["mel"], batch["gate"], postnet_weight=cfg.train.postnet_loss_weight,
            mel_mask=batch.get("mel_mask") if cfg.train.masked_loss else None,
            kld_weight=cfg.train.kld_weight, dp=dp)
    return outputs, losses, new_stats


def backward(state: TrainState, losses: dict, dp: DataParallel | None = None) -> tuple[dict, tuple]:
    """(the losses detached, the gradients of ``losses["total"]`` with
    respect to the trainable parameters, in ``state.opt.names`` order).
    Under ``dp`` the gradients are this rank's share and the losses the
    global batch's (``losses.global_losses``)."""
    with trace.span("train.backward"):
        grads = torch.autograd.grad(losses["total"], state.opt.params, allow_unused=True)
    return global_losses(losses, dp), grads


def loss_and_grad(state: TrainState, batch: dict, tf_ratio, cfg: Config,
                  draws: dict | None = None, generator=None, dp: DataParallel | None = None):
    """Forward (train mode) + loss dict + gradients, as the train step
    computes them (``forward_losses``, then ``backward``). Returns (losses,
    new BatchNorm statistics by buffer name, the trainable gradients in
    ``state.opt.names`` order; under ``dp`` this rank's share, which sum
    over the ranks to the global batch's)."""
    _, losses, new_stats = forward_losses(state, batch, tf_ratio, cfg, draws, generator, dp)
    losses, grads = backward(state, losses, dp)
    return losses, new_stats, grads


def step_draws(seed: int, step: int, device, dp: DataParallel | None, local_batch: int):
    """The step's generator, ``step_generator(seed, step)``; under ``dp`` a
    ``RowDraws`` over it for this data index's rows of the global batch."""
    gen = step_generator(seed, step, device)
    return gen if dp is None else RowDraws.for_rank(gen, dp, local_batch)


def guard_batch_stats(cfg: Config, grads_ok: torch.Tensor, new_stats: dict,
                      old_stats: dict) -> dict:
    """The statistics to keep: the new ones when the step is taken and they
    are finite, else the old ones (``train_step.py:272-294``). ``grads_ok``
    is the optimizer's verdict on the gradients."""
    t = cfg.train
    if not (t.skip_nonfinite_updates or t.reject_grad_norm_above > 0.0):
        return new_stats
    ok = grads_ok & all_finite(new_stats.values())
    return {k: torch.where(ok, v, old_stats[k]) for k, v in new_stats.items()}


def apply_update(state: TrainState, cfg: Config, losses: dict, new_stats: dict,
                 grads, dp: DataParallel | None = None) -> dict[str, torch.Tensor]:
    """The guarded update from ``grads``, the new statistics kept only when
    it is taken, and one more step. Under ``dp`` the flat gradient vector is
    summed over the data group first. Returns the metrics: ``losses``,
    ``grad_norm`` and, when updates are guarded, ``notfinite_count``."""
    with trace.span("train.optimizer"):
        # summed over the data group in the gradients' own type (f32 under the bf16 policy)
        with trace.span("train.grad_all_reduce"):
            g = all_reduce_(state.opt.flatten(grads, dtype=None), dp).float()
        info = state.opt.step(g)
    stats = batch_norm_stats(state.model)
    with torch.no_grad(), trace.span("train.batch_stats"):
        kept = guard_batch_stats(cfg, info["ok"], new_stats, stats)
        agree_over_model_group_(kept.values(), dp)
        for name, value in kept.items():
            stats[name].copy_(value)
    state.step += 1
    metrics = dict(losses)
    metrics["grad_norm"] = info["grad_norm"]
    if "notfinite_count" in info:
        metrics["notfinite_count"] = info["notfinite_count"]
    return metrics


def train_step(state: TrainState, batch: dict, tf_ratio, cfg: Config,
               draws: dict | None = None, seed: int | None = None,
               dp: DataParallel | None = None) -> dict[str, torch.Tensor]:
    """One optimisation step, in place on ``state``. Draws absent from
    ``draws`` come from ``step_generator(seed, state.step)``, ``seed``
    defaulting to ``cfg.train.seed``; under ``dp`` ``batch`` (and each
    given draw) is this rank's rows of the global batch.
    Returns the metrics as 0-d tensors on the device: the losses,
    ``grad_norm`` (global norm of the raw gradients) and, when updates are
    guarded, ``notfinite_count``, the global batch's under ``dp``. Nothing
    waits for the device (but a collective of the gloo backend does)."""
    seed = cfg.train.seed if seed is None else seed
    mel = batch["mel"]
    gen = step_draws(seed, state.step, mel.device, dp, mel.shape[0])
    losses, new_stats, grads = loss_and_grad(state, batch, tf_ratio, cfg, draws, gen, dp)
    return apply_update(state, cfg, losses, new_stats, grads, dp)
