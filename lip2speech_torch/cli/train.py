"""Training CLI.

Counterpart of ``lip2speech_tpu/cli/train.py``, on one device or one
process a device (data and tensor parallelism, below): the dataset, the AMSGrad train
step (``train/train_step.py``), resume from the newest checkpoint, the
teacher-forcing anneal (+``tf_ratio_step`` every ``tf_ratio_epochs``
epochs), the eval tick (``eval/evaluate.py``, whose
decode runs through the AR kernel on the card) with a save when the score
improves, JSONL / console / TensorBoard logging, and the rewind on a stall.

With ``--override train.adversarial=true`` each step is the combined
generator + WGAN critic step (``train/adversarial.py``). The critic starts
from a generator seeded by ``train.seed + 17``, at the start of every run,
a resumed one too: it is not checkpointed. The rewind on a stall is
refused with it, since the safety checkpoints would hold no critic.

Parallelism (``parallel/dist.py``): one process per device, launched by
``torch.distributed.run``, whose environment starts the group
(``--multihost`` requires it). The processes form a grid of
``--data_parallel`` x ``--model_parallel`` ranks, whose size must be the
world size (``--data_parallel -1``: the world over ``--model_parallel``).
``--batch_size`` is the global batch; each rank reads its data index's rows
(the loader's shard), runs the step on them and sums the gradients over
its data group. With ``--model_parallel`` above 1 (tensor parallelism,
``parallel/tensor.py``) the K/V conv banks and ``conv_last`` are sharded on
their output channels over each model group, whose ranks hold the same
rows (the group's first rank's batch, broadcast: each loader draws face
crops and flips on its own); the critic of the adversarial mode stays
replicated. Every rank of a model group holds the same replicated weights,
checked at the end of a run, and a checkpoint holds the gathered ones in
the one-rank format. ``--dist_backend`` picks the
collectives: NCCL on CUDA and gloo on the CPU by default; gloo on CUDA lets
several ranks share one card. Only rank 0 writes checkpoints, logs and the
console.

The loop reads metrics from the device only at log ticks, and, when
rewinding is on, the previous step's ``notfinite_count`` each step. A
``trace.recording()`` stays open over the loop: each log tick also writes
a row of ``host/<span>`` scalars, each span's host self ms a step over the
steps since the previous log or eval tick (``utils/trace.py``), and
``host/spans_dropped``, the spans the recording's bound left out.

Usage: python -m lip2speech_torch.cli.train --dataset LRW --root ... [--device cuda]
       python -m torch.distributed.run --nproc_per_node 2 -m lip2speech_torch.cli.train \
           --dataset LRW --root ... [--device cpu --dist_backend gloo]
       python -m torch.distributed.run --nproc_per_node 4 -m lip2speech_torch.cli.train \
           --dataset LRW --root ... --data_parallel 2 --model_parallel 2
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time

import numpy as np
import torch

from lip2speech_torch.cli.common import (add_common_args, add_dist_args, common_config,
                                         load_model, start_data_parallel)
from lip2speech_torch.config import Config, TrainConfig
from lip2speech_torch.data import FaceAugmentation, Loader, get_dataset
from lip2speech_torch.data.collate import prepare_batch, to_device
from lip2speech_torch.eval.evaluate import evaluate_net
from lip2speech_torch.parallel import dist as pdist
from lip2speech_torch.parallel import tensor
from lip2speech_torch.train import checkpoint as ckpt
from lip2speech_torch.train.adversarial import adversarial_train_step, init_critic
from lip2speech_torch.train.logging_utils import MetricLogger, profile_steps
from lip2speech_torch.train.train_step import create_train_state, train_step
from lip2speech_torch.utils import trace


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        "lip2speech_torch train",
        description="Train on one device, or on a data x model grid of the processes "
                    "that torch.distributed.run launches (one per device).")
    add_common_args(p)
    add_dist_args(p)
    p.add_argument("--data_parallel", type=int, default=-1,
                   help="the grid's data axis: the world size over --model_parallel, or -1 "
                        "for that")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="the grid's model axis: the tensor-parallel size over which the K/V "
                        "conv banks and conv_last shard their output channels")
    p.add_argument("--multihost", action="store_true",
                   help="require the environment of torch.distributed.run (a WORLD_SIZE "
                        "above 1 starts the group without it)")
    p.add_argument("--finetune_model_path", default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--max_iters", type=int, default=None)
    p.add_argument("--eval_interval", type=int, default=None)
    p.add_argument("--log_interval", type=int, default=None)
    p.add_argument("--run_dir", default="runs/default")
    p.add_argument("--ckpt_dir", default="checkpoints/default")
    p.add_argument("--eval_batches", type=int, default=2)
    p.add_argument("--num_workers", type=int, default=None,
                   help="loader threads; default min(batch size, CPU count)")
    p.add_argument("--train_split", default="train",
                   help="corpus split to train on (e.g. 'test' to overfit a fixture)")
    p.add_argument("--no_augment", action="store_true",
                   help="turn off the p=0.5 horizontal flip (FaceAugmentation)")
    p.add_argument("--reuse_first_batch", action="store_true",
                   help="stage the first batch once and feed it to every step; only "
                        "for a training set that fits in one batch (the per-step "
                        "random draws still change with the step)")
    p.add_argument("--rewind_on_stall", type=int, default=0,
                   help="when this many consecutive updates were rejected, restore the "
                        "newest rolling safety checkpoint and continue on a new random "
                        "stream; 0 = off")
    p.add_argument("--rewind_lr_decay", type=float, default=1.0,
                   help="multiply the learning rate by this at every rewind")
    p.add_argument("--max_rewinds", type=int, default=25)
    p.add_argument("--cache_decoded_gb", type=float, default=0.0,
                   help="in-memory budget for decoded clips (LRW only)")
    p.add_argument("--profile_step", type=int, default=0,
                   help="profile this step (1-based; 0 = none): the device's busy "
                        "time, the step's wall time and the idle share go to the log")
    return p.parse_args(argv)


def tf_ratio_at(tc: TrainConfig, epoch: int) -> float:
    """The teacher-forcing ratio of an epoch: ``tf_ratio_start`` plus
    ``tf_ratio_step`` every ``tf_ratio_epochs`` epochs, at most 1."""
    return min(tc.tf_ratio_start + tc.tf_ratio_step * (epoch // tc.tf_ratio_epochs), 1.0)


def rewind_seed(seed: int, rewinds: int) -> int:
    """The step stream's seed after ``rewinds`` rewinds (the run's seed
    before any)."""
    if rewinds == 0:
        return seed
    return int(np.random.SeedSequence([seed, 7919 + rewinds]).generate_state(1)[0])


def _profile_summary(prof, wall_s: float) -> dict:
    """Device busy time, kernel launches and the idle share of ``wall_s``."""
    # a span's range shows on the device's timeline too: keep the device's own operations
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    wall_ms = wall_s * 1e3
    return {"wall_ms": wall_ms, "device_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "launches": float(sum(e.count for e in kernels))}


def train(args, cfg: Config | None = None) -> dict:
    """Runs the loop; returns ``final_step``, ``best_score``, the step and
    best score it started from, the loader's ``stats``, the ``critic``
    (adversarial mode, else None), the ``state`` and, with
    ``--profile_step``, the ``profile`` summary. A data-parallel run joins
    its group here and leaves it at the end."""
    cfg = cfg or common_config(args)
    tc = cfg.train
    if args.rewind_on_stall and tc.adversarial:
        # the safety checkpoints hold no critic: a rewind would roll the
        # generator back against the critic that saw the divergence
        raise RuntimeError(
            "--rewind_on_stall is unsupported with train.adversarial=true: "
            "the rolling safety checkpoint does not include the critic "
            "params/optimizer. Disable one of the two.")
    batch_size = args.batch_size or tc.batch_size
    pdist.data_parallel_size(args.data_parallel, pdist.env_world_size(), batch_size,
                             args.model_parallel)
    dp, device = start_data_parallel(args, required=args.multihost, n_model=args.model_parallel)
    try:
        return _train(args, cfg, dp, device, batch_size)
    finally:
        pdist.shutdown(dp)


def _train(args, cfg: Config, dp, device, batch_size: int) -> dict:
    tc = cfg.train
    say = print if pdist.is_main(dp) else (lambda *a, **k: None)
    if dp is not None:
        say(f"data parallel: {dp.world} ranks over {dp.backend}, global batch {batch_size}")
    if dp is not None and dp.n_model > 1:
        say(f"tensor parallel: a grid of {dp.n_data} x {dp.n_model} ranks (data x model)")
    max_iters = args.max_iters or tc.max_iters
    eval_interval = args.eval_interval or tc.eval_interval
    log_interval = args.log_interval or tc.log_interval

    ds_kw = {"augmentation": None if args.no_augment else FaceAugmentation()}
    if args.cache_decoded_gb and args.dataset.upper() == "LRW":
        ds_kw["cache_bytes"] = int(args.cache_decoded_gb * 2**30)
    ds = get_dataset(args.dataset, args.root, mode=args.train_split, cfg=cfg.data, **ds_kw)
    if len(ds) == 0:
        raise RuntimeError(f"empty dataset at {args.root}")
    if args.reuse_first_batch and len(ds) > batch_size:
        raise RuntimeError("--reuse_first_batch requires the whole training set to fit in one "
                           f"batch (len(ds)={len(ds)} > batch_size={batch_size})")
    eval_ds = get_dataset(args.dataset, args.root, mode="test", cfg=cfg.data)
    steps_per_epoch = max(len(ds) // batch_size, 1)

    model, _ = load_model(cfg, args.finetune_model_path or args.model_path, device)
    tensor.shard_(model, dp)
    state = create_train_state(cfg, model)
    start_it, best_score = 0, -1.0
    pdist.barrier(dp)  # every rank reads the same newest checkpoint
    restored = ckpt.restore_checkpoint(args.ckpt_dir, state)
    if restored is not None:
        _, extra = restored
        start_it = state.step
        best_score = float(extra.get("best_score", -1.0))
        say(f"resumed at step {start_it} (best ESTOI {best_score:.4f})")
    result = {"start_step": start_it, "start_best_score": best_score}
    critic = (init_critic(cfg, torch.Generator().manual_seed(tc.seed + 17), device)
              if tc.adversarial else None)
    if dp is not None:
        # the same weights, optimizer state, critic and shuffle on every rank;
        # the shards (and the moments, which hold them) on every data index
        held, shards = tensor.state_parts(model)
        opt = state.opt
        held += [opt.count, opt.notfinite_count, opt.total_notfinite,
                 torch.tensor([tc.seed, batch_size, start_it], device=device)]
        if critic is not None:
            held += list(critic.disc.state_dict().values())
        if not pdist.same_on_all_ranks(held, dp, shards + [opt.mu, opt.nu, opt.nu_max]):
            raise RuntimeError("the ranks start from different weights, state or seeds")

    logger = MetricLogger(args.run_dir, enabled=pdist.is_main(dp))
    loader = Loader(ds, batch_size, cfg.data, shuffle=True, infinite=True,
                    num_workers=args.num_workers or min(batch_size, os.cpu_count() or 8),
                    seed=tc.seed, pin_memory=device.type == "cuda",
                    shard_index=0 if dp is None else dp.data_index,
                    shard_count=1 if dp is None else dp.n_data)
    data_iter = iter(loader)
    staged = None
    it = start_it
    last_saved_step = -1

    # the rewind on a stall: rolling safety checkpoints, restored with a new
    # random stream when every update is being rejected
    safety_dir = os.path.join(args.ckpt_dir, "safety")
    stream_seed = tc.seed
    rewinds, rewind_depth, last_rewind_it, last_consec = 0, 0, -1, 0.0
    pending_nfc = None  # the previous step's notfinite_count, on the device
    first_safety = args.rewind_on_stall and not ckpt.available_steps(safety_dir)
    pdist.barrier(dp)  # every rank has looked before rank 0 writes
    if first_safety:
        ckpt.save_checkpoint(safety_dir, max(start_it, 0), state, {"best_score": best_score}, dp)

    def do_rewind():
        nonlocal rewinds, rewind_depth, last_rewind_it, stream_seed
        steps = ckpt.available_steps(safety_dir)
        if not steps:
            raise RuntimeError("rewind requested but no safety checkpoint")
        # repeated stalls walk back to older safety saves
        target = steps[max(len(steps) - 1 - rewind_depth, 0)]
        try:
            ckpt.restore_checkpoint(safety_dir, state, step=target)
        except FileNotFoundError as e:
            left = ckpt.available_steps(safety_dir)
            if not left:
                raise RuntimeError("rewind: no safety checkpoint survives") from e
            target = left[-1]
            say(f"rewind: requested step missing ({e}); restoring safety step {target}")
            ckpt.restore_checkpoint(safety_dir, state, step=target)
        rewinds += 1
        rewind_depth += 1
        last_rewind_it = it
        # the same stream would replay the same draws into the same stall
        stream_seed = rewind_seed(tc.seed, rewinds)
        if args.rewind_lr_decay != 1.0:
            state.opt.cfg = dataclasses.replace(
                state.opt.cfg, learning_rate=state.opt.cfg.learning_rate * args.rewind_lr_decay)
        say(f"[{it + 1}] REWIND #{rewinds}: {last_consec:.0f} consecutive rejected steps; "
              f"restored safety step {target}, lr {state.opt.cfg.learning_rate:.2e}, new stream")
        logger.scalars(it + 1, {"rewind": float(rewinds), "rewind_target": float(target)})

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    host_steps = 0  # the steps the recording holds
    with trace.recording() as spans:
        try:
            for it in range(start_it, max_iters):
                epoch = it // steps_per_epoch
                tf_ratio = tf_ratio_at(tc, epoch)
                profiling = it + 1 == args.profile_step
                if profiling:
                    sync()
                    t0 = time.perf_counter()
                with profile_steps() if profiling else contextlib.nullcontext() as prof:
                    if staged is None:
                        raw = to_device(next(data_iter), device)
                        pdist.agree_over_model_group_(raw.values(), dp)  # the same rows, drawn once
                        batch = prepare_batch(raw, cfg.audio, cfg.data)
                        batch.pop("audio"), batch.pop("audio_lengths")
                        if args.reuse_first_batch:
                            staged = batch
                            data_iter.close()  # no more batches are needed
                    else:
                        batch = staged
                    if critic is None:
                        metrics = train_step(state, batch, tf_ratio, cfg, seed=stream_seed, dp=dp)
                    else:
                        metrics = adversarial_train_step(state, critic, batch, tf_ratio, cfg,
                                                         seed=stream_seed, dp=dp)
                    if profiling:
                        sync()
                        wall = time.perf_counter() - t0
                if profiling:
                    result["profile"] = _profile_summary(prof, wall)
                    logger.scalars(it + 1, result["profile"], prefix="profile/")
                    say(f"[{it + 1}] profiled step: " + ", ".join(
                        f"{k} {v:.3f}" for k, v in result["profile"].items()))

                if args.rewind_on_stall:
                    if pending_nfc is not None:
                        last_consec = float(pending_nfc)
                    pending_nfc = metrics.get("notfinite_count")
                    if last_consec >= args.rewind_on_stall and rewinds < args.max_rewinds:
                        do_rewind()
                        last_consec = 0.0
                        pending_nfc = None

                host_steps += 1
                if (it + 1) % log_interval == 0:
                    values = {k: float(v) for k, v in metrics.items()}
                    values["tf_ratio"] = tf_ratio
                    values["epoch"] = epoch
                    logger.scalars(it + 1, values)
                    logger.console(it + 1, values, total_steps=max_iters)
                    host = {k: v / host_steps for k, v in spans.self_ms().items()}
                    logger.scalars(it + 1, {**host, "spans_dropped": spans.dropped}, prefix="host/")
                    spans.clear()
                    host_steps = 0

                if (it + 1) % eval_interval == 0:
                    score = evaluate_net(model, eval_ds, cfg, batch_size=min(32, batch_size),
                                         max_batches=args.eval_batches, dp=dp)
                    logger.scalars(it + 1, {"estoi": score}, prefix="eval/")
                    logger.histograms(it + 1, tensor.full_named_parameters(model))
                    say(f"[{it + 1}] eval ESTOI {score:.4f} (best {best_score:.4f})")
                    spans.clear()  # the eval tick's spans are no train step's
                    host_steps = 0
                    if score > best_score:
                        best_score = score
                        ckpt.save_checkpoint(args.ckpt_dir, it + 1, state, {"best_score": best_score},
                                             dp)
                        last_saved_step = it + 1
                    if args.rewind_on_stall and pending_nfc is not None:
                        last_consec = float(pending_nfc)  # this step's, before the safety save
                        pending_nfc = None
                    if args.rewind_on_stall and last_consec == 0.0:
                        # a safety save only from a step that was taken
                        ckpt.save_checkpoint(safety_dir, it + 1, state, {"best_score": best_score},
                                             dp)
                        ckpt.prune_checkpoints(safety_dir, keep=5, dp=dp)
                        if it - last_rewind_it >= eval_interval:
                            rewind_depth = 0
        finally:
            data_iter.close()
            logger.close()

    if dp is not None:
        held, shards = tensor.state_parts(model)
        if not pdist.same_on_all_ranks(held, dp, shards):
            raise RuntimeError("the ranks end the run with different weights")
    # the final save, unless the eval tick just saved this step
    if last_saved_step != max_iters:
        ckpt.save_checkpoint(args.ckpt_dir, max_iters, state, {"best_score": best_score}, dp)
    result.update(final_step=it + 1, best_score=best_score, loader=dict(loader.stats),
                  critic=critic, state=state)
    return result


def main(argv=None):
    train(parse_args(argv))


if __name__ == "__main__":
    main()
