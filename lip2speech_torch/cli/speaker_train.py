"""Speaker-encoder pretraining CLI.

Counterpart of ``lip2speech_tpu/cli/speaker_train.py:32-114``, on one
device or one process a device (data parallelism, below): AVSpeechFace samples read in a shuffled order each epoch (a corpus
smaller than a batch is repeated cyclically to fill it), collated to 2 s of
speech, and one ``speaker_train_step`` a batch; scalars through
``MetricLogger`` every ``--log_interval`` steps; checkpoints
(``train/checkpoint.py``: the face net, the face decoder, ``t``, the voice
encoder and the optimizer state) every ``--save_interval`` steps and at the
end. Weights start random from ``train.seed``.

Data parallelism, as the JAX CLI's data mesh: launched by
``torch.distributed.run``, each process joins the group
(``cli.common.start_data_parallel``, ``--dist_backend``), builds the same
global batch of indices and reads its rows of it (``--batch_size`` is the
global batch); the step gathers the embeddings for the contrastive loss and
sums the gradients (``speaker/train_loop.py``). Only rank 0 writes.

Usage: python -m lip2speech_torch.cli.speaker_train --root <AVSpeech root> [--device cpu]
       python -m torch.distributed.run --nproc_per_node 2 \
           -m lip2speech_torch.cli.speaker_train --root ... [--device cpu --dist_backend gloo]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from lip2speech_torch.cli.common import add_dist_args, start_data_parallel
from lip2speech_torch.config import Config
from lip2speech_torch.data.collate import to_device
from lip2speech_torch.parallel import dist as pdist
from lip2speech_torch.speaker import (AVSpeechFace, collate_speaker, create_speaker_state,
                                      init_speaker_training, speaker_train_step)
from lip2speech_torch.train import checkpoint as ckpt
from lip2speech_torch.train.logging_utils import MetricLogger


def parse_args(argv=None):
    p = argparse.ArgumentParser("speaker encoder pretraining")
    p.add_argument("--root", required=True)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--max_iters", type=int, default=720_000)
    p.add_argument("--save_interval", type=int, default=1000)
    p.add_argument("--log_interval", type=int, default=50)
    p.add_argument("--run_dir", default="runs/speaker")
    p.add_argument("--ckpt_dir", default="checkpoints/speaker")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    add_dist_args(p)
    return p.parse_args(argv)


def train(args, cfg: Config | None = None):
    """Runs the loop; returns the final ``SpeakerTrainState``. A
    data-parallel run joins its group here and leaves it at the end."""
    cfg = cfg or Config()
    pdist.data_parallel_size(-1, pdist.env_world_size(), args.batch_size)
    dp, device = start_data_parallel(args)
    try:
        return _train(args, cfg, dp, device)
    finally:
        pdist.shutdown(dp)


def _train(args, cfg: Config, dp, device):
    ds = AVSpeechFace(args.root, mode="train", cfg=cfg.data)
    if len(ds) == 0:
        raise RuntimeError(f"no AVSpeechFace clips under {args.root}")

    model = init_speaker_training(cfg, torch.Generator().manual_seed(cfg.train.seed)).to(device)
    state = create_speaker_state(model, max(len(ds) // args.batch_size, 1))
    if not pdist.same_on_all_ranks(list(model.state_dict().values()), dp):
        raise RuntimeError("the ranks start from different weights")
    logger = MetricLogger(args.run_dir, enabled=pdist.is_main(dp))
    rng_np = np.random.default_rng(cfg.train.seed)
    order = np.arange(len(ds))
    it = 0
    try:
        while it < args.max_iters:
            rng_np.shuffle(order)
            for b in range(len(ds) // args.batch_size or 1):
                idxs = order[b * args.batch_size: (b + 1) * args.batch_size]
                if len(idxs) < args.batch_size:  # a short corpus fills the batch cyclically
                    reps = -(-args.batch_size // max(len(order), 1))
                    idxs = np.tile(order, reps)[: args.batch_size]
                if dp is not None:  # this rank's rows of the global batch
                    idxs = idxs.reshape(dp.world, -1)[dp.rank]
                batch = to_device(collate_speaker([ds[int(i)] for i in idxs]), device)
                metrics = speaker_train_step(state, batch, seed=cfg.train.seed, dp=dp)
                it += 1
                if it % args.log_interval == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    logger.scalars(it, m)
                    logger.console(it, m, total_steps=args.max_iters)
                if it % args.save_interval == 0:
                    ckpt.save_checkpoint(args.ckpt_dir, it, state, {"t": float(model.t.detach())},
                                         dp)
                if it >= args.max_iters:
                    break
    finally:
        logger.close()
    ckpt.save_checkpoint(args.ckpt_dir, it, state, {"t": float(model.t.detach())}, dp)
    return state


def main(argv=None):
    return train(parse_args(argv))


if __name__ == "__main__":
    main()
