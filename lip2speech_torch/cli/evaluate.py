"""Evaluation CLI: the mean ESTOI (or STOI, PESQ) over a test split.

Counterpart of ``lip2speech_tpu/cli/evaluate.py``. Prints one JSON line
with ``dataset``, ``n_clips`` and the score. Launched by
``torch.distributed.run``, each process joins the group
(``cli.common.start_data_parallel``, ``--dist_backend``) and scores its
rows of every batch (``eval.evaluate.evaluate_net``); rank 0 prints the
score over every rank's clips.

Usage: python -m lip2speech_torch.cli.evaluate --dataset LRW --root ... \
         [--model_path ckpt_dir_or.pth] [--device cuda]
         [--override vocoder.kind=bigvgan [--vocoder_checkpoint g.pt]]
"""

from __future__ import annotations

import argparse
import json

from lip2speech_torch.cli.common import (add_common_args, add_dist_args, common_config,
                                         load_model, load_vocoder, start_data_parallel)
from lip2speech_torch.data import get_dataset
from lip2speech_torch.eval.evaluate import evaluate_net
from lip2speech_torch.parallel import dist as pdist


def parse_args(argv=None):
    p = argparse.ArgumentParser("lip2speech_torch evaluate")
    add_common_args(p)
    add_dist_args(p)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--gl_iters", type=int, default=32, help="Griffin-Lim iterations")
    p.add_argument("--device_estoi", action="store_true",
                   help="score on the device (ops.estoi.estoi_batch, float64) "
                        "instead of on the host")
    p.add_argument("--metric", choices=("estoi", "stoi", "pesq"), default="estoi",
                   help="pesq needs the `pesq` wheel (eval/metrics.py)")
    p.add_argument("--seed", type=int, default=0, help="seed of the eval's random draws")
    return p.parse_args(argv)


def main(argv=None) -> float:
    args = parse_args(argv)
    cfg = common_config(args)
    dp, device = start_data_parallel(args)
    try:
        ds = get_dataset(args.dataset, args.root, mode="test", cfg=cfg.data)
        bs = min(args.batch_size, max(len(ds), 1))
        model, _ = load_model(cfg, args.model_path, device)
        vocoder = load_vocoder(cfg, args.vocoder_checkpoint, device)
        score = evaluate_net(model, ds, cfg, batch_size=bs, n_gl_iters=args.gl_iters,
                             max_batches=args.max_batches, seed=args.seed,
                             device_estoi=args.device_estoi, metric=args.metric, dp=dp,
                             vocoder=vocoder)
    finally:
        pdist.shutdown(dp)
    if pdist.is_main(dp):
        print(json.dumps({"dataset": args.dataset, "n_clips": len(ds), args.metric: score}))
    return score


if __name__ == "__main__":
    main()
