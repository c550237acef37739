"""Shared CLI plumbing: the common arguments, the config and the model.

Counterpart of ``lip2speech_tpu/cli/common.py``. ``load_model`` takes a
reference ``.pth``, a checkpoint directory of this port
(``train/checkpoint.py``) or, with no path, random weights from the
config's seed; a path that is given but unusable raises.

``load_vocoder`` builds the mel -> waveform stage that ``--override
vocoder.kind`` names: nothing for Griffin-Lim, BigVGAN from
``--vocoder_checkpoint`` (a BigVGAN checkpoint whose weight norm is folded)
or, without one, random from the config's seed.

``start_data_parallel`` joins the process group of a run launched by
``torch.distributed.run`` (``parallel/dist.py``), with the groups of its
rank grid, and picks the rank's device; ``--dist_backend`` names the
collectives' backend, as JAX's ``jax_cpu_collectives_implementation`` does
for its CPU collectives.
"""

from __future__ import annotations

import argparse
import os

import torch

from lip2speech_torch import weights
from lip2speech_torch.config import Config, config_with_overrides
from lip2speech_torch.models.layers import resolve_device
from lip2speech_torch.models.lip2speech import Lip2Speech, init_random_
from lip2speech_torch.models.vocoder import build_vocoder
from lip2speech_torch.parallel import dist as pdist
from lip2speech_torch.train import checkpoint as ckpt

DATASETS = ("LRW", "GRID", "AVSpeech", "WILD")


def add_common_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("--dataset", default="LRW", choices=DATASETS)
    p.add_argument("--root", required=True, help="corpus root")
    p.add_argument("--model_path", default=None,
                   help="checkpoint directory of this port or reference .pth; "
                        "random weights from train.seed when absent")
    p.add_argument("--override", action="append", default=[],
                   help="config override key=value (e.g. model.gumbel_tau=0.5)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--vocoder_checkpoint", default=None,
                   help="BigVGAN generator checkpoint, with --override vocoder.kind=bigvgan; "
                        "random weights from train.seed when absent")
    return p


def add_dist_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("--dist_backend", choices=("nccl", "gloo"), default=None,
                   help="collectives of a data-parallel run launched by torch.distributed.run: "
                        "nccl on CUDA and gloo on the CPU by default; gloo on CUDA lets several "
                        "ranks share one card")
    return p


def start_data_parallel(args, required: bool = False, n_model: int = 1):
    """(the group of a data-parallel run or None, the device): a run under
    ``torch.distributed.run`` (``WORLD_SIZE`` > 1, or ``required``) joins
    its group, a grid of ``world / n_model`` x ``n_model`` ranks, on
    ``cuda:{LOCAL_RANK}`` or the CPU; one process runs on ``--device``."""
    dp = pdist.init_from_env(args.device, getattr(args, "dist_backend", None), required,
                             n_model)
    return dp, (resolve_device(args.device) if dp is None else dp.device)


def common_config(args) -> Config:
    """The Config of a CLI call, with its ``--override``s."""
    return config_with_overrides(*getattr(args, "override", []))


def load_model(cfg: Config, model_path: str | None, device: torch.device):
    """(model on ``device`` in f32, the speaker encoder's state dict or
    None). A ``.pth`` is a reference checkpoint, a directory holds this
    port's checkpoints (the newest is read); no path gives random weights
    from ``cfg.train.seed``."""
    model = Lip2Speech(cfg.model)
    speaker_sd = None
    if model_path and model_path.endswith(".pth"):
        state, speaker_sd = weights.load_reference_pth(model_path)
        model.load_state_dict(state, strict=True)
        print(f"loaded reference checkpoint {model_path}")
    elif model_path and os.path.isdir(model_path):
        restored = ckpt.restore_checkpoint(model_path)
        if restored is None:
            raise FileNotFoundError(f"no checkpoint under {model_path}")
        payload, _ = restored
        model.load_state_dict(payload["model"], strict=True)
        print(f"restored step {payload['step']} from {model_path}")
    elif model_path:
        raise FileNotFoundError(
            f"model_path {model_path!r} is neither a .pth file nor a checkpoint directory")
    else:
        init_random_(model, torch.Generator().manual_seed(cfg.train.seed))
    return model.to(device), speaker_sd


def load_vocoder(cfg: Config, checkpoint: str | None, device: torch.device):
    """The vocoder's generator on ``device`` in f32 (None for Griffin-Lim):
    ``checkpoint``'s weights, or random from ``cfg.train.seed``."""
    if checkpoint and cfg.vocoder.kind == "griffin_lim":
        raise ValueError("--vocoder_checkpoint needs --override vocoder.kind=bigvgan")
    return build_vocoder(cfg, device, checkpoint=checkpoint or None)
