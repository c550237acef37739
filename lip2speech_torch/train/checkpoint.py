"""Train-state checkpoints (PyTorch).

Counterpart of ``save_checkpoint``, ``available_steps``,
``prune_checkpoints`` and ``restore_checkpoint`` in
``lip2speech_tpu/train/checkpoint.py:345-447``, written with
``torch.save``: ``<dir>/step_<N>.pt`` holds the model's state dict under the
reference names, the optimizer state, the step and ``extra``. A save goes
to a temporary file first and is renamed into place, so a save cut short
leaves only a temporary file, which listing skips. The JAX package's orbax
checkpoints are not read here; parameters cross over through
``weights.from_flax``.

In a data-parallel run (``dp``) only rank 0 writes and deletes, and every
rank waits for it before going on, so a rank that reads next finds the
files in place.

A checkpoint is independent of the layout, as orbax's global arrays are:
under tensor parallelism every rank gathers its model group's shards of the
parameters and of the optimizer's moments (``parallel.tensor``), rank 0
writes them in the one-rank format, and a restore cuts each rank's slices
from it (``shard_like``). So a checkpoint of a grid restores into one rank,
and one rank's into a grid.
"""

from __future__ import annotations

import os
import re

import torch

from lip2speech_torch.parallel import tensor
from lip2speech_torch.parallel.dist import barrier, is_main

_STEP = re.compile(r"step_(\d+)\.pt")


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step}.pt")


def save_checkpoint(ckpt_dir: str, step: int, state, extra: dict | None = None, dp=None) -> str:
    """Write ``state`` (a ``TrainState``) as step ``step``; returns the path.
    Under ``dp`` rank 0 writes and every rank waits for it; a sharded
    state's shards are gathered first, on every rank."""
    path = _path(ckpt_dir, step)
    model = {k: v for k, v in tensor.full_state_dict(state.model).items()
             if not k.endswith("num_batches_tracked")}
    optimizer = state.opt.state_dict()
    if not is_main(dp):
        barrier(dp)
        return path
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {"model": model, "optimizer": optimizer, "step": int(state.step),
               "extra": dict(extra or {})}
    tmp = f"{path}.tmp-{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    barrier(dp)
    return path


def available_steps(ckpt_dir: str) -> list[int]:
    """Sorted steps of the finished checkpoints under ``ckpt_dir``."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP.fullmatch, os.listdir(ckpt_dir)) if m)


def prune_checkpoints(ckpt_dir: str, keep: int, dp=None) -> None:
    """Delete the oldest checkpoints, keeping the newest ``keep``; under
    ``dp`` rank 0 deletes and every rank waits for it."""
    if is_main(dp):
        for s in available_steps(ckpt_dir)[:-keep]:
            os.remove(_path(ckpt_dir, s))
    barrier(dp)


def restore_checkpoint(ckpt_dir: str, state=None, step: int | None = None):
    """Restore the newest checkpoint, or step ``step`` exactly. With
    ``state``, loads it in place (model with ``strict=True``, optimizer,
    step; a sharded state takes its slices) and returns ``(state, extra)``;
    without, returns ``(payload, extra)``. Returns None when there is no
    checkpoint; a missing explicit step raises ``FileNotFoundError``."""
    steps = available_steps(ckpt_dir)
    if not steps:
        return None
    if step is not None and step not in steps:
        raise FileNotFoundError(
            f"checkpoint step {step} not found in {os.path.abspath(ckpt_dir)}; "
            f"available steps: {steps}")
    payload = torch.load(_path(ckpt_dir, max(steps) if step is None else step),
                         map_location="cpu", weights_only=True)
    if state is None:
        return payload, payload["extra"]
    tensor.load_full_state_dict_(state.model, payload["model"])
    state.opt.load_state_dict(payload["optimizer"])
    state.step = payload["step"]
    return state, payload["extra"]
