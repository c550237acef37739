"""The port's training CLI data-parallel on the CPU: two ranks of
``cli.train --device cpu --dist_backend gloo``, with the environment that
``torch.distributed.run`` gives each rank, on a tiny model and the synthetic
LRW fixture (the settings of ``tests/test_torch_train_cli.py``).

One launch of the two processes (killed after ``TIMEOUT_S``; the test then
fails) calls the training CLI twice in each: 2 steps with an eval tick,
then a resume to step 3; then ``cli.evaluate`` on the checkpoint; then the
same two training calls on a 1 x 2 grid (``--model_parallel 2``: the K/V
banks and ``conv_last`` sharded over the two ranks, which hold the same
rows). Only rank 0 writes the checkpoints, ``metrics.jsonl`` and the
console (the evaluation's JSON line too), and both ranks resume from the
step rank 0 saved; the grid's checkpoint holds the whole tensors.
``tests/test_torch_tensor_parallel.py`` holds the grid's numbers. The
flags' refusals are checked in this process: a grid whose size is not the
world size, a ``--model_parallel`` that does not divide it, a batch that
does not split over the data axis, ``--multihost`` without the launcher's
environment, and NCCL on the CPU.
"""

from __future__ import annotations

import json
import os
import socket
import sys

import numpy as np
import pytest
import torch

from lip2speech_torch.cli import train as train_cli
from lip2speech_torch.data import make_sample_lrw
from test_torch_parallel import launch, one_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

TIMEOUT_S = 120
RANKS, BATCH, STEPS = 2, 4, 2
SMALL = dict(ffn_hidden_dim=128, content_vocab_size=33, content_latent_dim=64,
             max_decoder_steps=24, postnet_embedding_dim=64, shufflenet_width=0.5)
FRAMES, SAMPLES = 12, 8192
DATA = dict(mouth_size=(48, 48), face_size=(80, 80), max_video_frames=FRAMES,
            max_audio_samples=SAMPLES)
OVERRIDES = [a for k, v in {**{f"model.{k}": v for k, v in SMALL.items()},
                            **{f"data.{k}": v for k, v in DATA.items()}}.items()
             for a in ("--override", f"{k}={v}")]
# each rank: TensorBoard left out (it imports for seconds), then one CLI
# call for each (port, CLI, argv) of the JSON list: each call's group on a
# port of its own, as a group started right after another on the same port
# could reach the previous group's store before rank 0 has closed it
BOOT = ("import importlib, json, os, sys; sys.modules['torch.utils.tensorboard'] = None\n"
        "for port, cli, argv in json.loads(sys.argv[1]):\n"
        "    os.environ['MASTER_PORT'] = str(port)\n"
        "    importlib.import_module('lip2speech_torch.cli.' + cli).main(argv)")


def _free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _env(rank: int, port: int) -> dict:
    return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "RANK": str(rank),
            "LOCAL_RANK": str(rank), "WORLD_SIZE": str(RANKS), "LOCAL_WORLD_SIZE": str(RANKS)}


def _argv(root, tmp, *extra, run: str = "run", ckpt: str = "ckpt") -> list[str]:
    return ["--root", root, "--device", "cpu", "--dist_backend", "gloo", "--multihost",
            "--batch_size", str(BATCH), "--log_interval", "1", "--eval_batches", "1",
            "--num_workers", "2",
            "--run_dir", os.path.join(tmp, run), "--ckpt_dir", os.path.join(tmp, ckpt),
            *OVERRIDES, *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dp_cli"))
    root = os.path.join(tmp, "lrw")
    make_sample_lrw(root, split="train", n_clips=8, n_frames=FRAMES, n_samples=SAMPLES)
    make_sample_lrw(root, split="test", n_clips=4, n_frames=FRAMES, n_samples=SAMPLES)
    evaluate = ["--root", root, "--device", "cpu", "--dist_backend", "gloo", "--batch_size",
                str(BATCH), "--gl_iters", "4", "--model_path", os.path.join(tmp, "ckpt"),
                *OVERRIDES]
    grid = dict(run="run_grid", ckpt="ckpt_grid")
    calls = [("train", _argv(root, tmp, "--max_iters", str(STEPS), "--eval_interval", str(STEPS))),
             ("train", _argv(root, tmp, "--max_iters", str(STEPS + 1), "--eval_interval", "1000")),
             ("evaluate", evaluate),
             ("train", _argv(root, tmp, "--model_parallel", "2", "--max_iters", str(STEPS),
                             "--eval_interval", "1000", **grid)),
             ("train", _argv(root, tmp, "--model_parallel", "2", "--max_iters", str(STEPS + 1),
                             "--eval_interval", "1000", **grid))]
    calls = [(port, *call) for port, call in zip(_free_ports(len(calls)), calls)]
    outs = launch([[sys.executable, "-c", BOOT, json.dumps(calls)] for _ in range(RANKS)],
                  {r: _env(r, 1) for r in range(RANKS)}, timeout=TIMEOUT_S)
    rows = {}
    for run in ("run", "run_grid"):
        with open(os.path.join(tmp, run, "metrics.jsonl")) as f:
            rows[run] = [json.loads(line) for line in f]
    return {"tmp": tmp, "outs": outs, "rows": rows["run"], "grid_rows": rows["run_grid"]}


def test_only_rank_zero_writes(runs):
    train_rows = [r["step"] for r in runs["rows"] if "total" in r]
    evals = [r["step"] for r in runs["rows"] if "eval/estoi" in r]
    assert train_rows == [1, 2, 3] and evals == [STEPS]  # one record each, not one a rank
    assert sorted(os.listdir(os.path.join(runs["tmp"], "ckpt"))) == ["step_2.pt", "step_3.pt"]
    rank0, rank1 = runs["outs"]
    assert "data parallel: 2 ranks over gloo, global batch 4" in rank0
    assert "[2] eval ESTOI" in rank0
    for line in ("data parallel", "tensor parallel", "ESTOI", "resumed", "[1] "):
        assert line not in rank1


def test_both_ranks_resume(runs):
    assert "resumed at step 2" in runs["outs"][0]
    payload = torch.load(os.path.join(runs["tmp"], "ckpt", "step_3.pt"), weights_only=True)
    assert payload["step"] == STEPS + 1


def test_evaluate_prints_on_rank_zero(runs):
    lines = [json.loads(line) for line in runs["outs"][0].splitlines() if line.startswith("{")]
    assert len(lines) == 1 and lines[0]["n_clips"] == 4 and np.isfinite(lines[0]["estoi"])
    assert not any(line.startswith("{") for line in runs["outs"][1].splitlines())


def _rank0_env(monkeypatch, world: int):
    for k, v in _env(0, 1).items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("WORLD_SIZE", str(world))


def test_grid_trains_and_resumes(runs):
    """The 1 x 2 grid's two calls (no eval tick: the grid's evaluation is held
    in ``tests/test_torch_tensor_parallel.py``): one record a step, both
    ranks resume at the step rank 0 saved, and the checkpoint holds the
    sharded kernels whole (the one-rank format)."""
    assert [r["step"] for r in runs["grid_rows"] if "total" in r] == [1, 2, 3]
    assert all(np.isfinite(r["total"]) for r in runs["grid_rows"] if "total" in r)
    rank0 = runs["outs"][0]
    assert "tensor parallel: a grid of 1 x 2 ranks (data x model)" in rank0
    assert rank0.count("resumed at step 2") == 2
    payload = torch.load(os.path.join(runs["tmp"], "ckpt_grid", "step_3.pt"), weights_only=True)
    width = SMALL["ffn_hidden_dim"]
    assert payload["step"] == STEPS + 1
    for bank in ("K", "V"):
        assert payload["model"][f"decoder.{bank}.0.bottleneck.weight"].shape[0] == width
        assert payload["model"][f"decoder.{bank}.0.conv.3.0.weight"].shape[0] == width
    assert payload["model"]["encoder.trunk.1.0.weight"].shape[0] == 768
    n = sum(v.numel() for k, v in payload["model"].items() if k.startswith(("encoder.", "decoder."))
            and ".bias_hh_" not in k and not k.endswith(("running_mean", "running_var",
                                                         "num_batches_tracked")))
    assert payload["optimizer"]["mu"].numel() == n


@pytest.mark.parametrize("flags, error, words", [
    (["--data_parallel", "3"], ValueError, "must be the world size"),
    (["--data_parallel", "2", "--model_parallel", "2"], ValueError,
     "grid's size must be the world"),
    (["--batch_size", "3"], ValueError, "does not split into 2"),
    (["--dist_backend", "nccl"], ValueError, "nccl backend needs --device cuda"),
    (["--model_parallel", "3"], ValueError, "--model_parallel 3 does not divide the 2 processes"),
])
def test_flags_that_raise(monkeypatch, tmp_path, flags, error, words):
    """Each raises before the process joins a group (none would form: the
    second rank never starts)."""
    _rank0_env(monkeypatch, RANKS)
    args = train_cli.parse_args(["--root", str(tmp_path), "--device", "cpu", *flags])
    with pytest.raises(error, match=words):
        train_cli.train(args)


def test_grid_batch_must_split_over_the_data_axis(monkeypatch, tmp_path):
    """On 8 processes, ``--model_parallel 2`` leaves a data axis of 4, which a
    batch of 6 does not split into."""
    _rank0_env(monkeypatch, 8)
    args = train_cli.parse_args(["--root", str(tmp_path), "--device", "cpu", "--model_parallel",
                                 "2", "--batch_size", "6"])
    with pytest.raises(ValueError, match="does not split into 4"):
        train_cli.train(args)


def test_multihost_needs_the_launcher(monkeypatch, tmp_path):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    args = train_cli.parse_args(["--root", str(tmp_path), "--device", "cpu", "--multihost"])
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        train_cli.train(args)

