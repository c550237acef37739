"""The port's training and evaluation CLIs on the CPU (``--device cpu``), a
tiny model on the synthetic LRW fixture; their schedules and logger.

The JAX CLI's metric names come from the JAX train step itself
(``jax.eval_shape``, no compile) written through the JAX ``MetricLogger``
as the JAX loop writes them.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from lip2speech_torch.cli import evaluate as eval_cli
from lip2speech_torch.cli import train as train_cli
from lip2speech_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from lip2speech_torch.data import make_sample_lrw
from lip2speech_torch.train import logging_utils, schedules
from torch_port_common import SMALL
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY = dict(SMALL, max_decoder_steps=24)
# shorter clips (12 frames, 8192 samples: 33 mel frames, enough for ESTOI's
# 30-frame segments) and smaller crops than LRW's, for the CPU; the reader
# resizes to the crops
FRAMES, SAMPLES = 12, 8192
DATA = dict(mouth_size=(48, 48), face_size=(80, 80), max_video_frames=FRAMES,
            max_audio_samples=SAMPLES)
OVERRIDES = ([f"model.{k}={v}" for k, v in TINY.items()]
             + [f"data.{k}={v}" for k, v in DATA.items()])


def tiny_config(**train) -> Config:
    return Config(model=ModelConfig(**TINY), data=DataConfig(**DATA), train=TrainConfig(**train))


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard():
    """The CLI runs log without TensorBoard: importing it costs seconds here,
    and its histograms of every weight more (test_metric_logger covers it)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lrw_train_cli"))
    make_sample_lrw(root, split="train", n_clips=4, n_frames=FRAMES, n_samples=SAMPLES)
    make_sample_lrw(root, split="test", n_clips=2, n_frames=FRAMES, n_samples=SAMPLES)
    return root


def _args(root, tmp, *extra):
    return train_cli.parse_args(["--root", root, "--device", "cpu", "--batch_size", "2",
                                 "--log_interval", "1", "--run_dir", str(tmp / "run"),
                                 "--ckpt_dir", str(tmp / "ckpt"), *extra])


def _rows(tmp):
    with open(tmp / "run" / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def trained(root, tmp_path_factory):
    """Two steps with an eval tick at step 2 (and its checkpoint), then a
    resumed run to step 3."""
    tmp = tmp_path_factory.mktemp("train_cli")
    cfg = tiny_config()
    first = train_cli.train(_args(root, tmp, "--max_iters", "2", "--eval_interval", "2",
                                  "--eval_batches", "1"), cfg)
    second = train_cli.train(_args(root, tmp, "--max_iters", "3", "--eval_interval", "100"), cfg)
    return tmp, first, second


def test_train_eval_checkpoint_resume(trained):
    tmp, first, second = trained
    assert first["start_step"] == 0 and first["final_step"] == 2
    assert -1.0 <= first["best_score"] <= 1.0
    assert second["start_step"] == 2 and second["start_best_score"] == first["best_score"]
    assert second["final_step"] == 3 and second["best_score"] == first["best_score"]
    assert sorted(os.listdir(tmp / "ckpt")) == ["step_2.pt", "step_3.pt"]
    rows = _rows(tmp)
    assert [r["step"] for r in rows if "total" in r] == [1, 2, 3]
    assert all(np.isfinite(r["total"]) for r in rows if "total" in r)
    assert [r["step"] for r in rows if "eval/estoi" in r] == [2]
    # each log tick's host self ms a step by span, a row of its own
    host = [r for r in rows if "host/train.backward" in r]
    assert [r["step"] for r in host] == [1, 2, 3]
    assert all(r["host/train.backward"] > 0 and r["host/decoder.teacher_forced"] > 0
               and r["host/spans_dropped"] == 0 for r in host)
    assert first["loader"]["batches"] >= 2
    with open(tmp / "run" / "histograms.jsonl") as f:
        hist = json.loads(f.readline())
    assert hist["step"] == 2 and "param/decoder.fc_out.linear_layer.weight" in hist["layers"]


def _jax_cli_keys(tmp_path):
    """The keys of the JAX CLI's train and eval records: the JAX train
    step's metrics (traced, not compiled) plus what its loop adds, written
    by its MetricLogger."""
    import jax
    import jax.numpy as jnp

    from lip2speech_tpu.config import Config as JConfig
    from lip2speech_tpu.config import ModelConfig as JModelConfig
    from lip2speech_tpu.models import Lip2Speech as JLip2Speech
    from lip2speech_tpu.train import create_train_state, make_optimizer, make_train_step
    from lip2speech_tpu.train.logging_utils import MetricLogger as JMetricLogger

    cfg = JConfig(model=JModelConfig(**TINY))
    model = JLip2Speech(cfg.model)
    # a speaker embedding in place of the faces: the face net, which adds no
    # metric, is left out of the trace
    B, M = 2, 80
    batch = {"video": jnp.zeros((B, 29, 96, 96, 3)), "speaker_embedding": jnp.zeros((B, 256)),
             "mel": jnp.zeros((B, 80, M)), "gate": jnp.zeros((B, M)),
             "mel_mask": jnp.ones((B, M), bool), "video_lengths": jnp.full((B,), 29),
             "mel_lengths": jnp.full((B,), M)}

    def step():
        keys = {k: jax.random.PRNGKey(i) for i, k in enumerate(("gumbel", "teacher", "dropout"))}
        v = model.init({"params": jax.random.PRNGKey(0)}, batch["video"], None, batch["mel"], 0.5,
                       batch["speaker_embedding"], keys, train=False)
        tx = make_optimizer(cfg, v["params"])
        state = create_train_state(cfg, v, init_opt=False)
        state = state._replace(opt_state=tx.init(state.params))
        return make_train_step(cfg, model, tx)(state, batch, jnp.float32(0.5),
                                               jax.random.PRNGKey(0))[1]

    metrics = jax.eval_shape(step)
    logger = JMetricLogger(str(tmp_path), tensorboard=False)
    train_rec = logger.scalars(1, {**{k: 0.0 for k in metrics}, "tf_ratio": 0.1, "epoch": 0})
    eval_rec = logger.scalars(1, {"estoi": 0.0}, prefix="eval/")
    return set(train_rec), set(eval_rec)


def test_metric_keys_match_the_jax_cli(trained, tmp_path):
    tmp, _, _ = trained
    want_train, want_eval = _jax_cli_keys(tmp_path)
    rows = _rows(tmp)
    assert all(set(r) == want_train for r in rows if "total" in r)
    assert [set(r) for r in rows if "eval/estoi" in r] == [want_eval]


def _jax_tf_ratio(tc, it, steps_per_epoch):
    """``lip2speech_tpu/cli/train.py:274-279``."""
    epoch = it // steps_per_epoch
    return min(tc.tf_ratio_start + tc.tf_ratio_step * (epoch // tc.tf_ratio_epochs), 1.0)


def test_tf_ratio_anneal_matches_jax():
    from lip2speech_tpu.config import TrainConfig as JTrainConfig

    for kw in ({}, {"tf_ratio_epochs": 1, "tf_ratio_step": 0.4}):
        tc, jtc = TrainConfig(**kw), JTrainConfig(**kw)
        for it in range(0, 400, 7):
            assert train_cli.tf_ratio_at(tc, it // 3) == _jax_tf_ratio(jtc, it, 3)


def test_rewind_on_stall_restores_a_safety_step_on_a_new_stream(root, tmp_path, monkeypatch):
    """Every update rejected (a tiny reject_grad_norm_above): after two
    rejected steps the loop restores the step-0 safety checkpoint and draws
    from a new stream, twice, then stops rewinding (--max_rewinds)."""
    calls = []
    real_step = train_cli.train_step

    def step(state, batch, tf_ratio, cfg, seed=None, dp=None):
        calls.append((state.step, seed, tf_ratio))
        return real_step(state, batch, tf_ratio, cfg, seed=seed, dp=dp)

    monkeypatch.setattr(train_cli, "train_step", step)
    cfg = tiny_config(reject_grad_norm_above=1e-12, bf16=False, tf_ratio_epochs=1,
                      tf_ratio_step=0.4)
    result = train_cli.train(_args(root, tmp_path, "--max_iters", "6", "--eval_interval", "100",
                                   "--rewind_on_stall", "2", "--max_rewinds", "2"), cfg)
    assert result["final_step"] == 6
    rows = _rows(tmp_path)
    rewinds = [r for r in rows if "rewind" in r]
    assert [r["rewind_target"] for r in rewinds] == [0.0, 0.0]
    seed = cfg.train.seed
    s1, s2 = train_cli.rewind_seed(seed, 1), train_cli.rewind_seed(seed, 2)
    assert len({seed, s1, s2}) == 3
    assert [(c[0], c[1]) for c in calls] == [(0, seed), (1, seed), (2, seed), (0, s1), (1, s1), (2, s1)]
    # the tf ratio follows the loop's step, which a rewind does not turn back
    assert [r["tf_ratio"] for r in rows if "total" in r] == [
        _jax_tf_ratio(cfg.train, it, 2) for it in range(6)]
    assert [r["notfinite_count"] for r in rows if "total" in r] == [1, 2, 3, 1, 2, 3]
    assert os.listdir(tmp_path / "ckpt" / "safety") == ["step_0.pt"]


class FakeProfile:
    """A profile with no events, for the CLI's wiring (profile_steps itself
    is tested below): recording a whole step's host ops on a CPU takes
    seconds."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def key_averages(self):
        return []


def test_reuse_first_batch(root, tmp_path, monkeypatch):
    monkeypatch.setattr(train_cli, "profile_steps", FakeProfile)
    cfg = tiny_config()
    with pytest.raises(RuntimeError, match="fit in one batch"):
        train_cli.train(_args(root, tmp_path, "--max_iters", "1", "--reuse_first_batch"), cfg)
    result = train_cli.train(_args(root, tmp_path, "--max_iters", "2", "--eval_interval", "100",
                                   "--reuse_first_batch", "--train_split", "test",
                                   "--no_augment", "--cache_decoded_gb", "0.1",
                                   "--profile_step", "2"), cfg)
    assert result["final_step"] == 2
    # no device time: the whole step is idle
    assert result["profile"]["device_ms"] == 0 and result["profile"]["idle_share"] == 1.0
    assert result["profile"]["wall_ms"] > 0


def test_evaluate_cli_prints_its_json_line(root, trained, capsys):
    tmp, _, _ = trained
    argv = ["--root", root, "--device", "cpu", "--model_path", str(tmp / "ckpt"),
            "--gl_iters", "2"]
    for o in OVERRIDES:
        argv += ["--override", o]
    score = eval_cli.main(argv)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"dataset": "LRW", "n_clips": 2, "estoi": score} and np.isfinite(score)
    with pytest.raises(FileNotFoundError):
        eval_cli.main(["--root", root, "--device", "cpu", "--model_path", str(tmp / "nope.ckpt")])


def test_schedules_match_jax():
    from lip2speech_tpu.train import schedules as jschedules

    ours, theirs = schedules.polynomial_decay(1e-3, 100), jschedules.polynomial_decay(1e-3, 100)
    for c in (0, 1, 50, 99, 100, 150):
        assert ours(c) == pytest.approx(float(theirs(c)), rel=1e-6)
    a, b = schedules.ReduceOnPlateau(patience=1), jschedules.ReduceOnPlateau(patience=1)
    for m in (3.0, 2.0, 2.5, 2.5, 2.6, 1.0, 1.5, 1.5):
        assert a.update(m) == b.update(m)
    w = torch.nn.Parameter(torch.ones(3))
    opt, sched = schedules.adam_poly([w], 1e-2, 10)
    for _ in range(4):
        opt.zero_grad()
        w.sum().backward()
        opt.step()
        sched.step()
    assert opt.param_groups[0]["lr"] == pytest.approx(schedules.polynomial_decay(1e-2, 10)(4))


class FakeWriter:
    """``torch.utils.tensorboard.SummaryWriter``'s calls, recorded."""

    def __init__(self, log_dir):
        os.makedirs(log_dir)
        self.calls = []

    def __getattr__(self, name):
        return lambda *a, **k: self.calls.append(name)


@pytest.mark.parametrize("tensorboard", ["absent", "present"])
def test_metric_logger(tmp_path, monkeypatch, tensorboard):
    if tensorboard == "present":
        fake = type(sys)("torch.utils.tensorboard")
        fake.SummaryWriter = FakeWriter
        monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake)
    logger = logging_utils.MetricLogger(str(tmp_path))
    assert (logger.tb is None) == (tensorboard == "absent")
    rec = logger.scalars(3, {"loss": torch.tensor(2.5)})
    assert rec["loss"] == 2.5 and {"step", "time", "step_time"} <= set(rec)
    stats = logger.histograms(3, {"w": torch.tensor([1.0, float("nan"), 3.0])})
    assert stats["param/w"]["nonfinite"] == 1
    logger.images(3, mel_pred=np.random.rand(8, 5), attention=torch.rand(5, 4), gate=np.zeros(5))
    logger.console(3, {"loss": 2.5}, total_steps=10)
    if tensorboard == "present":
        assert logger.tb.calls == ["add_scalar", "add_histogram", "add_image", "add_image"]
    logger.close()
    assert {"metrics.jsonl", "histograms.jsonl", "mel_predicted_3.png", "alignment_3.png",
            "gate_3.png"} <= set(os.listdir(tmp_path))
    assert os.path.isdir(tmp_path / "tb") == (tensorboard == "present")


def test_profile_steps_captures_the_host():
    with logging_utils.profile_steps() as prof:
        torch.ones(4) @ torch.ones(4)
    assert any("matmul" in e.key or "dot" in e.key for e in prof.key_averages())


def test_train_cli_needs_a_root_and_defaults_to_cuda():
    with pytest.raises(SystemExit):
        train_cli.parse_args([])
    args = train_cli.parse_args(["--root", "x"])
    assert args.device == "cuda"
    # the JAX CLI's parallel flags, with its defaults
    assert (args.multihost, args.data_parallel, args.model_parallel) == (False, -1, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_cli.train(args, dataclasses.replace(Config()))
