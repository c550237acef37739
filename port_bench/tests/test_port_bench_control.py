"""The comparison that decides ``correct`` fails what it has to fail.

On the CPU at a small size: a run with the timed path broken underneath
comes out not correct under the cell's own limits, once for each fault a
cell can have (an answer altered where it is produced; half of the batch
left out, the mean taken over the rest; a step that leaves its state
unchanged); and the control (the reference computed in float8, in the
program's place) fails the limits. On the card (``cuda``): the control at
the cell's own size.
"""

from __future__ import annotations

import importlib
import time

import pytest
import torch

from port_bench import calibrate, run
from port_bench.harness import runtime, spec
from port_bench.harness.compare import verdict
from port_bench.loops import train_staged
from port_bench.tests.tiny import cell_limits, tiny_cell

CPU = torch.device("cpu")
INFER, TRAIN = "lrw.offline_b256", "lrw.train_b64"


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_run(name: str):
    cell = tiny_cell(name, limits=cell_limits(name))
    rec, _, _, _ = run.run_cell(cell, 4242, 0.3, False, CPU, time.time())
    return rec


@pytest.mark.parametrize("name", [INFER, TRAIN])
def test_a_sound_tiny_run_is_correct(name):
    assert tiny_run(name).correct


def test_an_altered_waveform_fails(monkeypatch):
    import lip2speech_torch.ops.griffin_lim as gl

    real = gl.mel_to_audio

    def altered(*args, **kw):
        wav = real(*args, **kw)
        wav[0] = 0.5 * wav[0]
        return wav

    monkeypatch.setattr(gl, "mel_to_audio", altered)
    rec = tiny_run(INFER)
    assert not rec.correct and rec.checks["wav_sc_gap"]["value"] > rec.checks["wav_sc_gap"]["limit"]


def test_an_altered_mel_fails(monkeypatch):
    import lip2speech_torch.models.decoder as decoder

    real = decoder.ar_decode

    def altered(*args, **kw):
        mels, stops, attn = real(*args, **kw)
        return mels + 0.05 * (torch.arange(mels.shape[1]) == 0).view(1, -1, 1), stops, attn

    monkeypatch.setattr(decoder, "ar_decode", altered)
    rec = tiny_run(INFER)
    assert not rec.correct and rec.checks["mel_rms"]["value"] > rec.checks["mel_rms"]["limit"]


def test_half_of_a_request_left_out_fails(monkeypatch):
    from lip2speech_torch.models.lip2speech import Lip2Speech

    real = Lip2Speech.forward

    def halved(self, video, faces=None, **kw):
        h = video.shape[0] // 2
        out = real(self, video[:h].repeat(2, *[1] * (video.ndim - 1)), faces[:h].repeat(2, 1, 1, 1, 1), **kw)
        return out

    monkeypatch.setattr(Lip2Speech, "forward", halved)
    assert not tiny_run(INFER).correct


def test_a_step_that_leaves_the_state_unchanged_fails(monkeypatch):
    from lip2speech_torch.data.collate import prepare_batch, to_device
    from lip2speech_torch.train.train_step import forward_losses

    def frozen(state, cfg, entry, dev, tf_ratio, tracer):
        batch = prepare_batch(to_device(entry["raw"], dev), cfg.audio, cfg.data)
        _, losses, _ = forward_losses(state, batch, tf_ratio, cfg, draws=entry["draws"])
        return {"total": losses["total"].detach(), "grad_norm": torch.zeros(()),
                "notfinite_count": torch.zeros((), dtype=torch.int32)}

    monkeypatch.setattr(train_staged, "program_step", frozen)
    rec = tiny_run(TRAIN)
    assert not rec.correct and rec.checks["change_gap"]["value"] > 0.99


def test_half_of_the_batch_left_out_fails(monkeypatch):
    real = train_staged.program_step

    def halved(state, cfg, entry, dev, tf_ratio, tracer):
        half = entry["raw"]["audio"].shape[0] // 2
        d = dict(entry["draws"])
        for k in ("prenet", "attention", "rnn"):
            d[k] = d[k][:, :half]
        d["postnet"] = [x[:half] for x in d["postnet"]]
        d["encoder"] = d["encoder"][:half]
        d["gumbel"] = d["gumbel"][:half * (d["gumbel"].shape[0] // (2 * half))]
        return real(state, cfg, {"raw": {k: v[:half] for k, v in entry["raw"].items()}, "draws": d}, dev,
                    tf_ratio, tracer)

    monkeypatch.setattr(train_staged, "program_step", halved)
    assert not tiny_run(TRAIN).correct


def test_an_altered_loss_fails(monkeypatch):
    ts = importlib.import_module("lip2speech_torch.train.train_step")  # the package exports a function of that name

    real = ts.lip2speech_loss

    def altered(*args, **kw):
        losses = real(*args, **kw)
        losses["total"] = losses["total"] * 1.05
        return losses

    monkeypatch.setattr(ts, "lip2speech_loss", altered)
    assert not tiny_run(TRAIN).correct


@pytest.mark.parametrize("name", [INFER, TRAIN])
def test_the_control_fails_the_limits(name):
    cell = tiny_cell(name, precision="bfloat16", limits=cell_limits(name))
    if cell.traffic["kind"] == "infer_closed":
        readings, _ = calibrate.control_infer(cell, 31, CPU)
    else:
        readings, _ = calibrate.control_train(cell, 31, CPU, "fp8")
    assert not verdict(readings, cell.limits)[0], readings


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lrw.offline_b256", "lrw.interactive_b4", "wild.train_b64", "lrw.train_b64"])
def test_the_control_fails_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control runs at the cell's own size")
    cell = spec.load_cell(name)
    runtime.require_chips(cell.chips)
    dev = torch.device("cuda", 0)
    for seed in (101, 102, 103):
        with runtime.no_tf32():
            if cell.traffic["kind"] == "infer_closed":
                readings, _ = calibrate.control_infer(cell, seed, dev)
            else:
                readings, _ = calibrate.control_train(cell, seed, dev, "fp8")
        assert not verdict(readings, cell.limits)[0], readings
