"""The benchmark's plain reference against the port at a small size on the
CPU, in f32, and its operation counter against the closed form of the AR
loop's work."""

from __future__ import annotations

import json
import math
import os

import pytest
import torch

from port_bench.harness import flops, spec, weights
from port_bench.loops import infer_closed, train_staged
from port_bench.reference import dsp, precision
from port_bench.reference.model import Ctx
from port_bench.reference.train import normalize_face, normalize_mouth
from port_bench.tests.tiny import tiny_cell


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(name: str) -> dict:
    with open(os.path.join(spec.BENCH_DIR, "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("config,B,M", [("lrw", 4, 300), ("lrw", 256, 300), ("wild", 32, 126)])
def test_ar_loop_count_is_the_closed_form(config, B, M):
    conf = _config(config)
    T = conf["data"]["max_video_frames"]
    counted = flops.ar_loop_flops(conf["model"], B, T, M)
    closed, _ = flops.ar_decode_work(conf["model"], B, T, flops.codebook_slots(T), M, 2)
    assert counted == closed


def test_reference_forward_matches_the_port():
    cell = tiny_cell("lrw.offline_b256")
    conf, t = cell.config, cell.traffic
    dev = torch.device("cpu")
    cfg = spec.port_config(conf)
    model = infer_closed.build_model(cfg, conf, 5, dev, torch.float32)
    ref = infer_closed.reference_model(conf, 5, dev, torch.float32)
    pool = infer_closed.make_pool(conf, t, 5, dev)
    e = pool[0]
    video = normalize_mouth(e["mouth"])
    faces = normalize_face(e["faces"])
    with torch.no_grad():
        out = model(video, faces, gumbel=e["gumbel"])
        r = ref.infer(Ctx(), video, faces, e["gumbel"])
    for k in ("speaker_embedding", "content_dist", "mel", "mel_postnet", "gate"):
        err = float((out[k].float() - r[k]).abs().max() / r[k].abs().max())
        assert err < 1e-5, (k, err)
    assert torch.equal(out["lengths"], r["lengths"])


def test_reference_dsp_matches_the_port():
    from lip2speech_torch.config import AudioConfig
    from lip2speech_torch.ops.griffin_lim import mel_to_audio
    from lip2speech_torch.ops.mel import melspectrogram

    a = _config("lrw")["audio"]
    g = torch.Generator().manual_seed(3)
    wav = torch.randn(2, 4096, generator=g) * 0.1
    ref_mel = dsp.melspectrogram(wav, a)
    assert float((melspectrogram(wav, AudioConfig()) - ref_mel).abs().max()) < 1e-4
    theta = (torch.rand(2, 513, ref_mel.shape[-1], generator=g) * 2 - 1) * math.pi
    prog = mel_to_audio(ref_mel, AudioConfig(), n_iter=4, theta=theta)
    ref = dsp.mel_to_audio(ref_mel, a, theta, 4, 16)
    assert float((prog - ref).norm() / ref.norm()) < 1e-4


def test_reference_train_step_matches_the_port():
    """Three f32 steps of the port against the reference's, by the same
    numbers the benchmark compares."""
    cell = tiny_cell("lrw.train_b64")
    conf, t = cell.config, cell.traffic
    dev = torch.device("cpu")
    cfg = spec.port_config(conf)
    pool = train_staged.make_pool(conf, t, 9, dev)
    state = train_staged.build_state(cfg, conf, 9, dev)
    prog = train_staged.first_steps(state, cfg, pool, dev, t, infer_closed.Tracer())
    ref = train_staged.reference_steps(conf, t, 9, dev, pool)
    r = train_staged.readings_of(prog, ref)
    assert r["loss_rel"] < 1e-4 and r["grad_gap"] < 1e-3 and r["stats_gap"] < 1e-3, r
    assert r["change_gap"] < 0.05, r


def test_weights_load_into_both_models_strictly():
    conf = _config("lrw")
    sd = weights.state_dict(conf["model"], 11, torch.device("cpu"), torch.bfloat16)
    again = weights.state_dict(conf["model"], 11, torch.device("cpu"), torch.bfloat16)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    from lip2speech_torch.models.lip2speech import Lip2Speech

    with torch.device("meta"):
        model = Lip2Speech(spec.port_config(conf).model)
    model.load_state_dict(sd, strict=True, assign=True)
    assert sum(v.numel() for k, v in sd.items() if v.is_floating_point()) == 62375256


@pytest.mark.parametrize("name", ["fp8", "bf16"])
def test_a_rounding_rounds_the_gradient_too(name):
    q = getattr(precision, name)
    x = torch.linspace(-3.0, 3.0, 97, requires_grad=True)
    g = torch.linspace(0.01, 7.3, 97) ** 1.7
    q(x).backward(g)
    assert torch.equal(x.grad, q(g.clone())) and not torch.equal(x.grad, g)
