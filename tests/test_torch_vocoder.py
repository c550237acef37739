"""The port's BigVGAN vocoder (``models/vocoder.py``) on the CPU.

- A small generator (initial channel 64, the published rates, kernels and
  dilations; 232,529 parameters) against the benchmark's plain reference
  (``port_bench/reference/bigvgan.py``, written from the equations) on the
  same weights: in f32 to 1e-5 (measured ~1.2e-07 relative L2 a clip), in
  bf16 within ``BF16_REL`` (measured ~5.4e-03; the reference computed with
  float8 operands reads ~4e-02 at this size).
- The anti-aliasing filter, ``Activation1d`` on a ramp, the output length.
- A checkpoint written with torch's weight norm (both namings) loads
  through ``weights.fold_bigvgan`` and gives the reference's output.
- ``evaluate_net`` and ``synthesize_long_video`` under
  ``vocoder.kind=bigvgan``; with the default config the waveform is Griffin-
  Lim's, bit for bit, and the CLIs' ``--override vocoder.*`` and
  ``--vocoder_checkpoint``.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import pytest
import torch

from lip2speech_torch import data as tdata
from lip2speech_torch import weights
from lip2speech_torch.cli import common as cli_common
from lip2speech_torch.config import AudioConfig, Config, TrainConfig, VocoderConfig, config_with_overrides
from lip2speech_torch.eval import evaluate, long_video
from lip2speech_torch.models.lip2speech import Lip2Speech, init_random_
from lip2speech_torch.models.vocoder import (Activation1d, BigVGAN, build_vocoder, init_bigvgan_, kaiser_beta,
                                             kaiser_sinc_filter1d, mel_to_waveform)
from lip2speech_torch.ops.griffin_lim import mel_to_audio
from port_bench.reference.bigvgan import BigVGANReference, lowpass_taps
from torch_port_common import small_configs
from torch_port_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = VocoderConfig(kind="bigvgan", upsample_initial_channel=64)
HOP = 256
F32_REL = 1e-5
# bf16 operands and activations through 6 stages of 18 activations and 36
# convs: ~0.5% a clip measured; float8 (the next type down) reads ~4%
BF16_REL = 2e-2


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst row's relative L2 gap."""
    got, want = got.double().flatten(1), want.double().flatten(1)
    return float(((got - want).norm(dim=1) / want.norm(dim=1)).max())


def pair(v: VocoderConfig = SMALL, seed: int = 0) -> tuple[BigVGAN, BigVGANReference]:
    """The port's generator and the reference on the same weights, every
    parameter moved off its start (biases, log alpha and log beta too)."""
    port = init_bigvgan_(BigVGAN(v), torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for n, p in port.named_parameters():
            if not n.endswith(".weight"):
                p.copy_(0.2 * torch.randn(p.shape, generator=g))
    ref = BigVGANReference(dataclasses.asdict(v))
    ref.load_state_dict(port.state_dict(), strict=True)
    return port.eval(), ref


def log_mel(B: int, M: int, seed: int = 3) -> torch.Tensor:
    return torch.randn(B, 80, M, generator=torch.Generator().manual_seed(seed)) * 2 - 6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generator_matches_the_reference(dtype):
    port, ref = pair()
    mel = log_mel(2, 8)
    want = ref.signal(mel)
    with torch.no_grad():
        got = port.to(getattr(torch, dtype)).signal(mel.to(getattr(torch, dtype)))[:, 0]
        wav = port(mel.to(got.dtype))[:, 0]
    assert got.shape == want.shape == (2, 8 * HOP)
    assert rel(got, want) < (F32_REL if dtype == "float32" else BF16_REL)
    assert torch.equal(wav, torch.tanh(got))


def test_filter_taps():
    taps = kaiser_sinc_filter1d(0.25, 0.3, 12)
    assert taps.shape == (12,) and taps.dtype == torch.float32
    assert torch.equal(taps, taps.flip(0))
    assert abs(float(taps.double().sum()) - 1.0) < 1e-6
    assert abs(kaiser_beta(0.3, 12) - 4.6638) < 1e-3
    assert float((taps - lowpass_taps()).abs().max()) < 1e-7


@pytest.mark.parametrize("length", [1, 7, 40])
def test_activation_keeps_lengths_and_a_ramp(length):
    """With the identity in the middle the anti-aliased activation keeps the
    length, a constant everywhere (replicate padding) and a ramp away from
    its first and last 5 samples; at the edges the padding bends the ramp by
    under 4% of a step."""
    act = Activation1d(torch.nn.Identity()).double()
    ramp = torch.arange(length, dtype=torch.float64).view(1, 1, -1).expand(2, 3, -1)
    out = act(ramp)
    assert out.shape == ramp.shape
    assert float((act(torch.full_like(ramp, 3.0)) - 3.0).abs().max()) < 1e-6
    gap = (out - ramp).abs()
    assert float(gap.max()) < 0.04
    if length > 10:
        assert float(gap[..., 5:-5].max()) < 1e-5 * length


@pytest.mark.parametrize("lead", [(), (2,), (2, 1)])
def test_output_length_is_m_hops(lead):
    port, _ = pair()
    cfg = Config(vocoder=SMALL)
    for M in (1, 5):
        mel = log_mel(int(np.prod(lead or (1,))), M).reshape(*lead, 80, M)
        with torch.no_grad():
            wav = mel_to_waveform(mel, cfg, port)
        assert wav.shape == (*lead, M * HOP) and wav.dtype == torch.float32


@pytest.mark.parametrize("naming", ["weight_norm", "parametrizations"])
def test_a_weight_normed_checkpoint_loads(naming, tmp_path):
    _, ref = pair(seed=7)
    mel = log_mel(2, 4, seed=8)
    want = ref.waveform(mel)
    norm = torch.nn.utils.weight_norm if naming == "weight_norm" else torch.nn.utils.parametrizations.weight_norm
    for m in list(ref.modules()):
        if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)):
            norm(m)
    sd = ref.state_dict()
    assert any(k.endswith(("weight_g", "original0")) for k in sd)
    taps = lowpass_taps().view(1, 1, -1)
    for name, m in ref.named_modules():
        if name.endswith(("activations.0", "activations.5")) or name == "activation_post":
            sd[f"{name}.upsample.filter"] = taps
            sd[f"{name}.downsample.lowpass.filter"] = taps
    path = str(tmp_path / "g_00000000")
    torch.save({"generator": sd}, path)
    cfg = Config(vocoder=SMALL)
    with torch.no_grad():
        got = mel_to_waveform(mel, cfg, build_vocoder(cfg, "cpu", checkpoint=path))
    assert rel(got, want) < F32_REL
    sd["activation_post.upsample.filter"] = taps * 1.5
    with pytest.raises(ValueError, match="filter"):
        weights.fold_bigvgan(sd, BigVGAN(SMALL))


def _small_cfg(**vocoder) -> Config:
    _, tc = small_configs(max_decoder_steps=80)
    return Config(model=tc, train=TrainConfig(bf16=False),
                  vocoder=dataclasses.replace(SMALL, **vocoder) if vocoder else VocoderConfig())


@pytest.fixture(scope="module")
def lrw(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lrw_vocoder"))
    tdata.make_sample_lrw(root, n_clips=2)
    return root


def test_evaluate_with_bigvgan(lrw):
    cfg = _small_cfg(kind="bigvgan")
    model = init_random_(Lip2Speech(cfg.model), torch.Generator().manual_seed(0))
    ds = tdata.get_dataset("LRW", lrw, mode="test", cfg=cfg.data)
    port, ref = pair()
    stats = {}
    score = evaluate.evaluate_net(model, ds, cfg, batch_size=2, max_batches=1, seed=1, stats=stats,
                                  vocoder=port)
    assert np.isfinite(score) and -1.0 <= score <= 1.0 and stats["batches"] == 1
    program = evaluate.eval_program(model, cfg, 32, "estoi", port)
    mel = log_mel(2, 6)
    assert rel(program.invert(mel, None, None), ref.waveform(mel)) < F32_REL
    assert program is evaluate.eval_program(model, cfg, 32, "estoi", port)
    with pytest.raises(ValueError, match="build_vocoder"):
        evaluate.evaluate_net(model, ds, cfg, batch_size=2, max_batches=1)


def test_long_video_with_bigvgan():
    cfg = _small_cfg(kind="bigvgan")
    model = init_random_(Lip2Speech(cfg.model), torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    video = rng.randn(40, 48, 48, 3).astype(np.float32)  # two chunks
    faces = rng.randn(2, 80, 80, 3).astype(np.float32)
    port, ref = pair()
    with torch.no_grad():
        wav, mel = long_video.synthesize_long_video(model, video, faces, cfg, torch.device("cpu"),
                                                    torch.Generator().manual_seed(1), compute_dtype=None,
                                                    vocoder=port)
    assert wav.shape == (mel.shape[1] * HOP,)
    assert rel(torch.from_numpy(wav)[None], ref.waveform(torch.from_numpy(mel)[None])) < F32_REL


def test_the_default_config_keeps_griffin_lim_bit_for_bit():
    cfg = Config()
    assert cfg.vocoder.kind == "griffin_lim" and build_vocoder(cfg, "cpu") is None
    mel = log_mel(2, 12)
    theta = (torch.rand(2, cfg.audio.n_freqs, 12, generator=torch.Generator().manual_seed(4)) * 2 - 1) * np.pi
    want = mel_to_audio(mel, AudioConfig(), n_iter=4, theta=theta)
    assert torch.equal(mel_to_waveform(mel, cfg, n_iter=4, theta=theta), want)
    model = init_random_(Lip2Speech(_small_cfg().model), torch.Generator().manual_seed(0))
    program = evaluate.eval_program(model, _small_cfg(), 4, "estoi")
    assert program.vocoder is None
    assert torch.equal(program.invert(mel, theta, None), want)
    gen = torch.Generator().manual_seed(9)
    assert torch.equal(mel_to_waveform(mel, cfg, n_iter=2, compute_dtype=torch.bfloat16, generator=gen),
                       mel_to_audio(mel, AudioConfig(), n_iter=2, compute_dtype=torch.bfloat16,
                                    generator=torch.Generator().manual_seed(9)))


def test_override_and_checkpoint_flag():
    args = cli_common.add_common_args(argparse.ArgumentParser()).parse_args(
        ["--root", "unused", "--device", "cpu", "--override", "vocoder.kind=bigvgan",
         "--override", "vocoder.upsample_initial_channel=64", "--override",
         "vocoder.resblock_dilation_sizes=[[1, 3, 5], [1, 3, 5], [1, 3, 5]]"])
    cfg = cli_common.common_config(args)
    assert cfg.vocoder == SMALL and hash(cfg) == hash(Config(vocoder=SMALL))
    assert isinstance(cli_common.load_vocoder(cfg, args.vocoder_checkpoint, torch.device("cpu")), BigVGAN)
    with pytest.raises(ValueError, match="vocoder.kind=bigvgan"):
        cli_common.load_vocoder(Config(), "g_00000000", torch.device("cpu"))
    with pytest.raises(ValueError, match="vocoder.kind"):
        config_with_overrides("vocoder.kind=hifigan")
