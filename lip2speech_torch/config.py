"""Frozen configuration for the PyTorch port.

The port's own copy of the dataclasses that ``lip2speech_tpu/config.py``
defines, with the same defaults, so one ``Config`` value describes the same
model to both packages. The sections the port reads are kept: audio,
model, data and train.
"""

from __future__ import annotations

import ast
import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """DSP parameters (reference hparams.py:32-38)."""

    sample_rate: int = 16000
    n_fft: int = 1024
    win_length: int = 1024
    hop_length: int = 256
    n_mels: int = 80
    fmin: float = 0.0
    fmax: float = 8000.0
    # log-compression clip value; log(1e-5) is also the mel pad value
    clip_val: float = 1e-5

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def log_pad_value(self) -> float:
        return math.log(self.clip_val)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model dimensions (reference hparams.py:46-73 + module constants)."""

    frontend_channels: int = 24
    shufflenet_width: float = 1.0
    video_feature_dim: int = 768
    face_embedding_dim: int = 256
    facenet_embedding_dim: int = 512
    encoder_embedding_dim: int = 1024
    n_mels: int = 80
    ffn_hidden_dim: int = 512
    n_decoder_layers: int = 2
    max_decoder_steps: int = 300
    gate_threshold: float = 0.5
    prenet_dropout: float = 0.2
    decoder_rnn_dropout: float = 0.1
    attention_dropout: float = 0.1
    encoder_feature_dropout: float = 0.1
    content_vocab_size: int = 501
    content_latent_dim: int = 256
    gumbel_tau: float = 0.1
    postnet_embedding_dim: int = 512
    postnet_kernel_size: int = 5
    postnet_n_convolutions: int = 5
    postnet_dropout: float = 0.5
    max_encoder_positions: int = 200
    scan_grad_clip: float = 0.0
    content_grad_clip: float = 0.0
    discriminator_patch: int = 32
    speaker_mel_bins: int = 40
    speaker_lstm_dim: int = 256
    speaker_lstm_layers: int = 3


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Static-shape input geometry (LRW: 29 frames, ~77 mel steps)."""

    max_video_frames: int = 29
    max_mel_frames: int = 80
    max_audio_samples: int = 20224
    mouth_size: Tuple[int, int] = (96, 96)
    face_size: Tuple[int, int] = (160, 160)
    n_face_crops: int = 2
    mel_pad_value: float = -11.5129
    mouth_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    mouth_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimisation (reference hparams.py:77-85, train.py:88-160). The
    fields and defaults of the JAX package's ``TrainConfig``; the schedule,
    logging and adversarial fields are kept so one override string serves
    both packages."""

    learning_rate: float = 1e-4
    weight_decay: float = 1e-6
    grad_clip: float = 1.0
    batch_size: int = 64
    seed: int = 1234
    max_iters: int = 6_400_000
    eval_interval: int = 2000
    log_interval: int = 50
    tf_ratio_start: float = 0.1
    tf_ratio_step: float = 0.1
    tf_ratio_epochs: int = 10
    postnet_loss_weight: float = 10.0
    # weight of the content-quantiser KLD term in the total (the logged
    # KLD stays unweighted)
    kld_weight: float = 1.0
    # forward on bf16 copies of f32 master weights
    bf16: bool = True
    # mel MSE over valid frames only; False averages over padding too, as
    # the reference does
    masked_loss: bool = False
    # skip (zero) an update with a non-finite gradient, never give up
    skip_nonfinite_updates: bool = True
    max_consecutive_nonfinite: int = 100
    # skip an update whose raw global gradient norm exceeds this; 0 = off
    reject_grad_norm_above: float = 0.0
    adversarial: bool = False
    adversarial_critic_lr: float = 5e-5


@dataclasses.dataclass(frozen=True)
class Config:
    audio: AudioConfig = dataclasses.field(default_factory=AudioConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


def config_with_overrides(*overrides: str) -> Config:
    """Build a Config with dotted-path overrides, e.g.
    ``config_with_overrides("train.learning_rate=3e-4", "model.ffn_hidden_dim=256")``."""
    cfg = Config()
    groups: dict[str, dict] = {}
    for ov in overrides:
        path, _, raw = ov.partition("=")
        section, _, field_name = path.partition(".")
        if not field_name or not hasattr(cfg, section):
            raise ValueError(f"bad override {ov!r}")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        groups.setdefault(section, {})[field_name] = value
    kw = {s: dataclasses.replace(getattr(cfg, s), **f) for s, f in groups.items()}
    return dataclasses.replace(cfg, **kw)
