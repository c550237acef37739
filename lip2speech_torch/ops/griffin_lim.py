"""Griffin-Lim phase reconstruction and mel -> waveform (PyTorch).

Counterpart of ``lip2speech_tpu/ops/griffin_lim.py``: torchaudio's update
rule with momentum folded as ``mom / (1 + mom)``, phases kept as (cos, sin)
pairs, every STFT/ISTFT a real DFT product. ``compute_dtype`` applies to
the loop's transforms; the final ISTFT runs in f32. The initial phase
``theta`` can be handed in, so a test gives both packages the same draw;
otherwise it comes from ``generator``.
"""

from __future__ import annotations

import math

import torch

from lip2speech_torch.config import AudioConfig
from lip2speech_torch.ops import mel as mel_ops
from lip2speech_torch.ops import stft as stft_ops
from lip2speech_torch.parallel.dist import uniform


def griffin_lim(specgram: torch.Tensor, cfg: AudioConfig = AudioConfig(),
                n_iter: int = 256, power: float = 2.0, momentum: float = 0.99,
                rand_init: bool = True, generator: torch.Generator | None = None,
                theta: torch.Tensor | None = None, length: int | None = None,
                compute_dtype=None) -> torch.Tensor:
    """``(..., n_freqs, T)`` nonnegative spectrogram -> ``(..., n_samples)``."""
    magnitude = torch.pow(torch.clamp(specgram, min=1e-30), 1.0 / power)
    window = stft_ops.hann_window(cfg.win_length, magnitude.device)

    if theta is None and rand_init:
        theta = uniform(magnitude.shape, generator, magnitude.device) * (2 * math.pi) - math.pi
    if theta is not None:
        ang_re, ang_im = torch.cos(theta), torch.sin(theta)
    else:
        ang_re, ang_im = torch.ones_like(magnitude), torch.zeros_like(magnitude)

    t_frames = magnitude.shape[-1]
    n_samples = (t_frames - 1) * cfg.hop_length  # ISTFT(center) of T frames
    mom = momentum / (1.0 + momentum)
    tp_re = torch.zeros_like(magnitude)
    tp_im = torch.zeros_like(magnitude)
    for _ in range(n_iter):
        inverse = stft_ops.istft_matmul(
            magnitude * ang_re, magnitude * ang_im, cfg.n_fft, cfg.hop_length,
            cfg.win_length, window, length=n_samples, compute_dtype=compute_dtype,
        )
        rb_re, rb_im = stft_ops.stft_matmul(
            inverse, cfg.n_fft, cfg.hop_length, cfg.win_length, window,
            compute_dtype=compute_dtype,
        )
        rb_re, rb_im = rb_re[..., :t_frames], rb_im[..., :t_frames]
        new_re = rb_re - tp_re * mom
        new_im = rb_im - tp_im * mom
        norm = torch.clamp(torch.sqrt(new_re ** 2 + new_im ** 2), min=1e-16)
        ang_re, ang_im, tp_re, tp_im = new_re / norm, new_im / norm, rb_re, rb_im
    wav = stft_ops.istft_matmul(
        magnitude * ang_re, magnitude * ang_im, cfg.n_fft, cfg.hop_length,
        cfg.win_length, window, length=n_samples,
    )
    if length is not None:
        wav = wav[..., :length]
    return wav


def mel_to_audio(log_mel: torch.Tensor, cfg: AudioConfig = AudioConfig(),
                 n_iter: int = 256, nnls_iters: int = 16, compute_dtype=None,
                 generator: torch.Generator | None = None,
                 theta: torch.Tensor | None = None) -> torch.Tensor:
    """Log-mel ``(..., n_mels, T)`` -> waveform: de-normalise, NNLS mel
    inversion, Griffin-Lim (reference spectograms.py:92-95)."""
    linear = mel_ops.mel_to_linear(mel_ops.log_decompress(log_mel.float()), cfg, nnls_iters)
    return griffin_lim(linear, cfg, n_iter=n_iter, power=2.0, generator=generator,
                       theta=theta, compute_dtype=compute_dtype)
