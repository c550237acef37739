"""Mel filterbank and mel -> linear inversion (PyTorch).

Counterpart of ``lip2speech_tpu/ops/mel.py``: the HTK filterbank with
norm=None (torchaudio's ``melscale_fbanks``), the log-mel spectrogram of
the training targets and the power mel of the speaker encoder
(``mel.py:57-88``), the log de-normalisation, and the
NNLS inversion of the mel projection (pseudo-inverse warm start, then
multiplicative updates, ``mel.py:91-120``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lip2speech_torch.config import AudioConfig
from lip2speech_torch.ops.stft import spectrogram


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int, fmin: float,
                   fmax: float) -> np.ndarray:
    """Triangular HTK filterbank, ``(n_freqs, n_mels)``; returned read-only."""
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    f_pts = mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up)).astype(np.float32)
    fb.setflags(write=False)
    return fb


@functools.lru_cache(maxsize=8)
def _filterbank_on(cfg: AudioConfig, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(filterbank (n_freqs, n_mels), its pseudo-inverse (n_mels, n_freqs))
    on ``device``, made once."""
    fb = mel_filterbank(cfg.n_freqs, cfg.n_mels, cfg.sample_rate, cfg.fmin, cfg.fmax)
    return torch.tensor(fb, device=device), torch.tensor(np.linalg.pinv(fb), device=device)


def log_compress(x: torch.Tensor, clip_val: float = 1e-5) -> torch.Tensor:
    """``spectral_normalize``: log(clamp(x, min=clip_val))."""
    return torch.log(torch.clamp(x, min=clip_val))


def melspectrogram(waveform: torch.Tensor, cfg: AudioConfig = AudioConfig(),
                   log: bool = True) -> torch.Tensor:
    """Waveform ``(..., n_samples)`` -> log-mel ``(..., n_mels, T)``: frame,
    windowed DFT product, power, mel product, log clamp. ``log=False``
    returns the power mel (the speaker encoder's input)."""
    power = spectrogram(waveform, cfg.n_fft, cfg.hop_length, cfg.win_length)
    fb, _ = _filterbank_on(cfg, waveform.device)
    mel = torch.einsum("...ft,fm->...mt", power, fb)
    return log_compress(mel, cfg.clip_val) if log else mel


def log_decompress(x: torch.Tensor) -> torch.Tensor:
    """``spectral_de_normalize``: exp(x)."""
    return torch.exp(x)


def mel_to_linear(mel_power: torch.Tensor, cfg: AudioConfig = AudioConfig(),
                  n_nnls_iters: int = 16) -> torch.Tensor:
    """``(..., n_mels, T)`` mel power -> ``(..., n_freqs, T)`` linear power:
    solve ``min ||fb^T x - mel||^2, x >= 0`` from a pseudo-inverse start with
    ``x <- x * (fb @ mel) / (fb @ fb^T @ x)``."""
    fb, pinv = _filterbank_on(cfg, mel_power.device)

    x = torch.clamp(torch.einsum("mf,...mt->...ft", pinv, mel_power), min=0.0)
    eps = 1e-10
    num = torch.einsum("fm,...mt->...ft", fb, mel_power)
    gram = fb @ fb.T
    for _ in range(n_nnls_iters):
        denom = torch.einsum("fg,...gt->...ft", gram, x)
        x = x * (num + eps) / (denom + eps)
    return x
