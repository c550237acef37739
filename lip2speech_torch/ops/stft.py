"""STFT / ISTFT as real DFT matrix products (PyTorch).

Counterpart of ``lip2speech_tpu/ops/stft.py``. The DFT stays a
product with a real (cos | sin) basis rather than an FFT so the CPU parity
with the JAX package stays tight; on the GPU these are large plain matrix
products. Conventions match ``torch.stft`` with center=True, reflect
padding, a periodic Hann window, no normalisation, onesided. Spectrogram
layout is ``(..., n_freqs, n_frames)``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Periodic Hann window (``torch.hann_window(periodic=True)``)."""
    n = np.arange(win_length)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))
    return torch.as_tensor(w, dtype=dtype, device=device)


def _pad_window(window: torch.Tensor, n_fft: int) -> torch.Tensor:
    win_length = window.shape[0]
    if win_length == n_fft:
        return window
    left = (n_fft - win_length) // 2
    return F.pad(window, (left, n_fft - win_length - left))


def frame_signal(x: torch.Tensor, n_fft: int, hop_length: int,
                 center: bool = True) -> torch.Tensor:
    """Slice ``x (..., n_samples)`` into overlapping frames ``(..., T, n_fft)``."""
    lead = x.shape[:-1]
    if center:
        pad = n_fft // 2
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
        x = x.reshape(*lead, x.shape[-1])
    n_samples = x.shape[-1]
    t = (n_samples - n_fft) // hop_length + 1
    return x.unfold(-1, n_fft, hop_length)[..., :t, :]


@functools.lru_cache(maxsize=8)
def _dft_matrix(n_fft: int) -> np.ndarray:
    """[cos | sin] forward real-DFT basis, (n_fft, 2 * n_freqs)."""
    n_freqs = n_fft // 2 + 1
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_freqs)[None, :]
    ang = -2.0 * np.pi * t * k / n_fft
    return np.concatenate([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _idft_matrix(n_fft: int) -> np.ndarray:
    """[[C], [S]] inverse real-DFT basis, (2 * n_freqs, n_fft):
    time = re @ C + im @ S."""
    n_freqs = n_fft // 2 + 1
    k = np.arange(n_freqs)[:, None]
    t = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * k * t / n_fft
    w = np.full((n_freqs, 1), 2.0)
    w[0] = 1.0
    if n_fft % 2 == 0:
        w[-1] = 1.0
    c = w * np.cos(ang) / n_fft
    s = -w * np.sin(ang) / n_fft
    return np.concatenate([c, s], axis=0).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _basis(n_fft: int, inverse: bool, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The DFT basis on ``device``, made once: a host copy per call would
    move 4 MB for every transform of the Griffin-Lim loop."""
    m = _idft_matrix(n_fft) if inverse else _dft_matrix(n_fft)
    return torch.tensor(m, device=device).to(dtype)


def _flat_matmul(x: torch.Tensor, n_fft: int, inverse: bool, compute_dtype) -> torch.Tensor:
    """``x (..., K) @ basis (K, N)`` with the leading dims flattened; returns
    f32. With ``compute_dtype`` set, the product runs in that type (its
    result is rounded to it before the cast back to f32)."""
    lead = x.shape[:-1]
    dtype = compute_dtype or torch.float32
    w = _basis(n_fft, inverse, x.device, dtype)
    return (x.reshape(-1, x.shape[-1]).to(dtype) @ w).float().reshape(*lead, w.shape[-1])


def stft_matmul(x: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
                win_length: int | None = None, window: torch.Tensor | None = None,
                center: bool = True, compute_dtype=None):
    """Returns (real, imag), each ``(..., n_freqs, T)``."""
    win_length = win_length or n_fft
    if window is None:
        window = hann_window(win_length, x.device, x.dtype)
    window = _pad_window(window, n_fft)
    frames = frame_signal(x, n_fft, hop_length, center) * window
    n_freqs = n_fft // 2 + 1
    both = _flat_matmul(frames, n_fft, False, compute_dtype)
    re, im = both[..., :n_freqs], both[..., n_freqs:]
    return re.transpose(-1, -2), im.transpose(-1, -2)


def stft(x: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
         win_length: int | None = None) -> torch.Tensor:
    """Complex STFT of ``x (..., n_samples)`` -> ``(..., n_freqs, T)``."""
    return torch.complex(*stft_matmul(x, n_fft, hop_length, win_length))


def spectrogram(x: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
                win_length: int | None = None) -> torch.Tensor:
    """Power spectrogram ``(..., n_freqs, T)`` (``stft.py:141-156``)."""
    re, im = stft_matmul(x, n_fft, hop_length, win_length)
    return re * re + im * im


def _overlap_add(frames: torch.Tensor, hop_length: int, n_fft: int) -> torch.Tensor:
    """Overlap-add ``(..., T, n_fft)`` -> ``(..., (T-1)*hop + n_fft)``."""
    *batch, t, _ = frames.shape
    out_len = (t - 1) * hop_length + n_fft
    if n_fft % hop_length == 0:
        # piece j of frame i lands at offset (i + j) * hop: k shifted adds
        k = n_fft // hop_length
        chunks = frames.reshape(*batch, t, k, hop_length)
        out = frames.new_zeros((*batch, t + k - 1, hop_length))
        for j in range(k):
            out[..., j:j + t, :] += chunks[..., :, j, :]
        return out.reshape(*batch, (t + k - 1) * hop_length)[..., :out_len]
    idx = (np.arange(t)[:, None] * hop_length + np.arange(n_fft)[None, :]).reshape(-1)
    out = frames.new_zeros((*batch, out_len))
    idx_t = torch.as_tensor(idx, device=frames.device)
    return out.index_add_(-1, idx_t, frames.reshape(*batch, -1))


def istft_matmul(re: torch.Tensor, im: torch.Tensor, n_fft: int = 1024,
                 hop_length: int = 256, win_length: int | None = None,
                 window: torch.Tensor | None = None, center: bool = True,
                 length: int | None = None, compute_dtype=None) -> torch.Tensor:
    """Inverse STFT of (real, imag) ``(..., n_freqs, T)`` pairs with
    window-square overlap-add normalisation."""
    win_length = win_length or n_fft
    if window is None:
        window = hann_window(win_length, re.device)
    window = _pad_window(window, n_fft)
    both = torch.cat([re.transpose(-1, -2), im.transpose(-1, -2)], dim=-1)
    frames = _flat_matmul(both, n_fft, True, compute_dtype) * window
    y = _overlap_add(frames, hop_length, n_fft)

    t = re.shape[-1]
    norm = _overlap_add((window * window).expand(t, n_fft), hop_length, n_fft)
    y = y / torch.clamp(norm, min=1e-11)
    if center:
        pad = n_fft // 2
        y = y[..., pad:]
        if length is None:
            y = y[..., : y.shape[-1] - pad]
    if length is not None:
        y = y[..., :length]
    return y
