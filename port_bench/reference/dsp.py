"""The plain reference of the port's DSP, in plain PyTorch and NumPy.

The log-mel spectrogram of the training targets, and mel -> waveform: the
log de-normalisation, the NNLS inversion of the HTK mel filterbank (a
pseudo-inverse start, then multiplicative updates) and Griffin-Lim
(torchaudio's update rule, momentum folded as mom / (1 + mom), phases as
(cos, sin) pairs, each STFT and ISTFT a real DFT product, ``center=True``
with reflect padding and a periodic Hann window). ``transform`` rounds the
operands of the loop's transforms and their results, as a product in the
serving type does; the last ISTFT is f32.

This file imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.precision import exact


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def filterbank(a: dict) -> np.ndarray:
    """HTK triangles with norm=None, (n_freqs, n_mels)."""
    n_freqs = a["n_fft"] // 2 + 1
    freqs = np.linspace(0.0, a["sample_rate"] / 2.0, n_freqs)
    f_pts = mel_to_hz(np.linspace(hz_to_mel(a["fmin"]), hz_to_mel(a["fmax"]), a["n_mels"] + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def hann(n: int, device) -> torch.Tensor:
    return torch.as_tensor(0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n)), dtype=torch.float32,
                           device=device)


def dft_basis(n_fft: int, device) -> torch.Tensor:
    """(n_fft, 2 * n_freqs): frames @ basis = [re | im]."""
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = -2.0 * np.pi * t * k / n_fft
    return torch.as_tensor(np.concatenate([np.cos(ang), np.sin(ang)], 1), dtype=torch.float32, device=device)


def idft_basis(n_fft: int, device) -> torch.Tensor:
    """(2 * n_freqs, n_fft): [re | im] @ basis = frames."""
    nf = n_fft // 2 + 1
    k = np.arange(nf)[:, None]
    t = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * k * t / n_fft
    w = np.full((nf, 1), 2.0)
    w[0] = 1.0
    w[-1] = 1.0
    return torch.as_tensor(np.concatenate([w * np.cos(ang), -w * np.sin(ang)], 0) / n_fft,
                           dtype=torch.float32, device=device)


def frames(x, n_fft, hop):
    pad = n_fft // 2
    lead = x.shape[:-1]
    x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect").reshape(*lead, -1)
    t = (x.shape[-1] - n_fft) // hop + 1
    return x.unfold(-1, n_fft, hop)[..., :t, :]


def stft(x, a, q=exact, out=exact):
    """(real, imag), each (..., n_freqs, T)."""
    n = a["n_fft"]
    fr = frames(x, n, a["hop_length"]) * hann(n, x.device)
    both = out(torch.matmul(q(fr), q(dft_basis(n, x.device))))
    nf = n // 2 + 1
    return both[..., :nf].transpose(-1, -2), both[..., nf:].transpose(-1, -2)


def istft(re, im, a, length, q=exact, out=exact):
    n, hop = a["n_fft"], a["hop_length"]
    win = hann(n, re.device)
    fr = out(torch.matmul(q(torch.cat([re, im], -2).transpose(-1, -2)), q(idft_basis(n, re.device)))) * win
    t = fr.shape[-2]
    total = (t - 1) * hop + n
    y = fr.new_zeros((*fr.shape[:-2], total))
    norm = fr.new_zeros(total)
    for i in range(t):
        y[..., i * hop:i * hop + n] += fr[..., i, :]
        norm[i * hop:i * hop + n] += win * win
    y = y / torch.clamp(norm, min=1e-11)
    return y[..., n // 2:n // 2 + length]


def melspectrogram(wav, a):
    """Waveform (B, S) -> log-mel (B, n_mels, T), f32."""
    re, im = stft(wav, a)
    power = re * re + im * im
    fb = torch.as_tensor(filterbank(a), device=wav.device)
    return torch.log(torch.clamp(torch.einsum("bft,fm->bmt", power, fb), min=a["clip_val"]))


def mel_to_linear(mel_power, a, iters, q=exact):
    fb_np = filterbank(a)
    fb = torch.as_tensor(fb_np, device=mel_power.device)
    pinv = torch.as_tensor(np.linalg.pinv(fb_np), device=mel_power.device)
    x = torch.clamp(torch.matmul(q(pinv.t()), q(mel_power)), min=0.0)
    num = torch.matmul(q(fb), q(mel_power))
    gram = fb @ fb.t()
    for _ in range(iters):
        x = x * (num + 1e-10) / (torch.matmul(q(gram), q(x)) + 1e-10)
    return x


def mel_to_audio(log_mel, a, theta, n_iter, nnls_iters, q=exact, transform=exact):
    """Log-mel (B, n_mels, T) -> waveform (B, (T - 1) * hop), from the
    initial phases ``theta`` (B, n_freqs, T)."""
    mag = torch.sqrt(torch.clamp(mel_to_linear(torch.exp(log_mel.float()), a, nnls_iters, q), min=1e-30))
    T = mag.shape[-1]
    n_samples = (T - 1) * a["hop_length"]
    ang_re, ang_im = torch.cos(theta), torch.sin(theta)
    mom = 0.99 / 1.99
    tp_re = torch.zeros_like(mag)
    tp_im = torch.zeros_like(mag)

    def rounded(x):
        return transform(q(x))

    for _ in range(n_iter):
        inv = istft(mag * ang_re, mag * ang_im, a, n_samples, rounded, transform)
        rb_re, rb_im = stft(inv, a, rounded, transform)
        rb_re, rb_im = rb_re[..., :T], rb_im[..., :T]
        new_re, new_im = rb_re - tp_re * mom, rb_im - tp_im * mom
        norm = torch.clamp(torch.sqrt(new_re ** 2 + new_im ** 2), min=1e-16)
        ang_re, ang_im, tp_re, tp_im = new_re / norm, new_im / norm, rb_re, rb_im
    return istft(mag * ang_re, mag * ang_im, a, n_samples, q)


def uniform_phases(shape, generator, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device) * (2 * math.pi) - math.pi
