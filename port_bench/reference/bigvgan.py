"""The plain reference of the BigVGAN generator, in plain PyTorch f32.

From the equations of arXiv:2206.04658 and the published v1 generator
(github.com/NVIDIA/BigVGAN, ``configs/bigvgan_22khz_80band.json``):

    x = conv_pre(mel)                                      k7, pad 3
    for each stage i:
        x = ConvTranspose1d_i(x)                           stride u_i, kernel k_i, pad (k_i - u_i) / 2
        x = mean over k of AMP_k(x)
    signal = conv_post(act(x)), waveform = tanh(signal)    k7, pad 3, with bias
    AMP_k(x): for each dilation d, x = x + conv2(act(conv1_d(act(x))))
    act(x) = down(snake(up(x)))
    snake(x) = x + sin^2(exp(log_alpha) x) / (exp(log_beta) + 1e-9)

``up`` doubles the rate: the signal, replicate-padded by 5 samples a side,
is zero-stuffed to twice its rate and convolved with twice the 12-tap
kaiser-sinc low-pass h (cutoff 0.25, half width 0.3, beta 0.1102 (A - 8.7)
with A = 2.285 * 5 * pi * 1.2 + 7.95, taps at t = -6..5 + 0.5, summing to
1), and the 2L samples from offset 15 are kept. ``down`` replicate-pads by
(5, 6), filters with h at the full rate and keeps every other sample. A
transposed convolution is written as the zero-stuffed input convolved with
the flipped, transposed kernel.

The parameters carry the published checkpoint's names (``conv_pre``,
``ups.<i>.0``, ``resblocks.<j>.convs1|convs2.<n>``,
``resblocks.<j>.activations.<n>.act.alpha|beta``, ``activation_post``,
``conv_post``) in plain convolution modules, so torch's ``weight_norm`` can
wrap them; ``signal`` reads their ``weight`` and computes with functions.
``q`` rounds every product's operands (``precision.exact``, or ``fp8`` for
the control). TF32 is off inside ``signal``; the rows run in blocks.

This file imports nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from port_bench.harness.runtime import no_tf32
from port_bench.reference.precision import exact

TAPS = 12


def lowpass_taps(device=None) -> torch.Tensor:
    """h: the 12-tap kaiser-sinc low-pass at cutoff 0.25, f32."""
    a = 2.285 * (TAPS // 2 - 1) * math.pi * (4 * 0.3) + 7.95
    beta = 0.1102 * (a - 8.7)
    n = torch.arange(TAPS, dtype=torch.float64)
    window = torch.special.i0(beta * torch.sqrt(1 - (2 * n / (TAPS - 1) - 1) ** 2)) / torch.special.i0(
        torch.tensor(beta, dtype=torch.float64))
    t = n - TAPS // 2 + 0.5
    h = 0.5 * window * torch.sinc(0.5 * t)
    return (h / h.sum()).float().to(device)


class _Snake(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))


class _Act(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.act = _Snake(channels)


class _AMP(nn.Module):
    def __init__(self, c: int, k: int, dilations):
        super().__init__()
        self.k, self.dilations = k, tuple(dilations)
        self.convs1 = nn.ModuleList(nn.Conv1d(c, c, k) for _ in dilations)
        self.convs2 = nn.ModuleList(nn.Conv1d(c, c, k) for _ in dilations)
        self.activations = nn.ModuleList(_Act(c) for _ in range(2 * len(dilations)))


class BigVGANReference(nn.Module):
    def __init__(self, v: dict, n_mels: int = 80):
        super().__init__()
        c0 = v["upsample_initial_channel"]
        self.rates, self.kernels = list(v["upsample_rates"]), list(v["upsample_kernel_sizes"])
        self.n_k = len(v["resblock_kernel_sizes"])
        self.conv_pre = nn.Conv1d(n_mels, c0, 7)
        self.ups = nn.ModuleList(nn.ModuleList([nn.ConvTranspose1d(c0 >> i, c0 >> (i + 1), k, u)])
                                 for i, (u, k) in enumerate(zip(self.rates, self.kernels)))
        self.resblocks = nn.ModuleList(_AMP(c0 >> (i + 1), k, d) for i in range(len(self.rates))
                                       for k, d in zip(v["resblock_kernel_sizes"], v["resblock_dilation_sizes"]))
        ch = c0 >> len(self.rates)
        self.activation_post = _Act(ch)
        self.conv_post = nn.Conv1d(ch, 1, 7)

    @torch.no_grad()
    def signal(self, mel: torch.Tensor, q=exact, rows: int = 128) -> torch.Tensor:
        """(B, n_mels, M) -> (B, M * prod(rates)) before the tanh, in f32,
        ``rows`` rows at a time."""
        with no_tf32():
            return torch.cat([self._signal(mel[i:i + rows].float(), q) for i in range(0, mel.shape[0], rows)])

    def waveform(self, mel: torch.Tensor, q=exact, rows: int = 128) -> torch.Tensor:
        return torch.tanh(self.signal(mel, q, rows))

    def _signal(self, mel, q):
        h = lowpass_taps(mel.device)
        x = conv(mel, self.conv_pre, 1, q)
        for i, (u, k) in enumerate(zip(self.rates, self.kernels)):
            x = conv_transpose(x, self.ups[i][0], u, (k - u) // 2, q)
            blocks = self.resblocks[i * self.n_k:(i + 1) * self.n_k]
            x = sum(amp(x, b, h, q) for b in blocks) / self.n_k
        return conv(act(x, self.activation_post.act, h, q), self.conv_post, 1, q)[:, 0]


def conv(x, m: nn.Conv1d, dilation: int, q):
    """Same-length convolution of an odd kernel at ``dilation``."""
    k = m.weight.shape[-1]
    return F.conv1d(q(x), q(m.weight), m.bias, padding=dilation * (k - 1) // 2, dilation=dilation)


def conv_transpose(x, m: nn.ConvTranspose1d, stride: int, padding: int, q):
    """The transposed convolution as a convolution of the zero-stuffed input."""
    w = m.weight  # (in, out, k)
    k = w.shape[-1]
    z = x.new_zeros(*x.shape[:2], (x.shape[-1] - 1) * stride + 1)
    z[..., ::stride] = x
    z = F.pad(z, (k - 1 - padding, k - 1 - padding))
    return F.conv1d(q(z), q(w.transpose(0, 1).flip(-1)), m.bias)


def fir(x, h, q):
    """x filtered with h along time, each channel alone (valid part)."""
    c = x.shape[1]
    return F.conv1d(q(x), q(h).view(1, 1, -1).expand(c, 1, -1), groups=c)


def act(x, snake: _Snake, h, q):
    length = x.shape[-1]
    xp = F.pad(x, (5, 5), mode="replicate")
    z = x.new_zeros(*x.shape[:2], 2 * xp.shape[-1] - 1)
    z[..., ::2] = xp
    up = 2 * fir(F.pad(z, (TAPS - 1, TAPS - 1)), h.flip(0), q)[..., 15:15 + 2 * length]
    a, b = snake.alpha.exp()[None, :, None], snake.beta.exp()[None, :, None]
    y = up + torch.sin(up * a) ** 2 / (b + 1e-9)
    return fir(F.pad(y, (5, 6), mode="replicate"), h, q)[..., ::2]


def amp(x, block: _AMP, h, q):
    acts = block.activations
    for n, d in enumerate(block.dilations):
        xt = conv(act(x, acts[2 * n].act, h, q), block.convs1[n], d, q)
        xt = conv(act(xt, acts[2 * n + 1].act, h, q), block.convs2[n], 1, q)
        x = x + xt
    return x
