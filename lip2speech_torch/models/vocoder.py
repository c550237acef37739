"""The mel -> waveform stage: Griffin-Lim or BigVGAN, picked by ``cfg.vocoder``.

BigVGAN is Lee et al., "BigVGAN: A Universal Neural Vocoder with
Large-Scale Training" (arXiv:2206.04658): the generator of
github.com/NVIDIA/BigVGAN (``bigvgan.py``, ``activations.py``,
``alias_free_torch``), at the widths of its
``configs/bigvgan_22khz_80band.json`` by default (``config.VocoderConfig``;
112M parameters). It takes the port's log-mel as the port makes it: 80
bands, hop 256 (the product of the upsampling rates), the natural log
clipped at 1e-5.

    x = conv_pre(mel)                                 Conv1d n_mels -> C, k7
    for each stage i:
        x = ups[i](x)                                 ConvTranspose1d C_i -> C_i / 2, stride u_i
        x = mean over k of AMPBlock1(C_i / 2, k)(x)   k in resblock_kernel_sizes
    x = tanh(conv_post(Activation1d(SnakeBeta)(x)))   Conv1d C -> 1, k7

``AMPBlock1``: for each dilation d, ``x = x + conv2(act2(conv1_d(act1(x))))``.
``Activation1d``: a 2x upsample by a 12-tap kaiser-sinc FIR (replicate
padding), the activation, a 12-tap low-pass and a 2x downsample.
SnakeBeta(x) = x + 1 / (exp(beta) + 1e-9) * sin^2(exp(alpha) * x).

Where this departs from the published code:
- Inference only. The convolutions hold plain weights: weight norm is
  folded into them when a checkpoint loads (``weights.fold_bigvgan``).
- The anti-aliasing filters are computed at construction, as buffers that
  the state dict does not hold; the loader checks a checkpoint's filters
  against them and drops them.
- v1's generator only: AMPBlock1 with SnakeBeta on a log scale, a bias on
  ``conv_post`` and ``tanh`` at the end. v2's options (``use_tanh_at_final``,
  ``use_bias_at_final``, the fused CUDA activation) are not taken.
- Every operation runs in the module's type, the filters and SnakeBeta's
  parameters included (bf16 when the module is served in bf16).

Spans (``utils/trace.py``): ``vocoder.forward`` around the generator,
``vocoder.upsample`` around ``conv_pre`` and each transposed conv,
``vocoder.amp`` around each AMP conv with its residual add, each sum of
the blocks and each mean, and ``vocoder.activation`` around each
``Activation1d``. No span's own kernels bracket another's: the profiler
stamps a range on the device from its first own kernel to its last, so a
span around a whole stage would also cover the activations inside it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from lip2speech_torch.config import Config, VocoderConfig
from lip2speech_torch.ops.griffin_lim import mel_to_audio
from lip2speech_torch.utils import trace

FIR_TAPS = 12
RATIO = 2


def kaiser_beta(half_width: float, kernel_size: int) -> float:
    """The Kaiser window's beta for the filter's attenuation (Kaiser's rule)."""
    a = 2.285 * (kernel_size // 2 - 1) * math.pi * 4 * half_width + 7.95
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a >= 21.0:
        return 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> torch.Tensor:
    """The windowed-sinc low-pass of ``alias_free_torch/filter.py``, (K,) f32
    on the CPU, normalised to sum 1."""
    half = kernel_size // 2
    window = torch.kaiser_window(kernel_size, periodic=False, beta=kaiser_beta(half_width, kernel_size),
                                 device="cpu")
    if kernel_size % 2 == 0:
        t = torch.arange(-half, half, device="cpu") + 0.5
    else:
        t = torch.arange(kernel_size, device="cpu") - half
    taps = 2 * cutoff * window * torch.sinc(2 * cutoff * t)
    return taps / taps.sum()


class SnakeBeta(nn.Module):
    """x + 1 / (beta + 1e-9) * sin^2(alpha * x), per channel; the
    parameters hold log alpha and log beta (``snake_logscale``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha, beta = self.alpha[None, :, None].exp(), self.beta[None, :, None].exp()
        return x + (1.0 / (beta + 1e-9)) * torch.sin(x * alpha).pow(2)


class Activation1d(nn.Module):
    """The anti-aliased activation: 2x upsample, ``act``, 2x downsample."""

    def __init__(self, act: nn.Module):
        super().__init__()
        self.act = act
        taps = kaiser_sinc_filter1d(0.5 / RATIO, 0.6 / RATIO, FIR_TAPS).view(1, 1, FIR_TAPS)
        self.register_buffer("up_filter", taps, persistent=False)
        self.register_buffer("down_filter", taps.clone(), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with trace.span("vocoder.activation"):
            c = x.shape[1]
            pad = FIR_TAPS // RATIO - 1
            cut = pad * RATIO + (FIR_TAPS - RATIO) // 2
            x = F.pad(x, (pad, pad), mode="replicate")
            x = RATIO * F.conv_transpose1d(x, self.up_filter.expand(c, -1, -1), stride=RATIO, groups=c)
            x = self.act(x[..., cut:-cut])
            x = F.pad(x, (FIR_TAPS // 2 - 1, FIR_TAPS // 2), mode="replicate")
            return F.conv1d(x, self.down_filter.expand(c, -1, -1), stride=RATIO, groups=c)


class AMPBlock1(nn.Module):
    """Three dilated residual units, each act -> conv (dilation d) -> act
    -> conv (dilation 1), every act anti-aliased SnakeBeta."""

    def __init__(self, channels: int, kernel_size: int, dilation):
        super().__init__()
        k = kernel_size
        self.convs1 = nn.ModuleList(nn.Conv1d(channels, channels, k, 1, dilation=d, padding=d * (k - 1) // 2)
                                    for d in dilation)
        self.convs2 = nn.ModuleList(nn.Conv1d(channels, channels, k, 1, padding=(k - 1) // 2) for _ in dilation)
        self.activations = nn.ModuleList(Activation1d(SnakeBeta(channels))
                                         for _ in range(2 * len(dilation)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acts = self.activations
        for c1, c2, a1, a2 in zip(self.convs1, self.convs2, acts[::2], acts[1::2]):
            xt = a1(x)
            with trace.span("vocoder.amp"):
                xt = c1(xt)
            xt = a2(xt)
            with trace.span("vocoder.amp"):
                x = x + c2(xt)
        return x


class BigVGAN(nn.Module):
    """The generator: (B, n_mels, M) log-mel -> (B, 1, M * prod(rates))
    waveform in [-1, 1]; ``signal`` is the same before the ``tanh``."""

    def __init__(self, v: VocoderConfig = VocoderConfig(), n_mels: int = 80):
        super().__init__()
        c0 = v.upsample_initial_channel
        self.num_kernels = len(v.resblock_kernel_sizes)
        self.conv_pre = nn.Conv1d(n_mels, c0, 7, 1, padding=3)
        self.ups = nn.ModuleList(
            nn.ModuleList([nn.ConvTranspose1d(c0 // 2 ** i, c0 // 2 ** (i + 1), k, u, padding=(k - u) // 2)])
            for i, (u, k) in enumerate(zip(v.upsample_rates, v.upsample_kernel_sizes)))
        self.resblocks = nn.ModuleList(
            AMPBlock1(c0 // 2 ** (i + 1), k, d)
            for i in range(len(self.ups))
            for k, d in zip(v.resblock_kernel_sizes, v.resblock_dilation_sizes))
        ch = c0 // 2 ** len(self.ups)
        self.activation_post = Activation1d(SnakeBeta(ch))
        self.conv_post = nn.Conv1d(ch, 1, 7, 1, padding=3)

    def signal(self, mel: torch.Tensor) -> torch.Tensor:
        with trace.span("vocoder.upsample"):
            x = self.conv_pre(mel)
        n = self.num_kernels
        for i, ups in enumerate(self.ups):
            with trace.span("vocoder.upsample"):
                for up in ups:
                    x = up(x)
            xs = self.resblocks[i * n](x)
            for block in self.resblocks[i * n + 1:(i + 1) * n]:
                y = block(x)
                with trace.span("vocoder.amp"):
                    xs = xs + y
            with trace.span("vocoder.amp"):
                x = xs / n
        return self.conv_post(self.activation_post(x))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        with trace.span("vocoder.forward"):
            return torch.tanh(self.signal(mel))


@torch.no_grad()
def init_bigvgan_(model: BigVGAN, generator: torch.Generator) -> BigVGAN:
    """Random weights in place: every conv U(+-1/sqrt(in * k)), biases 0,
    SnakeBeta's log alpha and log beta 0."""
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
            bound = 1.0 / math.sqrt(m.in_channels * m.kernel_size[0])
            m.weight.copy_(torch.rand(m.weight.shape, generator=generator) * (2 * bound) - bound)
            m.bias.zero_()
        elif isinstance(m, SnakeBeta):
            m.alpha.zero_()
            m.beta.zero_()
    return model


def build_vocoder(cfg: Config, device, dtype=torch.float32, checkpoint=None) -> BigVGAN | None:
    """The mel -> waveform stage's module on ``device`` in ``dtype``, in
    eval mode: None for ``griffin_lim``; for ``bigvgan`` the generator with
    ``checkpoint``'s weights (a BigVGAN checkpoint's path or its generator
    state dict, weight norm folded by ``weights.fold_bigvgan``) or, without
    one, random weights from ``cfg.train.seed`` (``init_bigvgan_``)."""
    if cfg.vocoder.kind == "griffin_lim":
        return None
    from lip2speech_torch import weights

    with torch.device(device):
        model = BigVGAN(cfg.vocoder, cfg.audio.n_mels)
    if checkpoint is None:
        init_bigvgan_(model, torch.Generator().manual_seed(cfg.train.seed))
    else:
        model.load_state_dict(weights.fold_bigvgan(checkpoint, model), strict=True)
    return model.to(device=device, dtype=dtype).eval()


def mel_to_waveform(log_mel: torch.Tensor, cfg: Config, vocoder: BigVGAN | None = None, *,
                    n_iter: int = 32, compute_dtype=None, generator: torch.Generator | None = None,
                    theta: torch.Tensor | None = None) -> torch.Tensor:
    """Log-mel ``(..., n_mels, M)`` -> waveform through the stage
    ``cfg.vocoder`` names. ``griffin_lim``: ``ops.griffin_lim.mel_to_audio``
    with ``n_iter``, ``compute_dtype``, ``generator`` and ``theta``,
    ``(M - 1) * hop`` samples. ``bigvgan``: ``vocoder`` (``build_vocoder``)
    in its own type, with no gradient, ``M * hop`` samples, f32."""
    if cfg.vocoder.kind == "griffin_lim":
        return mel_to_audio(log_mel, cfg.audio, n_iter=n_iter, compute_dtype=compute_dtype,
                            generator=generator, theta=theta)
    if vocoder is None:
        raise ValueError("vocoder.kind=bigvgan needs the generator: build it with build_vocoder")
    dtype = vocoder.conv_pre.weight.dtype
    lead = log_mel.shape[:-2]
    with torch.no_grad():
        wav = vocoder(log_mel.reshape(-1, *log_mel.shape[-2:]).to(dtype))
    return wav.reshape(*lead, wav.shape[-1]).float()
