"""(E)STOI speech-intelligibility metrics.

Counterpart of ``lip2speech_tpu/ops/estoi.py``, after Taal et al. 2011
(STOI) and Jensen & Taal 2016 (ESTOI) in pystoi 0.3.3's structure: resample
to 10 kHz, drop frames more than 40 dB below the loudest, 512-point spectra
of 256-sample Hann frames at hop 128, 15 one-third-octave bands from 150 Hz,
segments of 30 frames. pystoi frames with ``range(0, len - 256, 128)``,
which leaves out a last frame that ends exactly at the signal's end; this
copy does the same, since the reference's scores come from pystoi.

- :func:`estoi` / :func:`stoi`: numpy in float64 on the host, the exact
  metrics.
- :func:`estoi_batch` / :func:`stoi_batch`: torch on the batch's device,
  static shapes: the same polyphase resampler (scipy's ``resample_poly``
  filter as one convolution), silent frames cut out by stably compacting
  the kept frames to the front, overlap-adding and framing again, spectra
  as a DFT product. They compute in float64, as the host metrics do (the
  JAX package's batched metric computes in float32).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal import firwin, resample_poly

FS = 10000
N_FRAME = 256
HOP = 128
NFFT = 512
NUM_BANDS = 15
MIN_FREQ = 150.0
N_SEG = 30
DYN_RANGE = 40.0
BETA = -15.0  # STOI's lower SDR clipping bound, dB (Taal 2011, II-C)
EPS = np.finfo(np.float64).eps


@functools.lru_cache(maxsize=1)
def third_octave_matrix() -> np.ndarray:
    """(NUM_BANDS, NFFT//2+1) one-third-octave band matrix at 10 kHz."""
    f = np.linspace(0, FS, NFFT, endpoint=False)[: NFFT // 2 + 1]
    k = np.arange(NUM_BANDS)
    lo = MIN_FREQ * 2.0 ** ((2 * k - 1) / 6.0)
    hi = MIN_FREQ * 2.0 ** ((2 * k + 1) / 6.0)
    obm = np.zeros((NUM_BANDS, len(f)))
    for i in range(NUM_BANDS):
        obm[i, np.argmin((f - lo[i]) ** 2): np.argmin((f - hi[i]) ** 2)] = 1.0
    obm.setflags(write=False)
    return obm


def _window() -> np.ndarray:
    return np.hanning(N_FRAME + 2)[1:-1]


def _resample_10k(x: np.ndarray, fs: int) -> np.ndarray:
    if fs == FS:
        return x
    g = np.gcd(int(fs), FS)
    return resample_poly(x, FS // g, fs // g)


def _frames(x: np.ndarray) -> np.ndarray:
    """pystoi's frames: starts in range(0, len(x) - N_FRAME, HOP)."""
    rem = len(x) - N_FRAME
    n = (rem + HOP - 1) // HOP if rem > 0 else 0
    if n <= 0:
        return np.zeros((0, N_FRAME))
    return x[np.arange(n)[:, None] * HOP + np.arange(N_FRAME)[None, :]]


def _remove_silent(x: np.ndarray, y: np.ndarray):
    """Drop the frames of x quieter than its loudest minus 40 dB, and the
    same frames of y; overlap-add both back to signals."""
    w = _window()
    xf = _frames(x) * w
    yf = _frames(y) * w
    energy = 20 * np.log10(np.linalg.norm(xf, axis=1) + EPS)
    mask = energy > (np.max(energy) - DYN_RANGE)
    xf, yf = xf[mask], yf[mask]
    n = len(xf)
    out_len = (n - 1) * HOP + N_FRAME if n else 0
    xs = np.zeros(out_len)
    ys = np.zeros(out_len)
    for i in range(n):
        xs[i * HOP: i * HOP + N_FRAME] += xf[i]
        ys[i * HOP: i * HOP + N_FRAME] += yf[i]
    return xs, ys


def _band_env(x: np.ndarray) -> np.ndarray:
    """signal -> (NUM_BANDS, n_frames) one-third-octave envelopes."""
    spec = np.fft.rfft(_frames(x) * _window(), NFFT, axis=1)
    return np.sqrt(third_octave_matrix() @ (np.abs(spec) ** 2).T)


def _row_col_normalize(seg: np.ndarray) -> np.ndarray:
    """seg (..., N, J): normalise the rows (last axis), then the columns."""
    s = seg - np.mean(seg, axis=-1, keepdims=True)
    s = s / (np.linalg.norm(s, axis=-1, keepdims=True) + EPS)
    s = s - np.mean(s, axis=-2, keepdims=True)
    return s / (np.linalg.norm(s, axis=-2, keepdims=True) + EPS)


def _host_band_envelopes(clean, denoised, fs):
    """Trim to the shorter signal, resample, cut silence, band envelopes:
    (xb, yb), each (NUM_BANDS, frames)."""
    clean = np.asarray(clean, np.float64)
    denoised = np.asarray(denoised, np.float64)
    n = min(len(clean), len(denoised))
    x, y = _remove_silent(_resample_10k(clean[:n], fs), _resample_10k(denoised[:n], fs))
    return _band_env(x), _band_env(y)


def estoi(clean: np.ndarray, denoised: np.ndarray, fs: int = 16000) -> float:
    """Extended STOI of ``denoised`` against ``clean``; about [-1, 1]."""
    xb, yb = _host_band_envelopes(clean, denoised, fs)
    nf = xb.shape[1]
    if nf < N_SEG:
        return 1e-5  # pystoi's not-enough-frames value
    segs_x = np.stack([xb[:, m - N_SEG: m].T for m in range(N_SEG, nf + 1)])
    segs_y = np.stack([yb[:, m - N_SEG: m].T for m in range(N_SEG, nf + 1)])
    xn = _row_col_normalize(np.swapaxes(segs_x, 1, 2))  # (M, J, N)
    yn = _row_col_normalize(np.swapaxes(segs_y, 1, 2))
    return float(np.mean(np.sum(xn * yn, axis=(-1, -2)) / N_SEG))


def stoi(clean: np.ndarray, denoised: np.ndarray, fs: int = 16000) -> float:
    """STOI of ``denoised`` against ``clean``: per segment and band, the
    degraded envelope scaled to the clean energy and clipped at the +15 dB
    SDR bound, then correlated over time."""
    xb, yb = _host_band_envelopes(clean, denoised, fs)
    nf = xb.shape[1]
    if nf < N_SEG:
        return 1e-5
    segs_x = np.stack([xb[:, m - N_SEG: m] for m in range(N_SEG, nf + 1)])  # (M, J, N)
    segs_y = np.stack([yb[:, m - N_SEG: m] for m in range(N_SEG, nf + 1)])
    alpha = np.linalg.norm(segs_x, axis=2, keepdims=True) / (
        np.linalg.norm(segs_y, axis=2, keepdims=True) + EPS)
    y_prime = np.minimum(alpha * segs_y, segs_x * (1 + 10 ** (-BETA / 20)))
    xc = segs_x - np.mean(segs_x, axis=2, keepdims=True)
    yc = y_prime - np.mean(y_prime, axis=2, keepdims=True)
    xc = xc / (np.linalg.norm(xc, axis=2, keepdims=True) + EPS)
    yc = yc / (np.linalg.norm(yc, axis=2, keepdims=True) + EPS)
    return float(np.mean(np.sum(xc * yc, axis=2)))


# ---------------------------------------------------------------------------
# Batched, static shapes, on the batch's device
# ---------------------------------------------------------------------------

UP, DOWN = 5, 8  # 16 kHz -> 10 kHz
HALF_LEN = 10 * max(UP, DOWN)


@functools.lru_cache(maxsize=8)
def _constants(device: torch.device) -> dict:
    """Resampler taps, window, DFT basis and band matrix on ``device``."""
    # scipy's resample_poly filter: 2 * 10 * max(up, down) + 1 taps, cutoff
    # 1 / max(up, down), kaiser(5.0), gain up
    taps = firwin(2 * HALF_LEN + 1, 1.0 / max(UP, DOWN), window=("kaiser", 5.0)) * UP
    n = np.arange(N_FRAME)[:, None]
    k = np.arange(NFFT // 2 + 1)[None, :]
    ang = 2 * np.pi * n * k / NFFT  # a frame's 256 samples, zero-padded to NFFT
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1)  # (256, 2 * 257)

    def put(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=torch.float64, device=device)

    return {"taps": put(taps[::-1].copy())[None, None], "window": put(_window()),
            "basis": put(basis), "obm": put(third_octave_matrix())}


def _resample(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """(B, S) at 16 kHz -> (B, ceil(5 S / 8)) at 10 kHz, as ``resample_poly``."""
    B, S = x.shape
    up = torch.zeros(B, S * UP, dtype=x.dtype, device=x.device)
    up[:, ::UP] = x
    y = F.conv1d(F.pad(up, (HALF_LEN, HALF_LEN))[:, None], taps)[:, 0]
    return y[:, ::DOWN]


def _power_spectrum(frames: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """(..., 256) windowed frames -> (..., 257) power of their NFFT-point DFT."""
    z = frames @ basis
    re, im = z[..., : NFFT // 2 + 1], z[..., NFFT // 2 + 1:]
    return re * re + im * im


def _ola_reframe(frames: torch.Tensor) -> torch.Tensor:
    """(B, F, 256) frames at hop 128 -> overlap-added and framed again at
    the same hop: frame j is half-blocks j and j + 1 of the sum."""
    first, second = frames[:, :, :HOP], frames[:, :, HOP:]
    blocks = first.clone()
    blocks[:, 1:] += second[:, :-1]
    buf = torch.cat([blocks, second[:, -1:]], dim=1)  # (B, F + 1, 128)
    return torch.cat([buf[:, :-1], buf[:, 1:]], dim=-1)


def _batch_band_envelopes(clean, denoised, lengths, fs: int):
    """(xb, yb, n_keep, nfr): band envelopes (B, NUM_BANDS, nfr) in
    float64, the kept frames of each clip, and the static frame count.
    ``lengths`` (B,) are the valid samples of each row; frames past them
    count as dropped."""
    if fs * UP != FS * DOWN:
        raise ValueError(f"the batched resampler takes 16 kHz input, got {fs}")
    c = _constants(clean.device)
    x = _resample(clean.double(), c["taps"])
    y = _resample(denoised.double(), c["taps"])
    nfr = max((x.shape[1] - N_FRAME + HOP - 1) // HOP, 0)
    xf = x.unfold(1, N_FRAME, HOP)[:, :nfr] * c["window"]  # (B, nfr, 256)
    yf = y.unfold(1, N_FRAME, HOP)[:, :nfr] * c["window"]

    energy = 20.0 * torch.log10(torch.linalg.vector_norm(xf, dim=-1) + 1e-20)
    frame_ok = energy > (energy.max(dim=1, keepdim=True).values - DYN_RANGE)
    starts = torch.arange(nfr, device=x.device)
    if lengths is not None:
        res_len = (lengths.to(x.device).long() * UP + DOWN - 1) // DOWN
        frame_ok = frame_ok & ((starts[None, :] * HOP + N_FRAME) < res_len[:, None])

    # cut the dropped frames out with static shapes: kept frames first, in order
    order = torch.argsort((~frame_ok).to(torch.int8), dim=1, stable=True)
    n_keep = frame_ok.sum(dim=1)
    live = (starts[None, :] < n_keep[:, None])[..., None]
    xf = torch.take_along_dim(xf, order[:, :, None], dim=1) * live
    yf = torch.take_along_dim(yf, order[:, :, None], dim=1) * live
    xr = _ola_reframe(xf) * c["window"]
    yr = _ola_reframe(yf) * c["window"]
    xb = torch.sqrt(torch.einsum("jf,bnf->bjn", c["obm"], _power_spectrum(xr, c["basis"])))
    yb = torch.sqrt(torch.einsum("jf,bnf->bjn", c["obm"], _power_spectrum(yr, c["basis"])))
    return xb, yb, n_keep, nfr


def _segments(xb, yb, n_keep, nfr):
    """Segments (B, J, n_segs, N) of both envelopes and which of them a
    clip has (B, n_segs): the host path has n_keep - 1 envelope frames,
    since pystoi's framing leaves out the overlap-added signal's last."""
    n_segs = nfr - N_SEG + 1
    seg_x = xb.unfold(2, N_SEG, 1)
    seg_y = yb.unfold(2, N_SEG, 1)
    n_env = n_keep - 1
    seg_ok = (torch.arange(n_segs, device=xb.device)[None, :] + N_SEG) <= n_env[:, None]
    return seg_x, seg_y, seg_ok, n_env


def _masked_mean(corr, seg_ok, n_env):
    denom = seg_ok.sum(dim=1).clamp(min=1)
    score = torch.where(seg_ok, corr, 0.0).sum(dim=1) / denom
    return torch.where(n_env >= N_SEG, score, torch.full_like(score, 1e-5))


def _too_short(clean) -> torch.Tensor:
    return torch.full((clean.shape[0],), 1e-5, dtype=torch.float64, device=clean.device)


def estoi_batch(clean: torch.Tensor, denoised: torch.Tensor, lengths: torch.Tensor | None = None,
                fs: int = 16000) -> torch.Tensor:
    """ESTOI of each row: clean and denoised (B, S) at 16 kHz, ``lengths``
    (B,) valid samples; (B,) float64."""
    xb, yb, n_keep, nfr = _batch_band_envelopes(clean, denoised, lengths, fs)
    if nfr < N_SEG:
        return _too_short(clean)
    seg_x, seg_y, seg_ok, n_env = _segments(xb, yb, n_keep, nfr)

    def norm(s):  # (B, J, M, N): over time, then over bands
        s = s - s.mean(dim=-1, keepdim=True)
        s = s / (torch.linalg.vector_norm(s, dim=-1, keepdim=True) + 1e-20)
        s = s - s.mean(dim=1, keepdim=True)
        return s / (torch.linalg.vector_norm(s, dim=1, keepdim=True) + 1e-20)

    corr = (norm(seg_x) * norm(seg_y)).sum(dim=(1, 3)) / N_SEG  # (B, M)
    return _masked_mean(corr, seg_ok, n_env)


def stoi_batch(clean: torch.Tensor, denoised: torch.Tensor, lengths: torch.Tensor | None = None,
               fs: int = 16000) -> torch.Tensor:
    """STOI of each row, as :func:`estoi_batch`."""
    xb, yb, n_keep, nfr = _batch_band_envelopes(clean, denoised, lengths, fs)
    if nfr < N_SEG:
        return _too_short(clean)
    seg_x, seg_y, seg_ok, n_env = _segments(xb, yb, n_keep, nfr)
    norm = torch.linalg.vector_norm
    alpha = norm(seg_x, dim=-1, keepdim=True) / (norm(seg_y, dim=-1, keepdim=True) + 1e-20)
    y_prime = torch.minimum(alpha * seg_y, seg_x * (1 + 10 ** (-BETA / 20)))
    xc = seg_x - seg_x.mean(dim=-1, keepdim=True)
    yc = y_prime - y_prime.mean(dim=-1, keepdim=True)
    xc = xc / (norm(xc, dim=-1, keepdim=True) + 1e-20)
    yc = yc / (norm(yc, dim=-1, keepdim=True) + 1e-20)
    corr = (xc * yc).sum(dim=-1).mean(dim=1)  # (B, M): mean over bands
    return _masked_mean(corr, seg_ok, n_env)
