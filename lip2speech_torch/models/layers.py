"""Shared building blocks (PyTorch, reference parameter names).

Counterpart of ``lip2speech_tpu/models/layers.py``. Module attribute names
follow the reference torch modules (``LinearNorm.linear_layer``,
``ConvNorm.conv``, ``PSine.w``) so a state dict from
``lip2speech_torch.weights.from_flax`` or a reference ``.pth`` loads with
``strict=True``. LSTM gates are in torch order (i, f, g, o).

Eval-mode BatchNorm uses torch's default eps 1e-5, except in the face net
(``models/face.py``), which uses 1e-3 like facenet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn


class LinearNorm(nn.Module):
    """Dense layer wrapped as in the reference (decoder.py:73-83)."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        self.linear_layer = nn.Linear(in_dim, out_dim, bias=bias)

    def forward(self, x):
        return self.linear_layer(x)


class ConvNorm(nn.Module):
    """1-D conv with 'same' padding by default (decoder.py:86-104)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 1,
                 stride: int = 1, dilation: int = 1, bias: bool = True,
                 padding: int | None = None):
        super().__init__()
        if padding is None:
            padding = dilation * (kernel_size - 1) // 2
        self.conv = nn.Conv1d(in_ch, out_ch, kernel_size, stride=stride,
                              padding=padding, dilation=dilation, bias=bias)

    def forward(self, x):
        return self.conv(x)


class PSine(nn.Module):
    """``sin(x) * w`` with a per-channel amplitude ``w`` (decoder.py:43-70);
    the channels are on the last axis unless ``channel_dim`` says else."""

    def __init__(self, dims: int, w_init: float = 1.0):
        super().__init__()
        self.w = nn.Parameter(torch.full((dims,), float(w_init)))

    def forward(self, x, channel_dim: int = -1):
        w = self.w
        if channel_dim != -1:
            w = w.view(-1, *([1] * (x.ndim - 1 - channel_dim)))
        return torch.sin(x) * w


@functools.lru_cache(maxsize=16)
def sinusoid_table(n_position: int, d_hid: int) -> np.ndarray:
    """Sinusoid positional table (n_position, d_hid), interleaved sin/cos
    (reference decoder.py:19-40). The cached array is returned read-only."""
    pos = np.arange(n_position)[:, None]
    j = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000.0, 2.0 * (j // 2) / d_hid)
    table = np.zeros((n_position, d_hid), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    table.setflags(write=False)
    return table


def lstm_cell_step(wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor,
                   x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
    """One fused LSTM step, gate order (i, f, g, o). ``wx (in, 4H)``,
    ``wh (H, 4H)``, ``b (4H,)``; f32 state."""
    gates = x @ wx + h @ wh + b
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for and missing; never falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
