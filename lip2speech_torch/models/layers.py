"""Shared building blocks (PyTorch, reference parameter names).

Counterpart of ``lip2speech_tpu/models/layers.py``. Module attribute names
follow the reference torch modules (``LinearNorm.linear_layer``,
``ConvNorm.conv``, ``PSine.w``) so a state dict from
``lip2speech_torch.weights.from_flax`` or a reference ``.pth`` loads with
``strict=True``. LSTM gates are in torch order (i, f, g, o).

BatchNorm uses torch's default eps 1e-5, except in the face net
(``models/face.py``), which uses 1e-3 like facenet and trains only in
speaker pretraining. Every BatchNorm that trains is ``BatchNorm1d/2d/3d``
below, which trains by flax's rule.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lip2speech_torch.parallel.dist import DataParallel, all_reduce_, all_reduce_sum, uniform


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, or as it is when it is wider (an f64 reference run)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class _ClipGradNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, limit, dp):
        ctx.limit, ctx.dp = limit, dp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        sq = torch.sum(torch.square(at_least_f32(g)))
        norm = torch.sqrt(all_reduce_(sq.reshape(1), ctx.dp)[0])
        scale = torch.where(torch.isfinite(norm) & (norm > ctx.limit), ctx.limit / norm, 1.0)
        return g * scale.to(g.dtype), None, None


def clip_grad_norm(x: torch.Tensor, limit: float, dp: DataParallel | None = None) -> torch.Tensor:
    """Identity whose backward rescales the cotangent to ``limit`` L2 norm
    over the whole tensor (``layers.py:23-55``): the norm is taken in (at
    least) f32, and a non-finite norm passes the cotangent through
    unscaled. Under data parallelism (``dp``) the tensor is every data
    index's rows, and the norm is taken over all of them (over the data
    group: the ranks of a model group hold the same rows)."""
    return _ClipGradNorm.apply(x, limit, dp)


def dropout(x: torch.Tensor, keep_mask: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout with a given keep mask: kept entries are divided by
    the keep probability, dropped ones become 0 (``jnp.where(mask, x / keep,
    0)``)."""
    return torch.where(keep_mask, x / (1.0 - rate), 0.0)


def keep_mask(shape, rate: float, generator, device, batch_dim: int = 0) -> torch.Tensor:
    """Bernoulli(1 - rate) keep mask drawn from ``generator`` (a
    ``torch.Generator``, or a rank's ``parallel.RowDraws``, which draws at
    the global batch along ``batch_dim`` and keeps its rows)."""
    return uniform(shape, generator, device, batch_dim) < (1.0 - rate)


class RankAware:
    """A module whose train-mode computation reads the whole batch. Under
    data parallelism ``data_parallel`` sets its ``dp`` for a step, and it
    reduces over the ranks; ``dp`` is None otherwise."""

    dp: DataParallel | None = None


@contextlib.contextmanager
def data_parallel(module: nn.Module, dp: DataParallel | None):
    """Set ``dp`` on every ``RankAware`` submodule of ``module`` for the
    block (nothing when ``dp`` is None)."""
    if dp is None:
        yield
        return
    aware = [m for m in module.modules() if isinstance(m, RankAware)]
    for m in aware:
        m.dp = dp
    try:
        yield
    finally:
        for m in aware:
            m.dp = None


class FlaxRuleBatchNorm(RankAware):
    """BatchNorm that trains as flax ``nn.BatchNorm(momentum=0.9)`` does
    (``layers.py:271-276``).

    Train mode normalises with the batch mean and the *biased* batch
    variance E[x^2] - E[x]^2 (clamped at 0), both reduced in at least f32
    whatever the input type; the normalisation runs in that type and
    returns the input's. The new running statistics, ``0.9 * old + 0.1 *
    batch`` with that same biased variance (torch's own BatchNorm would use
    the unbiased one), are not written into the buffers: they are left in
    ``new_stats`` (f32, or f64 for an f64 input) for the caller, as flax
    returns them as mutable state, so a train step can keep the old ones
    when it skips the update. Eval mode is ``F.batch_norm`` on the running
    statistics. State-dict keys are those of ``nn.BatchNorm*d``.

    Under data parallelism (``dp``, set by ``data_parallel``) the moments
    and the new statistics cover the global batch: each rank's (sum x,
    sum x^2, count) is summed over the data group, with its gradient (over
    the world, a model group's identical rows would count ``n_model``
    times, and the backward's sum would scale the gradient by it)."""

    new_stats: tuple[torch.Tensor, torch.Tensor] | None = None

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        dims = [0] + list(range(2, x.ndim))
        shape = [1, -1] + [1] * (x.ndim - 2)
        xf = at_least_f32(x)
        if self.dp is None:
            mean, mean_sq = xf.mean(dims), torch.square(xf).mean(dims)
        else:
            sums = all_reduce_sum(torch.cat([xf.sum(dims), torch.square(xf).sum(dims),
                                             xf.new_full((1,), xf.numel() // xf.shape[1])]), self.dp)
            C = xf.shape[1]
            mean, mean_sq = sums[:C] / sums[-1], sums[C:2 * C] / sums[-1]
        var = torch.clamp(mean_sq - torch.square(mean), min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.new_stats = (self.running_mean.to(xf.dtype) * (1 - m) + mean * m,
                              self.running_var.to(xf.dtype) * (1 - m) + var * m)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype)
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.to(xf.dtype).view(shape)
        return y.to(x.dtype)


class BatchNorm1d(FlaxRuleBatchNorm, nn.BatchNorm1d):
    pass


class BatchNorm2d(FlaxRuleBatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm3d(FlaxRuleBatchNorm, nn.BatchNorm3d):
    pass


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
    ``wh (H, 4H)``, ``b (4H,)``. The products, gates and state update are
    (at least) f32 whatever the operands' type (``layers.py:165-180``:
    products accumulate in f32); h and c return in ``x``'s type."""
    f32 = at_least_f32
    gates = f32(x) @ f32(wx) + f32(h) @ f32(wh) + f32(b)
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * f32(c) + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new.to(x.dtype), c_new.to(x.dtype)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for and missing; never falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
