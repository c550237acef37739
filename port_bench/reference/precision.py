"""The rounding applied to the reference's numbers, forward and backward.

``exact`` leaves operands as they are: the reference. ``fp8`` rounds a
tensor to float8 e4m3 with one scale for the whole tensor (its largest
magnitude onto e4m3's largest, 448), and rounds the gradient that flows
back through it the same way: the precision one step below bf16, which the
benchmark's control computes in to show that its comparisons fail a lower
precision. ``bf16`` rounds to bfloat16 and back, its gradient too: the
type the program serves and trains in. ``RoundEverywhere`` rounds the
result of every operation in its block with one of them, as a program
computing in that type stores every activation; in the backward every
gradient between two operations is then rounded as well. Inside
``unrounded`` it rounds nothing: the reference takes a BatchNorm's batch
statistics in f32 whatever the activations' type, as the program does.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0
_UNROUNDED = [0]


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def _fp8_value(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / E4M3_MAX
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


def _bf16_value(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Round.apply(x, _fp8_value)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return _Round.apply(x, _bf16_value)


@contextlib.contextmanager
def unrounded():
    """A block whose results ``RoundEverywhere`` leaves as they are."""
    _UNROUNDED[0] += 1
    try:
        yield
    finally:
        _UNROUNDED[0] -= 1


class RoundEverywhere(TorchFunctionMode):
    """Every floating result of an operation called in the block, rounded
    by ``q`` (in-place operations keep their own result)."""

    def __init__(self, q: Callable[[torch.Tensor], torch.Tensor]):
        super().__init__()
        self.q = q
        self.inside = False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if self.inside or _UNROUNDED[0]:  # the operations of a call, of the rounding itself, or unrounded
            return func(*args, **(kwargs or {}))
        self.inside = True
        try:
            out = func(*args, **(kwargs or {}))
            return out if getattr(func, "__name__", "").endswith("_") else self._round_tree(out)
        finally:
            self.inside = False

    def _round_tree(self, out):
        if isinstance(out, torch.Tensor):
            return self.q(out) if out.dtype in (torch.float32, torch.float64) and out.numel() else out
        if isinstance(out, (tuple, list)):
            return type(out)(self._round_tree(x) for x in out)
        return out
