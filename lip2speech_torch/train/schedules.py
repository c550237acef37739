"""Learning-rate schedules.

Counterpart of ``lip2speech_tpu/train/schedules.py``: polynomial decay
``lr * (1 - it / max_iter) ** 0.9``, a reduce-on-plateau multiplier, and
Adam with the decay. The training path does not use them (it trains with
``train/optim.py``'s AMSGrad at a constant rate), in either package.
"""

from __future__ import annotations

from typing import Callable

import torch


def polynomial_decay(base_lr: float, max_iter: int, power: float = 0.9) -> Callable[[int], float]:
    """lr(it) = base_lr * clip(1 - it / max_iter, 0, 1) ** power."""

    def schedule(count: int) -> float:
        frac = min(max(1.0 - count / max_iter, 0.0), 1.0)
        return base_lr * frac ** power

    return schedule


class ReduceOnPlateau:
    """Multiplicative lr reduction when a monitored metric stalls for more
    than ``patience`` updates; ``update`` returns the current factor."""

    def __init__(self, factor: float = 0.5, patience: int = 3, mode: str = "min"):
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.best = float("inf") if mode == "min" else -float("inf")
        self.bad = 0
        self.scale = 1.0

    def update(self, metric: float) -> float:
        improved = metric < self.best if self.mode == "min" else metric > self.best
        if improved:
            self.best = metric
            self.bad = 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                self.scale *= self.factor
                self.bad = 0
        return self.scale


def adam_poly(params, base_lr: float, max_iter: int, power: float = 0.9, **adam_kw):
    """``torch.optim.Adam`` at ``base_lr`` and a ``LambdaLR`` that scales it
    by the polynomial decay: (optimizer, scheduler); step the scheduler
    after each optimizer step."""
    opt = torch.optim.Adam(params, lr=base_lr, **adam_kw)
    decay = polynomial_decay(1.0, max_iter, power)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, decay)
