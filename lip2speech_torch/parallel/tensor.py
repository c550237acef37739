"""Tensor parallelism: the K/V conv banks and ``conv_last`` sharded on their
output channels over the model group (PyTorch).

Counterpart of the tensor-parallel half of
``lip2speech_tpu/parallel/mesh.py``: ``TP_RULES`` and ``partition_params``
(which weights shard, ``mesh.py:58-101``), ``opt_state_shardings`` (the
optimizer's moments follow their parameters, ``:148-167``),
``shard_train_state`` and ``shard_like`` (a checkpoint is independent of
the layout and restores into the live shards, ``:170-195``).

Only time-batched convolutions shard: the four ``conv_k`` and the
bottleneck of both K/V banks and the trunk's ``conv_last``, 11 kernels, on
their output channels (dim 0 in torch's layout). Nothing inside the AR
loop shards, so the loop runs no collective (``mesh.py:58-75``). Biases,
BatchNorm and every other tensor stay replicated, and a kernel whose
output channels ``n_model`` does not divide stays whole.

A sharded conv (``ColumnParallel``) is Megatron's column-parallel layer with
its output gathered: the conv runs without its bias on this rank's slice
of the kernel, an all-gather over the model group joins the channels, and
the full bias, the BatchNorm and the activation run after it on every rank
of the group alike. Two autograd functions carry the gradients:

- ``gather_channels``: the forward gathers; the backward keeps this rank's
  channels of the cotangent, which is the same on every rank of the group;
- ``copy_to_model``: the forward is the identity; the backward sums the
  input's cotangent (each rank's part, from its channels) over the group.

So a forward runs 11 all-gathers and a backward 11 all-reduces over the
model group; replicated gradients come out the same on every rank of a
model group, and a shard's gradient is its rows' part, summed over the
data group with the rest.

Checkpoints keep the one-rank layout: ``full_state_dict`` and
``gather_flat`` gather the shards for a save, ``load_full_state_dict_`` and
``shard_flat`` cut a rank's slices from it on a restore.
"""

from __future__ import annotations

import re

import torch
import torch.distributed as dist
from torch import nn

from lip2speech_torch.parallel.dist import DataParallel, local_rows

# port parameter name -> sharded on its output channels (dim 0); the JAX
# paths are decoder/{K,V}_bank/{conv_k1,3,7,11,bottleneck}/kernel and
# encoder/trunk/conv_last_conv/kernel (``weights.build_entries``)
TP_RULES: tuple[str, ...] = (
    r"^decoder\.[KV]\.0\.conv\.\d+\.0\.weight$",
    r"^decoder\.[KV]\.0\.bottleneck\.weight$",
    r"^encoder\.trunk\.1\.0\.weight$",
)
SHARD_DIM = 0


def partition_params(shapes: dict[str, tuple[int, ...]], n_model: int) -> dict[str, int]:
    """The sharded parameters of a model with these parameter ``shapes``
    (name -> shape) on a model axis of ``n_model``, name -> the dim sharded;
    empty when ``n_model`` is 1. A match whose output channels ``n_model``
    does not divide stays replicated (``mesh.py:96-98``)."""
    if n_model <= 1:
        return {}
    return {name: SHARD_DIM for name, shape in shapes.items()
            if any(re.search(rule, name) for rule in TP_RULES)
            and shape[SHARD_DIM] % n_model == 0}


def shard(t: torch.Tensor, dp: DataParallel, dim: int = SHARD_DIM) -> torch.Tensor:
    """This model index's slice of ``t`` along ``dim`` (a view)."""
    return local_rows(t, dp.model_index, dp.n_model, dim)


def gather(t: torch.Tensor, dp: DataParallel, dim: int = SHARD_DIM) -> torch.Tensor:
    """Every model index's ``t`` joined along ``dim`` in order, over the
    model group (no gradient)."""
    parts = [torch.empty_like(t) for _ in range(dp.n_model)]
    dist.all_gather(parts, t.detach().contiguous(), group=dp.model_group)
    return torch.cat(parts, dim)


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, dp):
        ctx.dp = dp
        return gather(y, dp, 1)

    @staticmethod
    def backward(ctx, g):
        return shard(g, ctx.dp, 1).contiguous(), None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.dp.model_group)
        return g, None


def gather_channels(y: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    """``y`` (B, C / n_model, ...) of every model index joined on the
    channels, with its gradient."""
    return _GatherChannels.apply(y, dp)


def copy_to_model(x: torch.Tensor, dp: DataParallel) -> torch.Tensor:
    """``x`` itself, whose backward sums the cotangent over the model group."""
    return _CopyToModel.apply(x, dp)


class ColumnParallel:
    """A conv whose ``weight`` holds this model index's output channels
    once ``shard_`` has set ``tp`` (the whole conv, as torch's, before)."""

    tp: DataParallel | None = None

    def forward(self, x):
        if self.tp is None:
            return super().forward(x)
        y = gather_channels(self._conv_forward(copy_to_model(x, self.tp), self.weight, None),
                            self.tp)
        if self.bias is None:
            return y
        return y + self.bias.view(1, -1, *([1] * (y.ndim - 2)))


class Conv1d(ColumnParallel, nn.Conv1d):
    pass


class Conv2d(ColumnParallel, nn.Conv2d):
    pass


def layout(model: nn.Module) -> tuple[DataParallel | None, tuple[str, ...]]:
    """(the grid of ``model``'s shards or None, the names of its sharded
    parameters in the model's order, the same on every rank)."""
    names, dp = [], None
    for name, m in model.named_modules():
        if isinstance(m, ColumnParallel) and m.tp is not None:
            names.append(f"{name}.weight")
            dp = m.tp
    return dp, tuple(names)


def state_parts(model: nn.Module) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """(``model``'s replicated state tensors, its shards), each in the state
    dict's order: what every rank, and what every rank of a data group,
    holds alike."""
    _, names = layout(model)
    sd = model.state_dict()
    return ([v for k, v in sd.items() if k not in names],
            [v for k, v in sd.items() if k in names])


@torch.no_grad()
def shard_(model: nn.Module, dp: DataParallel | None) -> tuple[str, ...]:
    """Keep this rank's slice of every parameter ``partition_params`` shards
    (in place, as new parameters: make the optimizer after) and make each
    such conv column-parallel over ``dp``'s model group. Nothing without a
    grid (``dp`` None or ``n_model`` 1). Returns the sharded names."""
    if dp is None or dp.n_model == 1:
        return ()
    names = partition_params({n: tuple(p.shape) for n, p in model.named_parameters()},
                             dp.n_model)
    modules = dict(model.named_modules())
    for name in names:
        m = modules[name.rsplit(".", 1)[0]]
        if not isinstance(m, ColumnParallel):
            raise TypeError(f"{name} matches TP_RULES but its module is not column-parallel")
        m.weight = nn.Parameter(shard(m.weight, dp).clone())
        m.tp = dp
    return tuple(names)


def full_state_dict(model: nn.Module) -> dict[str, torch.Tensor]:
    """``model``'s state dict in the one-rank layout: its shards gathered
    over the model group (a collective of every rank of the group)."""
    dp, names = layout(model)
    sd = model.state_dict()
    return {k: gather(v, dp) if k in names else v for k, v in sd.items()}


def full_named_parameters(model: nn.Module) -> list[tuple[str, torch.Tensor]]:
    """``model``'s (name, parameter) in the one-rank layout: a sharded one
    gathered over the model group (a collective of every rank of the
    group)."""
    dp, names = layout(model)
    return [(n, gather(p, dp) if n in names else p) for n, p in model.named_parameters()]


def load_full_state_dict_(model: nn.Module, sd: dict[str, torch.Tensor]) -> nn.Module:
    """Load a one-rank state dict into ``model`` (``strict=True``), each
    sharded tensor as this rank's slice of it."""
    dp, names = layout(model)
    model.load_state_dict({k: shard(v, dp) if k in names else v for k, v in sd.items()},
                          strict=True)
    return model


def gather_flat(flat: torch.Tensor, params, sharded, dp: DataParallel) -> torch.Tensor:
    """A flat vector over ``params`` (this rank's tensors) in the one-rank
    layout: each part of a ``sharded`` parameter gathered over the model
    group."""
    parts = flat.split([p.numel() for p in params])
    return torch.cat([gather(part.view(p.shape), dp).reshape(-1) if s else part
                      for part, p, s in zip(parts, params, sharded)])


def shard_flat(flat: torch.Tensor, params, sharded, dp: DataParallel) -> torch.Tensor:
    """This rank's flat vector over ``params`` from one in the one-rank
    layout: each ``sharded`` parameter's part cut to this rank's slice."""
    sizes = [p.numel() * (dp.n_model if s else 1) for p, s in zip(params, sharded)]
    parts = flat.split(sizes)
    return torch.cat([shard(part.view(-1, *p.shape[1:]), dp).reshape(-1) if s else part
                      for part, p, s in zip(parts, params, sharded)])
