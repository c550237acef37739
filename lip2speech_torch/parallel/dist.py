"""Data parallelism across processes, and the rank grid (PyTorch).

Counterpart of ``create_mesh``/``auto_mesh`` and the data axis of
``lip2speech_tpu/parallel/mesh.py``, in PyTorch's idiom: one process per
device, a ``torch.distributed`` process group, and the global batch split
into equal rows. The JAX package shards one global array over a ``Mesh``
and GSPMD inserts the collectives; here each rank holds its rows and the
code reduces explicitly where a computation reads the whole batch.

The ranks form a grid of ``n_data x n_model`` (``create_mesh``'s
``devices.reshape(n_data, n_model)``): rank ``r = d * n_model + m`` has data
index ``d`` and model index ``m``. The ranks of one model index form a
*data group*, those of one data index a *model group*. The batch splits over
the data index, so the ranks of a model group hold the same rows; tensor
parallelism (``parallel/tensor.py``) shards weights over the model group.
Every reduction over the batch below runs over the data group (the world
when ``n_model`` is 1): over the world it would count a model group's rows
``n_model`` times. Those reductions are:

- the train-mode BatchNorm moments (``models/layers.FlaxRuleBatchNorm``),
  with their gradient (``all_reduce_sum``);
- the cotangent norms of ``layers.clip_grad_norm``;
- the loss's denominators and its logged values (``train/losses.py``);
- the gradients, one all-reduce of each optimizer's flat f32 vector;
- the speaker step's contrastive batch (``all_gather_rows``);
- the eval score (``eval/evaluate.py``).

The contract is GSPMD's: a step on ``n_data`` data indices, with a global
batch B split into ``n_data`` equal rows, computes the same step as one
rank on the whole of B. So each rank's loss is its share of the global loss
(the shares sum to it over a data group), and the gradients are summed over
the data group.

Random draws. Every per-row draw is made at the global batch's shape from
the step's generator, which every rank seeds alike, and each rank keeps the
rows of its data index (``RowDraws``, ``uniform``), so the ranks of a model
group draw alike; a draw without a batch axis is the same on every rank.

A run with one process and no group passes ``dp=None`` everywhere and runs
the single-device code as it is.
"""

from __future__ import annotations

import dataclasses
import os
import socket

import torch
import torch.distributed as dist

# what torch.distributed.run sets for every rank (env:// reads them)
ENV_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place in the process group (the default one): its
    ``rank`` of ``world``, its ``device``, the ``backend``, and its place in
    the ``n_data x n_model`` grid with the groups of the grid (``join_grid``):
    ``data_group``, the ranks of its model index (None: the world, when
    ``n_model`` is 1), and ``model_group``, the ranks of its data index
    (None when ``n_model`` is 1). A copy is the same handle."""

    rank: int
    world: int
    device: torch.device
    backend: str
    n_model: int = 1
    data_group: object = dataclasses.field(default=None, compare=False, repr=False)
    model_group: object = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def n_data(self) -> int:
        return self.world // self.n_model

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    def __deepcopy__(self, memo):
        # the groups are handles of this process's communicators
        return self


def is_main(dp: DataParallel | None) -> bool:
    """True on rank 0, and in a run without a group."""
    return dp is None or dp.rank == 0


def barrier(dp: DataParallel | None) -> None:
    """Wait for every rank (nothing without a group)."""
    if dp is None:
        return
    if dp.backend == "nccl":
        dist.barrier(device_ids=[dp.device.index])
    else:
        dist.barrier()


def env_world_size() -> int:
    """The world size ``torch.distributed.run`` sets (1 without it)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def data_parallel_size(requested: int, world: int, batch_size: int, n_model: int = 1) -> int:
    """The data axis ``n_data`` of a grid of ``world`` processes with
    ``n_model`` on the model axis, as ``create_mesh``/``auto_mesh`` rule
    (``mesh.py:21-57``): -1 means ``world / n_model``; ``n_data * n_model``
    must be the world size, since a process cannot sit idle as a device
    outside a mesh can. The global batch must split into ``n_data`` equal
    rows."""
    if n_model < 1 or world % n_model:
        raise ValueError(f"--model_parallel {n_model} does not divide the {world} processes")
    n = world // n_model if requested == -1 else requested
    if n * n_model != world:
        raise ValueError(
            f"--data_parallel {requested} x --model_parallel {n_model} with {world} processes: "
            f"the grid's size must be the world size (or --data_parallel -1); launch "
            f"{max(n, 0) * n_model} processes to run {n} x {n_model} ranks")
    if batch_size % n:
        raise ValueError(f"the global batch of {batch_size} does not split into {n} equal rows")
    return n


def _device_for(device: str, local_rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _device_key(dev: torch.device) -> str:
    """The host and the card of ``dev``: two ranks with the same key share
    one device."""
    if dev.type != "cuda":
        return f"{socket.gethostname()}/{dev}"
    props = torch.cuda.get_device_properties(dev)
    return f"{socket.gethostname()}/{getattr(props, 'uuid', dev.index)}"


def join_grid(rank: int, world: int, device: torch.device, backend: str,
              n_model: int = 1) -> DataParallel:
    """This rank's place in the ``(world / n_model) x n_model`` grid of a
    started process group, with the grid's groups. Every rank makes every
    group (``dist.new_group`` is collective), in the same order."""
    if n_model < 1 or world % n_model:
        raise ValueError(f"a model axis of {n_model} does not divide {world} ranks")
    if n_model == 1:
        return DataParallel(rank, world, device, backend)
    n_data = world // n_model
    data_group = model_group = None
    for m in range(n_model):
        group = dist.new_group([d * n_model + m for d in range(n_data)])
        if rank % n_model == m:
            data_group = group
    for d in range(n_data):
        group = dist.new_group([d * n_model + m for m in range(n_model)])
        if rank // n_model == d:
            model_group = group
    return DataParallel(rank, world, device, backend, n_model, data_group, model_group)


def init_from_env(device: str = "cuda", backend: str | None = None,
                  required: bool = False, n_model: int = 1) -> DataParallel | None:
    """Join the process group that ``torch.distributed.run`` describes in the
    environment (``init_method="env://"``), or return None for a run of one
    process. ``required`` (``--multihost``) raises when a variable is
    missing; otherwise the group starts when ``WORLD_SIZE`` is above 1.

    The device is ``cuda:{LOCAL_RANK % device_count}`` unless ``device`` is
    another type. The backend is NCCL on CUDA and gloo on the CPU unless
    ``backend`` names one (gloo on CUDA lets several ranks share a card).
    NCCL ranks that share a device raise before the first NCCL collective;
    nothing changes backend on its own. ``n_model`` is the grid's model
    axis (``join_grid``)."""
    if not required and env_world_size() <= 1:
        return None
    missing = [k for k in ENV_VARS if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"a data-parallel run needs {', '.join(missing)} in the environment: launch it "
            "with python -m torch.distributed.run --nproc_per_node N -m ...")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = _device_for(device, int(os.environ.get("LOCAL_RANK", rank)))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs --device cuda; use --dist_backend gloo on the CPU")
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    if backend == "nccl":
        # over a gloo group: an NCCL collective between ranks on one card hangs
        side = dist.new_group(backend="gloo")
        keys = [None] * world
        dist.all_gather_object(keys, _device_key(dev), group=side)
        dist.destroy_process_group(side)
        shared = sorted({k for k in keys if keys.count(k) > 1})
        if shared:
            dist.destroy_process_group()
            raise RuntimeError(
                f"NCCL cannot run two ranks on one device ({', '.join(shared)} is shared by "
                f"{world} ranks): give each rank its own card, or pass --dist_backend gloo")
    return join_grid(rank, world, dev, backend, n_model)


def shutdown(dp: DataParallel | None) -> None:
    """Leave the process group (nothing without a group)."""
    if dp is not None and dist.is_initialized():
        dist.destroy_process_group()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        # d(sum over ranks of their shares)/dx_r: every rank's cotangent of
        # the sum reaches every rank's input
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, dp: DataParallel | None) -> torch.Tensor:
    """The sum of ``x`` over the data group, with its gradient; ``x`` itself
    without a group."""
    if dp is None:
        return x
    return _AllReduceSum.apply(x, dp.data_group)


@torch.no_grad()
def all_reduce_(x: torch.Tensor, dp: DataParallel | None) -> torch.Tensor:
    """Sum ``x`` over the data group in place, with no gradient; returns
    ``x``."""
    if dp is not None:
        dist.all_reduce(x, group=dp.data_group)
    return x


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        parts = [torch.empty_like(x) for _ in range(dp.n_data)]
        dist.all_gather(parts, x.contiguous(), group=dp.data_group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        # a reduce-scatter: this rank's rows of the summed cotangent
        dp = ctx.dp
        g = g.contiguous().clone()
        dist.all_reduce(g, group=dp.data_group)
        return local_rows(g, dp.data_index, dp.n_data), None


def all_gather_rows(x: torch.Tensor, dp: DataParallel | None) -> torch.Tensor:
    """Every data index's ``x`` (equal row counts) stacked in order along
    dim 0, with its gradient: the backward sums the cotangent over the
    data group and keeps this rank's rows. ``x`` itself without a group."""
    if dp is None:
        return x
    return _AllGatherRows.apply(x, dp)


def local_rows(x: torch.Tensor, rank: int, world: int, dim: int = 0) -> torch.Tensor:
    """Rank ``rank``'s contiguous share of ``x`` along ``dim``, whose size
    ``world`` divides."""
    n = x.shape[dim]
    if n % world:
        raise ValueError(f"{n} rows do not split into {world} equal shares")
    return x.narrow(dim, rank * (n // world), n // world)


@torch.no_grad()
def agree_over_model_group_(tensors, dp: DataParallel | None) -> None:
    """Every tensor of ``tensors`` as the first rank of this rank's model
    group holds it, in place (one broadcast for each dtype). The ranks of a
    model group read the same rows, but each loader draws the random parts
    of a sample (face crops, flips) on its own, and they compute their
    replicated tensors alike but not bit for bit where an op's order of
    summation is not fixed (threads on the CPU, atomics on the card); a
    batch and what must stay the same on them are made so here. Nothing
    without a model axis."""
    if dp is None or dp.n_model == 1:
        return
    by_type: dict = {}
    for t in tensors:
        by_type.setdefault((t.dtype, t.device), []).append(t)
    for parts in by_type.values():
        flat = torch.cat([t.reshape(-1) for t in parts])
        dist.broadcast(flat, src=dp.data_index * dp.n_model, group=dp.model_group)
        torch._foreach_copy_(parts, [x.view_as(t) for x, t in
                                     zip(flat.split([t.numel() for t in parts]), parts)])


@torch.no_grad()
def same_on_all_ranks(tensors, dp: DataParallel | None, shards=()) -> bool:
    """True when every rank holds ``tensors`` (replicated) bit for bit as
    rank 0 does, and ``shards`` (this model index's slices) as the first
    rank of its data group does (the same answer on every rank)."""
    if dp is None:
        return True
    ok = True
    for group, src, parts in ((None, 0, tensors), (dp.data_group, dp.model_index, shards)):
        # every tensor's bytes in one buffer: one broadcast for the lot
        mine = [t.detach().to(dp.device).contiguous().reshape(-1).view(torch.uint8)
                for t in parts]
        if not mine:
            continue
        mine = torch.cat(mine)
        ref = mine.clone()
        dist.broadcast(ref, src=src, group=group)
        ok = torch.equal(ref, mine) and ok
    flags = torch.tensor([int(ok)], dtype=torch.int32, device=dp.device)
    # a rank that differs sets 0 on every rank
    dist.all_reduce(flags, op=dist.ReduceOp.MIN)
    return bool(flags.item())


@dataclasses.dataclass(frozen=True)
class RowDraws:
    """A step's generator for rows ``[start, start + rows)`` of a global
    batch of ``total`` rows: every per-row draw is made at the global shape
    (so every rank consumes the generator alike) and cut to these rows.
    Passed where a ``torch.Generator`` goes; ``uniform`` tells them apart."""

    generator: torch.Generator
    start: int
    rows: int
    total: int

    @classmethod
    def for_rank(cls, generator: torch.Generator, dp: DataParallel, local_batch: int):
        """The rows of ``dp``'s data index, of ``dp.n_data`` equal shares."""
        return cls(generator, dp.data_index * local_batch, local_batch, dp.n_data * local_batch)

    def uniform(self, shape, device, batch_dim: int | None) -> torch.Tensor:
        if batch_dim is None:
            return torch.rand(shape, generator=self.generator, device=device)
        shape = list(shape)
        n = shape[batch_dim]
        if n % self.rows:
            raise ValueError(f"a draw of {n} rows on the batch axis for {self.rows} batch rows")
        per = n // self.rows  # rows of the draw per batch row (the content codebook's slots)
        shape[batch_dim] = per * self.total
        full = torch.rand(shape, generator=self.generator, device=device)
        return full.narrow(batch_dim, per * self.start, n)


def uniform(shape, generator, device, batch_dim: int | None = 0) -> torch.Tensor:
    """U[0, 1) of ``shape`` from ``generator``. A ``RowDraws`` draws at its
    global batch along ``batch_dim`` and keeps its rows; ``batch_dim=None``
    marks a draw with no batch axis, the same on every rank."""
    if isinstance(generator, RowDraws):
        return generator.uniform(shape, device, batch_dim)
    return torch.rand(shape, generator=generator, device=device)


def base_generator(generator):
    """The ``torch.Generator`` behind a ``RowDraws`` (or ``generator``)."""
    return generator.generator if isinstance(generator, RowDraws) else generator
