"""Data parallelism across processes (PyTorch).

Counterpart of the data axis of ``lip2speech_tpu/parallel/mesh.py``, in
PyTorch's idiom: one process per device, a ``torch.distributed`` process
group, and the global batch split by rank into equal rows. The JAX package
shards one global array over a ``Mesh`` and GSPMD inserts the collectives;
here each rank holds its rows and the code reduces explicitly where a
computation reads the whole batch:

- the train-mode BatchNorm moments (``models/layers.FlaxRuleBatchNorm``),
  with their gradient (``all_reduce_sum``);
- the cotangent norms of ``layers.clip_grad_norm``;
- the loss's denominators and its logged values (``train/losses.py``);
- the gradients, one all-reduce of each optimizer's flat f32 vector;
- the speaker step's contrastive batch (``all_gather_rows``);
- the eval score (``eval/evaluate.py``).

The contract is GSPMD's: a step on W ranks, with a global batch B split
into W equal rows, computes the same step as one rank on the whole of B.
So each rank's loss is its share of the global loss (the shares sum to
it), and the gradients are summed over the ranks.

Random draws. Every per-row draw is made at the global batch's shape from
the step's generator, which every rank seeds alike, and each rank keeps its
own rows (``RowDraws``, ``uniform``); a draw without a batch axis is the
same on every rank.

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
    """This process's place in the data-parallel group (the default
    process group): its ``rank`` of ``world``, its ``device`` and the
    ``backend``."""

    rank: int
    world: int
    device: torch.device
    backend: str


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


def data_parallel_size(requested: int, world: int, batch_size: int) -> int:
    """The data-parallel size of a run of ``world`` processes, as
    ``create_mesh`` rules on the data axis (``mesh.py:45-56``): -1 means
    every process; any other value must be the world size, since a process
    cannot sit idle as a device outside a mesh can. The global batch must
    split into ``world`` equal rows."""
    n = world if requested == -1 else requested
    if n != world:
        raise ValueError(
            f"--data_parallel {requested} with {world} processes: the data-parallel size "
            f"must be the world size (or -1); launch {n} processes to run {n} ranks")
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


def init_from_env(device: str = "cuda", backend: str | None = None,
                  required: bool = False) -> DataParallel | None:
    """Join the process group that ``torch.distributed.run`` describes in the
    environment (``init_method="env://"``), or return None for a run of one
    process. ``required`` (``--multihost``) raises when a variable is
    missing; otherwise the group starts when ``WORLD_SIZE`` is above 1.

    The device is ``cuda:{LOCAL_RANK % device_count}`` unless ``device`` is
    another type. The backend is NCCL on CUDA and gloo on the CPU unless
    ``backend`` names one (gloo on CUDA lets several ranks share a card).
    NCCL ranks that share a device raise before the first NCCL collective;
    nothing changes backend on its own."""
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
    dp = DataParallel(rank, world, dev, backend)
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
    return dp


def shutdown(dp: DataParallel | None) -> None:
    """Leave the process group (nothing without a group)."""
    if dp is not None and dist.is_initialized():
        dist.destroy_process_group()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        # d(sum over ranks of their shares)/dx_r: every rank's cotangent of
        # the sum reaches every rank's input
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor, dp: DataParallel | None) -> torch.Tensor:
    """The sum of ``x`` over the ranks, with its gradient; ``x`` itself
    without a group."""
    if dp is None:
        return x
    return _AllReduceSum.apply(x)


@torch.no_grad()
def all_reduce_(x: torch.Tensor, dp: DataParallel | None) -> torch.Tensor:
    """Sum ``x`` over the ranks in place, with no gradient; returns ``x``."""
    if dp is not None:
        dist.all_reduce(x)
    return x


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        parts = [torch.empty_like(x) for _ in range(dp.world)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        # a reduce-scatter: this rank's rows of the summed cotangent
        dp = ctx.dp
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return local_rows(g, dp.rank, dp.world), None


def all_gather_rows(x: torch.Tensor, dp: DataParallel | None) -> torch.Tensor:
    """Every rank's ``x`` (equal row counts) stacked in rank order along
    dim 0, with its gradient: the backward sums the cotangent over the
    ranks and keeps this rank's rows. ``x`` itself without a group."""
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
def same_on_all_ranks(tensors, dp: DataParallel | None) -> bool:
    """True when every rank holds ``tensors`` bit for bit as rank 0 does
    (the same answer on every rank)."""
    if dp is None:
        return True
    tensors = list(tensors)
    ok = torch.ones((), dtype=torch.int32, device=dp.device)
    for t in tensors:
        ref = t.detach().clone()
        dist.broadcast(ref, src=0)
        ok &= torch.equal(ref, t.detach())
    flags = ok.reshape(1)
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
        """Rank ``dp.rank``'s rows of ``dp.world`` equal shares."""
        return cls(generator, dp.rank * local_batch, local_batch, dp.world * local_batch)

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
