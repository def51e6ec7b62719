"""The data-parallel world and its collectives (the data-parallel half of
``rsrgan_tpu/parallel/mesh.py``).

JAX shards the batch over a device mesh and lets XLA insert the
reductions; the port says them. A ``DataWorld`` is this process's rank,
the world size and its device. Every rank holds the whole state
(``replicate`` broadcasts it from rank 0), takes its contiguous row block
of each global batch (``shard_batch``), and averages each update's
gradients and metrics over the world in one all-reduce of one flat
buffer, in a fixed name order (``all_reduce_mean``). A statistic over the
batch axis is a statistic of the global batch (``global_moments``: the
all-reduce in the forward and in the backward). Draws that depend on the
batch (D's input noise, dropout masks, SEGAN's z) are made at the global
batch from the one seeded generator, and each rank keeps its rows
(``LocalDraws``), so a data-parallel run draws the numbers of the
one-process run at the global batch.

With a world of one, each of these is the identity and launches nothing.
Only ``all_reduce`` and ``broadcast`` are used: gloo runs nothing else on
CUDA tensors. The world is process-wide, as ``torch.distributed``'s
default group is: ``make_world`` sets it, ``current_world`` reads it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclass
class DataWorld:
    """This process's place in the data-parallel world. ``timed``: add
    each all-reduce's wall time, a synchronize of this device on either
    side, to ``collective_secs``; it includes the wait for the other ranks
    to reach the all-reduce (off by default: the synchronizes cost)."""
    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    collectives: int = 0
    collective_secs: float = 0.0
    timed: bool = False

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def all_reduce_sum_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the world in place."""
        if self.timed:
            self._sync()
            t0 = time.perf_counter()
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
        self.collectives += 1
        if self.timed:
            self._sync()
            self.collective_secs += time.perf_counter() - t0
        return x

    def broadcast_(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``x`` on every rank, in place."""
        dist.broadcast(x, src=0)
        self.collectives += 1
        return x


_WORLD = DataWorld()


def current_world() -> DataWorld:
    """The process's data world (a world of one until ``make_world``)."""
    return _WORLD


def make_world(device: torch.device) -> DataWorld:
    """The process's data world on ``device``: this rank of the
    initialized ``torch.distributed`` group, else a world of one. It
    becomes ``current_world()``."""
    global _WORLD
    if dist.is_initialized():
        _WORLD = DataWorld(rank=dist.get_rank(),
                           world=dist.get_world_size(), device=device,
                           backend=dist.get_backend())
    else:
        _WORLD = DataWorld(device=device)
    return _WORLD


def shard_batch(world: DataWorld, tree, axis: int = 0):
    """This rank's contiguous row block of every array of ``tree`` (an
    array or index list, or a tuple or dict of them) along ``axis``, 0 or
    1. Rows that do not divide by the world raise, as JAX's placement of a
    batch on the data mesh does."""
    if isinstance(tree, dict):
        return {k: shard_batch(world, v, axis) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(shard_batch(world, v, axis) for v in tree)
    if world.world == 1:
        return tree
    if isinstance(tree, list):
        tree = np.asarray(tree)   # an index plan
    rows = tree.shape[axis]
    if rows % world.world:
        raise ValueError(f"{rows} rows do not divide over a world of "
                         f"{world.world}")
    b = rows // world.world
    block = slice(world.rank * b, (world.rank + 1) * b)
    return tree[block] if axis == 0 else tree[:, block]


def replicate(world: DataWorld, tensors: Iterable[torch.Tensor]) -> None:
    """Every tensor of a state set to rank 0's values, in place."""
    if world.world == 1:
        return
    with torch.no_grad():
        for t in tensors:
            world.broadcast_(t.data)


def all_reduce_mean(world: DataWorld, tree: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """The mean over the world of every tensor of ``tree`` (gradients,
    metrics): one all-reduce of one float32 buffer holding them in sorted
    name order, divided by the world size; each tensor keeps its shape
    and dtype. The identity in a world of one."""
    if world.world == 1:
        return tree
    names = sorted(tree)
    flat = torch.cat([tree[n].detach().reshape(-1).to(torch.float32)
                      for n in names])
    world.all_reduce_sum_(flat).div_(world.world)
    out, at = {}, 0
    for n in names:
        t = tree[n]
        out[n] = flat[at:at + t.numel()].view(t.shape).to(t.dtype)
        at += t.numel()
    return out


class _AllReduceMean(torch.autograd.Function):
    """The world's mean of a tensor that every rank computed from its
    rows; its gradient is the world's mean of the ranks' gradients
    (each rank's loss is its share of the global loss)."""

    @staticmethod
    def forward(ctx, x):
        world = current_world()
        return world.all_reduce_sum_(x.clone()).div_(world.world)

    @staticmethod
    def backward(ctx, grad):
        world = current_world()
        return world.all_reduce_sum_(grad.contiguous().clone()).div_(
            world.world)


def global_moments(x: torch.Tensor, dims: Sequence[int],
                   centred: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Moments of ``x`` over ``dims`` (the batch axis among them) for the
    global batch: (mean, mean of squares) in one all-reduce, or with
    ``centred`` (mean, variance) in two passes, the global mean first and
    then the global mean of the squared deviations from it. Gradients
    flow through the all-reduces. Every rank must hold the same number of
    rows: the means are means of the ranks' means. In a world of one, the
    moments of ``x``."""
    dims = tuple(d % x.ndim for d in dims)
    reduce = (_AllReduceMean.apply if current_world().world > 1
              else lambda t: t)
    if not centred:
        both = torch.stack([x.mean(dims), torch.square(x).mean(dims)])
        mean, mean_sq = reduce(both).unbind(0)
        return mean, mean_sq
    mean = reduce(x.mean(dims, keepdim=True))
    var = reduce(torch.square(x - mean).mean(dims))
    return mean.reshape(var.shape), var


class LocalDraws:
    """Random draws made for the global batch from ``generator``, of which
    this rank keeps its rows: a local tensor of ``shape`` is ``parts``
    contiguous blocks of rows (D's real and fake rows: 2), and each block
    is this rank's block of the matching global block. The generator
    advances as it does in the one-process run at the global batch."""

    def __init__(self, generator: torch.Generator, world: DataWorld,
                 parts: int = 1):
        self.generator, self.world, self.parts = generator, world, parts

    def _local(self, full: torch.Tensor, shape) -> torch.Tensor:
        b = shape[0] // self.parts
        return full.view(self.parts, self.world.world, b,
                         *shape[1:])[:, self.world.rank].reshape(shape)

    def _global(self, shape) -> Tuple[int, ...]:
        shape = tuple(shape)
        if shape[0] % self.parts:
            raise ValueError(f"{shape[0]} rows are not {self.parts} blocks")
        return (shape[0] * self.world.world,) + shape[1:]

    def rand(self, shape, dtype=torch.float32) -> torch.Tensor:
        """Uniform [0, 1) draws, this rank's rows."""
        g = self.generator
        return self._local(torch.rand(self._global(shape), generator=g,
                                      dtype=dtype, device=g.device), shape)

    def randn(self, shape, dtype=torch.float32) -> torch.Tensor:
        """Standard normal draws, this rank's rows."""
        g = self.generator
        return self._local(torch.randn(self._global(shape), generator=g,
                                       dtype=dtype, device=g.device), shape)


def local_draws(source, parts: int = 1):
    """``source`` as the trainers hand it to a net: a generator becomes
    ``LocalDraws`` in a world of more than one rank; anything else (a
    callable or tensor a test hands in, None) and any source in a world
    of one is returned as it is."""
    world = current_world()
    if world.world == 1 or not isinstance(source, torch.Generator):
        return source
    return LocalDraws(source, world, parts)


def gather_rows(world: DataWorld, local: torch.Tensor) -> torch.Tensor:
    """Every rank's block of rows, in rank order, on every rank: one
    all-reduce of a zero-filled buffer holding this rank's block (exact,
    and the same on both backends). The identity in a world of one."""
    if world.world == 1:
        return local
    b = local.shape[0]
    full = torch.zeros((b * world.world,) + tuple(local.shape[1:]),
                       dtype=local.dtype, device=local.device)
    full[world.rank * b:(world.rank + 1) * b] = local
    return world.all_reduce_sum_(full)
