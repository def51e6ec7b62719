"""The (data, model) world and its collectives (counterpart of
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

The model axis (``make_world(..., model_parallel=m)``, JAX's ``make_mesh``
with ``model_parallel``) is tensor parallelism as JAX places it: rank r
sits at data index r // m and model index r % m; the data-axis functions
above reduce over the ranks of one model index (the data group), whose
ranks hold the same rows. ``lstm_param_sharding`` is JAX's placement rule
for the LSTM cells' gate and projection kernels, and ``shard_state(...,
tensor_parallel=True)`` keeps on each rank only its model block of the
EMA shadow and the optimizer's moments of those leaves; the module's
parameters stay whole, put together over the model group after every
update (``gather_blocks``), so the kernels run on whole weights.

With a world of one, each of these is the identity and launches nothing;
with ``model_parallel=1`` each is the data-parallel code and launches
the same collectives. Only ``all_reduce`` and ``broadcast`` are used:
gloo runs nothing else on CUDA tensors. The world is process-wide, as
``torch.distributed``'s default group is: ``make_world`` sets it,
``current_world`` reads it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from rsrgan_tpu_torch.parallel.distributed import backend_for, card_identity


@dataclass
class DataWorld:
    """This process's place in the (data, model) world: rank ``rank`` of
    ``world`` processes, at data index ``rank // model`` of ``world //
    model`` and model index ``rank % model``. ``data_group`` holds the
    ranks of this model index and ``model_group`` those of this data
    index (both None with ``model == 1``: the data group is then the
    whole world, the default group). ``timed``: add each all-reduce's wall
    time, a synchronize of this device on either side, to
    ``collective_secs``; it includes the wait for the other ranks to reach
    the all-reduce (off by default: the synchronizes cost)."""
    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    collectives: int = 0
    collective_secs: float = 0.0
    timed: bool = False
    model: int = 1
    data_group: Any = None
    model_group: Any = None

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def data_size(self) -> int:
        return self.world // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _all_reduce_sum_(self, x: torch.Tensor, group) -> torch.Tensor:
        if self.timed:
            self._sync()
            t0 = time.perf_counter()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        self.collectives += 1
        if self.timed:
            self._sync()
            self.collective_secs += time.perf_counter() - t0
        return x

    def all_reduce_sum_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the data group in place."""
        return self._all_reduce_sum_(x, self.data_group)

    def model_sum_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the model group in place."""
        return self._all_reduce_sum_(x, self.model_group)

    def broadcast_(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``x`` on every rank, in place."""
        dist.broadcast(x, src=0)
        self.collectives += 1
        return x


_WORLD = DataWorld()


def current_world() -> DataWorld:
    """The process's data world (a world of one until ``make_world``)."""
    return _WORLD


def make_world(device: torch.device, model_parallel: int = 1
               ) -> DataWorld:
    """The process's world on ``device``: this rank of the initialized
    ``torch.distributed`` group, else a world of one. It becomes
    ``current_world()``.

    ``model_parallel=m`` adds JAX's model axis (``make_mesh(...,
    model_parallel=m)``): rank r at data index r // m and model index
    r % m, the row-major layout of JAX's ``reshape(n // m, m)``. A world
    that does not divide by m raises, as JAX's assert does. Every rank
    makes every data and model group, in the same order; a group's
    backend follows ``distributed.backend_for`` over its ranks' cards
    (gloo where they share one or run on the CPU, else nccl). The batch,
    the statistics and the draws follow the data axis, and so does the
    learning rate: LR x the data axis's size, as JAX scales by
    ``mesh.shape["data"]``. With m = 1 no group is made and every
    function is the data-parallel one."""
    global _WORLD
    if model_parallel < 1:
        raise ValueError(f"model_parallel={model_parallel} is not >= 1")
    if not dist.is_initialized():
        if model_parallel > 1:
            raise ValueError(f"a world of one process has no model axis "
                             f"of {model_parallel}")
        _WORLD = DataWorld(device=device)
        return _WORLD
    n, m = dist.get_world_size(), model_parallel
    if n % m:
        raise ValueError(f"a world of {n} ranks does not divide into a "
                         f"model axis of {m}")
    w = DataWorld(rank=dist.get_rank(), world=n, device=device,
                  backend=dist.get_backend(), model=m)
    if m > 1:
        cards: List[Optional[str]] = [None] * n
        dist.all_gather_object(cards, card_identity(device))
        for d in range(n // m):
            ranks = list(range(d * m, (d + 1) * m))
            g = dist.new_group(ranks, backend=backend_for(
                [cards[r] for r in ranks]))
            if d == w.data_rank:
                w.model_group = g
        for j in range(m):
            ranks = list(range(j, n, m))
            g = dist.new_group(ranks, backend=backend_for(
                [cards[r] for r in ranks]))
            if j == w.model_rank:
                w.data_group = g
    _WORLD = w
    return _WORLD


def shard_batch(world: DataWorld, tree, axis: int = 0):
    """This rank's contiguous row block of every array of ``tree`` (an
    array or index list, or a tuple or dict of them) along ``axis``, 0 or
    1: the block of its data index. Rows that do not divide by the data
    axis raise, as JAX's placement of a batch on the data mesh does."""
    if isinstance(tree, dict):
        return {k: shard_batch(world, v, axis) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(shard_batch(world, v, axis) for v in tree)
    if world.data_size == 1:
        return tree
    if isinstance(tree, list):
        tree = np.asarray(tree)   # an index plan
    rows = tree.shape[axis]
    if rows % world.data_size:
        raise ValueError(f"{rows} rows do not divide over a world of "
                         f"{world.data_size}")
    b = rows // world.data_size
    block = slice(world.data_rank * b, (world.data_rank + 1) * b)
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
    """The mean over the data group of every tensor of ``tree``
    (gradients, metrics): one all-reduce of one float32 buffer holding
    them in sorted name order, divided by the data axis's size; each
    tensor keeps its shape and dtype. The identity on a data axis of
    one."""
    if world.data_size == 1:
        return tree
    names = sorted(tree)
    flat = torch.cat([tree[n].detach().reshape(-1).to(torch.float32)
                      for n in names])
    world.all_reduce_sum_(flat).div_(world.data_size)
    out, at = {}, 0
    for n in names:
        t = tree[n]
        out[n] = flat[at:at + t.numel()].view(t.shape).to(t.dtype)
        at += t.numel()
    return out


class _AllReduceMean(torch.autograd.Function):
    """The data group's mean of a tensor that every rank computed from its
    rows; its gradient is the data group's mean of the ranks' gradients
    (each rank's loss is its share of the global loss)."""

    @staticmethod
    def forward(ctx, x):
        world = current_world()
        return world.all_reduce_sum_(x.clone()).div_(world.data_size)

    @staticmethod
    def backward(ctx, grad):
        world = current_world()
        return world.all_reduce_sum_(grad.contiguous().clone()).div_(
            world.data_size)


def global_moments(x: torch.Tensor, dims: Sequence[int],
                   centred: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Moments of ``x`` over ``dims`` (the batch axis among them) for the
    global batch: (mean, mean of squares) in one all-reduce, or with
    ``centred`` (mean, variance) in two passes, the global mean first and
    then the global mean of the squared deviations from it. Gradients
    flow through the all-reduces. Every rank must hold the same number of
    rows: the means are means of the ranks' means. On a data axis of one,
    the moments of ``x``."""
    dims = tuple(d % x.ndim for d in dims)
    reduce = (_AllReduceMean.apply if current_world().data_size > 1
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
        return full.view(self.parts, self.world.data_size, b,
                         *shape[1:])[:, self.world.data_rank].reshape(shape)

    def _global(self, shape) -> Tuple[int, ...]:
        shape = tuple(shape)
        if shape[0] % self.parts:
            raise ValueError(f"{shape[0]} rows are not {self.parts} blocks")
        return (shape[0] * self.world.data_size,) + shape[1:]

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
    ``LocalDraws`` on a data axis of more than one rank; anything else (a
    callable or tensor a test hands in, None) and any source on a data
    axis of one is returned as it is (the ranks of a model group draw the
    same numbers)."""
    world = current_world()
    if world.data_size == 1 or not isinstance(source, torch.Generator):
        return source
    return LocalDraws(source, world, parts)


def gather_rows(world: DataWorld, local: torch.Tensor) -> torch.Tensor:
    """Every data rank's block of rows, in data order, on every rank: one
    all-reduce over the data group of a zero-filled buffer holding this
    rank's block (exact, and the same on both backends). The identity on
    a data axis of one."""
    if world.data_size == 1:
        return local
    b = local.shape[0]
    full = torch.zeros((b * world.data_size,) + tuple(local.shape[1:]),
                       dtype=local.dtype, device=local.device)
    full[world.data_rank * b:(world.data_rank + 1) * b] = local
    return world.all_reduce_sum_(full)


# ---------------------------------------------------------------------------
# the model axis: tensor parallelism
# ---------------------------------------------------------------------------

def lstm_param_sharding(world: DataWorld, name: str,
                        shape: Sequence[int]) -> Optional[int]:
    """JAX's ``lstm_param_sharding`` placement rule on a leaf's dotted
    name (flax's path) and shape: the axis sharded over the model axis,
    or None for a replicated leaf. Inside an LSTM cell ("cell" in the
    lowercased name) the gate dimension 4U is the axis: a 2-D ``kernel``
    (not a projection) whose last axis divides by 4m shards axis 1, a
    1-D ``bias`` dividing by 4m axis 0; a 2-D ``proj_kernel`` whose first
    axis divides by m shards axis 0. Everything else is replicated, as is
    every leaf without a model axis."""
    m = world.model
    if m == 1:
        return None
    in_cell = "cell" in name.lower()
    if (len(shape) == 2 and in_cell and "kernel" in name
            and "proj" not in name and shape[1] % (4 * m) == 0):
        return 1
    if len(shape) == 2 and "proj_kernel" in name and shape[0] % m == 0:
        return 0
    if (len(shape) == 1 and in_cell and "bias" in name
            and shape[0] % (4 * m) == 0):
        return 0
    return None


def model_block(world: DataWorld, t: torch.Tensor,
                axis: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``axis`` (a view): the model
    index's slice of m equal ones."""
    size = t.shape[axis] // world.model
    return t.narrow(axis, world.model_rank * size, size)


def gather_blocks(world: DataWorld,
                  parts: Sequence[Tuple[torch.Tensor, torch.Tensor, int]]
                  ) -> None:
    """Each ``whole`` of ``parts`` ((whole, this rank's block, axis)) set
    to the model group's blocks: one all-reduce over the model group of
    one float32 buffer, filled with -0.0 and holding this rank's blocks
    (-0.0 is the sum's identity, so the gather is exact, signed zeros
    included)."""
    if not parts:
        return
    flat = torch.full((sum(w.numel() for w, _, _ in parts),), -0.0,
                      dtype=torch.float32, device=parts[0][0].device)
    views, at = [], 0
    for whole, block, axis in parts:
        v = flat[at:at + whole.numel()].view(whole.shape)
        model_block(world, v, axis).copy_(block)
        views.append(v)
        at += whole.numel()
    world.model_sum_(flat)
    with torch.no_grad():
        for (whole, _, _), v in zip(parts, views):
            whole.copy_(v)


def _nets(state) -> list:
    """The ``NetState``s of a GanState (``g``, ``d``) or MseState
    (``net``)."""
    return [getattr(state, k) for k in ("g", "d", "net") if hasattr(state, k)]


def shard_state(world: DataWorld, state, tensor_parallel: bool = False):
    """Place a train state on the world (JAX's ``shard_state``): rank 0's
    state on every rank (``replicate``), and with ``tensor_parallel`` and
    a model axis each net keeps only this rank's model block of the EMA
    and the optimizer's moments of every leaf that
    ``lstm_param_sharding`` shards (``NetState.shard``); its update then
    runs on those blocks. A net without an LSTM cell (the frame models,
    SEGAN) shards nothing. Returns ``state``, changed in place."""
    nets = _nets(state)
    if any(getattr(n, "shards", None) for n in nets):
        raise ValueError("the state is already sharded")
    for net in nets:
        replicate(world, net.tensors())
    if tensor_parallel and world.model > 1:
        for net in nets:
            net.shard(world)
    return state
