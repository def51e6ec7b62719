"""Optimizers, per-tensor clipping and EMA as plain tensor code
(counterpart of ``rsrgan_tpu/training/state.py``).

The JAX package chains optax's transforms: each gradient tensor is
clipped to ``max_grad_norm`` (``tf.clip_by_norm``), then transformed (TF
Adam with bias correction and eps outside the square root, identity for
SGD, RMSProp), then ``params - lr * update``, then the EMA shadow
``e - (1 - decay) * (e - p)``. ``torch.optim`` keeps another state layout
and orders the operations otherwise, so the port writes them out. The
optimizer state keeps optax's layout, so that a checkpoint carries it
both ways: ``{"count": int32 [], "mu": {...}, "nu": {...}}`` for Adam,
``{"nu": {...}}`` for RMSProp, nothing for SGD; trees are dicts keyed by
the parameter's dotted name. Updates are in place. A module's mutable
collections (flax's ``batch_stats`` of BatchNorm and BnLstm layers, the
``vbn_stats`` of virtual batch norm) are its buffers: ``NetState.extra``
reads them as the JAX ``NetState.extra`` tree, outside the EMA and the
optimizer.

Tensor parallelism (``parallel.shard_state(..., tensor_parallel=True)``):
``NetState.shard`` keeps this rank's model block of the EMA shadow and of
the optimizer's moments of every leaf that ``lstm_param_sharding``
shards. The update then runs: the data group's mean (``world_mean``, in
the trainer), the per-tensor clip of the whole gradient (a block's norm
would clip otherwise), this rank's block, the optimizer and the EMA on
the block, and the blocks gathered back into the module's whole
parameter over the model group (``gather_blocks``, exact). Every step
after the clip is elementwise, so the step equals the data-parallel one
bit for bit.

On the card (``ops/optim.py``, ``csrc/optim.cu``) the update of a state
that is not sharded is one multi-tensor kernel for the clip's partial
norms and Adam's step count and one for the rest: the same arithmetic in
the same order, bit for bit given the same norms, with Adam's bias
correction computed on the card. It takes contiguous f32 parameters,
moments and shadow and f32 gradients (a strided one is copied to its
leaf's order) and raises on anything else. The plain tensor code below
is the kernel's twin and the update of the CPU and of tensor-parallel
states (``fused_path``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from rsrgan_tpu_torch import spans
from rsrgan_tpu_torch.models.bridge import (collections_tree,
                                            load_collections)
from rsrgan_tpu_torch.ops import optim
from rsrgan_tpu_torch.parallel.mesh import (all_reduce_mean, current_world,
                                            gather_blocks,
                                            lstm_param_sharding,
                                            model_block)

Tree = Dict[str, torch.Tensor]


def clip_by_norm_each(grads: Tree, max_norm: Optional[float]) -> Tree:
    """t * max_norm / max(||t||, max_norm) for every tensor."""
    if max_norm is None:
        return grads
    out = {}
    for name, g in grads.items():
        norm = torch.sqrt(torch.sum(torch.square(g)))
        out[name] = g * (max_norm / torch.clamp(norm, min=max_norm))
    return out


class Adam:
    """optax ``scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)``."""

    name = "adam"

    def __init__(self, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Tree) -> dict:
        device = next(iter(params.values())).device
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(self, grads: Tree, state: dict) -> Tree:
        count = state["count"] + 1
        state["count"] = count.to(torch.int32)
        c = count.to(torch.float32)
        if c.device.type != "cpu":
            # the two scalars below are copied from pageable memory
            spans.count("host_wait", 2)
        bc1 = 1.0 - torch.pow(torch.tensor(self.b1, device=c.device), c)
        bc2 = 1.0 - torch.pow(torch.tensor(self.b2, device=c.device), c)
        updates = {}
        for k, g in grads.items():
            mu = (1.0 - self.b1) * g + self.b1 * state["mu"][k]
            nu = (1.0 - self.b2) * (g ** 2) + self.b2 * state["nu"][k]
            state["mu"][k], state["nu"][k] = mu, nu
            updates[k] = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
        return updates


class Sgd:
    """optax ``identity()``: the update is the (clipped) gradient."""

    name = "sgd"

    def init(self, params: Tree) -> dict:
        return {}

    def update(self, grads: Tree, state: dict) -> Tree:
        return grads


class RmsProp:
    """optax ``scale_by_rms(decay=0.9, eps=1e-10)`` (TF RMSProp defaults,
    optax's eps inside the square root, no bias correction)."""

    name = "rmsprop"

    def __init__(self, decay: float = 0.9, eps: float = 1e-10):
        self.decay, self.eps = decay, eps

    def init(self, params: Tree) -> dict:
        return {"nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(self, grads: Tree, state: dict) -> Tree:
        updates = {}
        for k, g in grads.items():
            nu = (1.0 - self.decay) * (g ** 2) + self.decay * state["nu"][k]
            state["nu"][k] = nu
            updates[k] = torch.rsqrt(nu + self.eps) * g
        return updates


def world_mean(grads: Tree, metrics: Tree) -> tuple:
    """An update's gradients and metrics averaged over the data world, in
    one all-reduce (the identity in one process): the gradient and the
    losses of the global batch, as JAX's mesh psums them. It comes before
    the per-tensor clip, which then clips the global gradient."""
    tree = {**{"grad/" + k: v for k, v in grads.items()},
            **{"metric/" + k: v for k, v in metrics.items()}}
    tree = all_reduce_mean(current_world(), tree)
    return ({k: tree["grad/" + k] for k in grads},
            {k: tree["metric/" + k] for k in metrics})


def fused_path(device: torch.device, sharded: bool) -> bool:
    """Whether ``NetState.apply_gradients`` runs csrc/optim.cu: for every
    state on the card but a tensor-parallel one. That one keeps the plain
    per-leaf code by design: its clip reads the whole gradients and its
    update this rank's blocks, cut and gathered around it (no benchmark
    cell runs it)."""
    return device.type == "cuda" and not sharded


def make_optimizer(name: str):
    if name == "adam":
        return Adam()
    if name == "sgd":
        return Sgd()
    if name == "rmsprop":
        return RmsProp()
    raise ValueError(f"unknown optimizer {name}")


class NetState:
    """One network's trainable state: the module (its parameters), the
    optimizer and its state, and the EMA shadow of every parameter.
    ``shards``: {parameter name: sharded axis} of a tensor-parallel state
    (``shard``), whose EMA and moments of those leaves are this rank's
    model blocks; empty otherwise."""

    def __init__(self, module: nn.Module, optimizer: str,
                 max_grad_norm: Optional[float]):
        self.module = module
        self.tx = make_optimizer(optimizer)
        self.max_grad_norm = max_grad_norm
        self.shards: Dict[str, int] = {}
        # the fused update and the storages it was made for (``apply_fused``)
        self._fused_key: Optional[tuple] = None
        self._fused_update: Optional[optim.FusedUpdate] = None
        with torch.no_grad():
            self.opt_state = self.tx.init(self.params())
            self.ema = {k: p.detach().clone()
                        for k, p in self.params().items()}

    def params(self) -> Tree:
        return dict(self.module.named_parameters())

    def extra(self) -> Optional[dict]:
        """The JAX ``NetState.extra``: ``{collection: tree}`` of numpy
        arrays (``batch_stats``, ``vbn_stats``) for a module with mutable
        collections, else None. A train-mode forward updates
        ``batch_stats`` in place; the EMA and the optimizer never see
        them."""
        return collections_tree(self.module)

    def tensors(self) -> list:
        """Every tensor of the state, in a fixed order: parameters,
        buffers (the mutable collections), the EMA shadow and the
        optimizer's state (``parallel.replicate`` sends them from rank
        0)."""
        out = list(self.module.parameters()) + list(self.module.buffers())
        out += list(self.ema.values())
        stack = [self.opt_state]
        while stack:
            for v in stack.pop().values():
                if isinstance(v, dict):
                    stack.append(v)
                else:
                    out.append(v)
        return out

    def load_extra(self, extra: Optional[dict]) -> None:
        """Copy a JAX ``NetState.extra`` tree into the module's buffers;
        None for a module without any."""
        load_collections(self.module, extra)

    # -- tensor parallelism ---------------------------------------------------

    def shard(self, world) -> None:
        """Keep only ``world``'s model block of the EMA and of the
        optimizer's moments (Adam ``mu``/``nu``, RMSProp ``nu``) of every
        parameter that ``lstm_param_sharding`` shards; the module keeps
        its whole parameters."""
        self.shards = {}
        for k, p in self.params().items():
            axis = lstm_param_sharding(world, k, tuple(p.shape))
            if axis is not None:
                self.shards[k] = axis
        self.ema = self.blocks(self.ema, world)
        for field in ("mu", "nu"):
            if field in self.opt_state:
                self.opt_state[field] = self.blocks(self.opt_state[field],
                                                    world)

    @torch.no_grad()
    def blocks(self, tree: Tree, world=None) -> Tree:
        """``tree`` (whole tensors by parameter name) with each sharded
        leaf cut to the block of this rank of ``world`` (default: the
        current world), a contiguous copy."""
        world = current_world() if world is None else world
        return {k: model_block(world, v, self.shards[k]).clone()
                if k in self.shards else v for k, v in tree.items()}

    @torch.no_grad()
    def wholes(self, tree: Tree) -> Tree:
        """``tree`` with each sharded leaf's block gathered into the whole
        tensor over the model group: a collective that every rank of the
        group makes. ``tree`` itself when nothing is sharded."""
        if not self.shards:
            return tree
        out, parts = dict(tree), []
        for k, axis in self.shards.items():
            out[k] = torch.empty_like(self.module.get_parameter(k))
            parts.append((out[k], tree[k], axis))
        gather_blocks(current_world(), parts)
        return out

    def whole_opt_state(self) -> dict:
        """The optimizer's state with whole moments (``wholes``)."""
        return {f: self.wholes(v) if f in ("mu", "nu") else v
                for f, v in self.opt_state.items()}

    @torch.no_grad()
    def apply_gradients(self, grads: Tree, lr: float,
                        ema_decay: float) -> None:
        params = self.params()
        first = next(iter(params.values()), None)
        if first is not None and fused_path(first.device, bool(self.shards)):
            self.apply_fused(params, grads, lr, ema_decay)
        else:
            self.apply_plain(params, grads, lr, ema_decay)

    @torch.no_grad()
    def apply_fused(self, params: Tree, grads: Tree, lr: float,
                    ema_decay: float) -> None:
        """The update through csrc/optim.cu (``optim.FusedUpdate``), made
        again (its tables copied to the card) when the storage of a
        parameter, moment or shadow changed; raises ValueError where a
        tensor does not fit the kernel."""
        spans.count("opt.fused")
        with spans.span("opt.setup"):
            mu, nu = self.opt_state.get("mu"), self.opt_state.get("nu")
            leaves = {k: (p, None if mu is None else mu[k],
                          None if nu is None else nu[k], self.ema[k])
                      for k, p in params.items()}
            key = tuple(0 if t is None else t.data_ptr()
                        for leaf in leaves.values() for t in leaf)
            if key != self._fused_key:
                self._fused_update = optim.FusedUpdate(
                    leaves, self.tx.name, vars(self.tx))
                self._fused_key = key
            fused = self._fused_update
            fused.take_grads([grads[k] for k in params])
        fused.apply(list(params.values()), self.opt_state.get("count"), lr,
                    ema_decay, self.max_grad_norm)

    @torch.no_grad()
    def apply_plain(self, params: Tree, grads: Tree, lr: float,
                    ema_decay: float) -> None:
        """The plain per-leaf update: the clip, the transform, the step and
        the EMA, one PyTorch kernel per leaf and operation."""
        spans.count("opt.plain")
        with spans.span("opt.clip"):
            grads = clip_by_norm_each(grads, self.max_grad_norm)
            if self.shards:
                grads = self.blocks(grads)
        with spans.span("opt.update"):
            updates = self.tx.update(grads, self.opt_state)
        with spans.span("opt.apply"):
            gathered = []
            for k, p in params.items():
                if k in self.shards:
                    whole, axis = p, self.shards[k]
                    p = model_block(current_world(), whole, axis).clone()
                    gathered.append((whole, p, axis))
                p.sub_(lr * updates[k])
                e = self.ema[k]
                e.sub_((1.0 - ema_decay) * (e - p))
            gather_blocks(current_world(), gathered)
