"""The weight bridge between the port's modules and flax variable trees.

A module's parameter names are the flax paths joined by dots
(``Dense_0.kernel``, ``lstm_cell_1.proj_kernel``, ``Conv_3.kernel``,
``BatchNorm_0.scale``) and its layouts are flax's, so a flax ``params``
tree copies in by name and back out as the same tree. The running
statistics of ``BatchNorm`` layers are buffers (``BatchNorm_k.mean``,
``.var``): flax keeps them apart in the ``batch_stats`` collection, and so
do ``batch_stats_tree`` and ``load_batch_stats``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from rsrgan_tpu_torch.ops.modules import BatchNorm


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    """Nested dicts -> {"a.b.c": leaf} (the module's parameter names)."""
    flat = {}
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        if isinstance(value, Mapping):
            flat.update(flatten_tree(value, name))
        else:
            flat[name] = value
    return flat


def unflatten_tree(flat: Mapping[str, object]) -> dict:
    """{"a.b.c": leaf} -> nested dicts with every level's keys sorted, the
    order in which ``jax.tree`` rebuilds (and flax then saves) a tree."""
    tree: dict = {}
    for name in sorted(flat):
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = flat[name]

    def sort(node):
        return {k: sort(v) if isinstance(v, dict) else v
                for k, v in sorted(node.items())}

    return sort(tree)


def module_tree(module: nn.Module) -> dict:
    """The module's parameters as a JAX-layout tree of f32 numpy arrays."""
    return unflatten_tree({name: p.detach().float().cpu().numpy()
                           for name, p in module.named_parameters()})


def load_flax_params(module: nn.Module, tree: Mapping) -> None:
    """Copy a JAX parameter tree (nested dicts of numpy arrays, as read
    from a flax checkpoint) into ``module`` by name.

    Every parameter of the module must be in the tree with the same shape
    and every array of the tree must be a parameter of the module, so a
    checkpoint of another model fails here and not as wrong output.
    """
    flat = flatten_tree(tree)
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(flat))
    unexpected = sorted(set(flat) - set(params))
    if missing or unexpected:
        raise KeyError(f"parameter tree mismatch: missing {missing}, "
                       f"unexpected {unexpected}")
    with torch.no_grad():
        for name, param in params.items():
            value = np.array(flat[name], dtype=np.float32)
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"{name}: checkpoint shape {value.shape} "
                                 f"!= module shape {tuple(param.shape)}")
            param.copy_(torch.from_numpy(value).to(param.device))


def _batch_stats(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The running statistics of the module's BatchNorm layers by dotted
    name (``BatchNorm_0.mean``, ``BatchNorm_0.var``, ...)."""
    out = {}
    for prefix, sub in module.named_modules():
        if isinstance(sub, BatchNorm):
            for leaf in ("mean", "var"):
                out[f"{prefix}.{leaf}" if prefix else leaf] = \
                    getattr(sub, leaf)
    return out


def batch_stats_tree(module: nn.Module) -> Optional[dict]:
    """The module's ``batch_stats`` collection as a flax tree of f32 numpy
    arrays, or None for a module without BatchNorm layers."""
    stats = _batch_stats(module)
    if not stats:
        return None
    return unflatten_tree({k: v.detach().float().cpu().numpy()
                           for k, v in stats.items()})


def load_batch_stats(module: nn.Module, tree: Optional[Mapping]) -> None:
    """Copy a flax ``batch_stats`` tree into the module's BatchNorm
    buffers by name; the tree must name every buffer and nothing else
    (None for a module without BatchNorm layers)."""
    stats = _batch_stats(module)
    flat = flatten_tree(tree) if tree is not None else {}
    if sorted(flat) != sorted(stats):
        raise KeyError(f"batch_stats mismatch: "
                       f"{sorted(set(flat) ^ set(stats))}")
    with torch.no_grad():
        for name, buf in stats.items():
            value = np.array(flat[name], dtype=np.float32)
            if tuple(value.shape) != tuple(buf.shape):
                raise ValueError(f"{name}: checkpoint shape {value.shape} "
                                 f"!= module shape {tuple(buf.shape)}")
            buf.copy_(torch.from_numpy(value).to(buf.device))
