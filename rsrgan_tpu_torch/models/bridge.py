"""The weight bridge between the port's modules and flax variable trees.

A module's parameter names are the flax paths joined by dots
(``Dense_0.kernel``, ``lstm_cell_1.proj_kernel``, ``Conv_3.kernel``,
``BatchNorm_0.scale``) and its layouts are flax's, so a flax ``params``
tree copies in by name and back out as the same tree. Statistics that
flax keeps in mutable collections are buffers of the modules that declare
them (``flax_collection``, ``flax_stats``): ``batch_stats`` for
``BatchNorm`` (``BatchNorm_k.mean``, ``.var``) and ``BnLstmCell``
(``cell_k.input_mean``, ...), ``vbn_stats`` for ``VirtualBatchNorm``
(``d_vbn_k.ref_mean``, ``.ref_meansq``). ``collections_tree`` and
``load_collections`` carry them as flax's ``{collection: tree}``;
``batch_stats_tree`` and ``load_batch_stats`` carry one collection.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn


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


def snapshot(t: torch.Tensor) -> np.ndarray:
    """An f32 numpy copy of a tensor: never a view of it, so a tree of
    them keeps its values while a CPU module trains on in place."""
    return t.detach().to("cpu", torch.float32, copy=True).numpy()


def module_tree(module: nn.Module) -> dict:
    """The module's parameters as a JAX-layout tree of f32 numpy arrays
    (copies)."""
    return unflatten_tree({name: snapshot(p)
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


def _collections(module: nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
    """collection -> {dotted buffer name: buffer} over the module's
    submodules that declare a flax collection."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for prefix, sub in module.named_modules():
        collection = getattr(sub, "flax_collection", None)
        if collection is None:
            continue
        for leaf in sub.flax_stats:
            out.setdefault(collection, {})[
                f"{prefix}.{leaf}" if prefix else leaf] = getattr(sub, leaf)
    return out


def _load(stats: Mapping[str, torch.Tensor], tree: Optional[Mapping],
          what: str) -> None:
    flat = flatten_tree(tree) if tree is not None else {}
    if sorted(flat) != sorted(stats):
        raise KeyError(f"{what} mismatch: "
                       f"{sorted(set(flat) ^ set(stats))}")
    with torch.no_grad():
        for name, buf in stats.items():
            value = np.array(flat[name], dtype=np.float32)
            if tuple(value.shape) != tuple(buf.shape):
                raise ValueError(f"{name}: checkpoint shape {value.shape} "
                                 f"!= module shape {tuple(buf.shape)}")
            buf.copy_(torch.from_numpy(value).to(buf.device))


def collections_tree(module: nn.Module) -> Optional[dict]:
    """The module's mutable collections as flax's ``{collection: tree}``
    of f32 numpy arrays (the JAX ``NetState.extra``), or None for a
    module without any."""
    colls = _collections(module)
    if not colls:
        return None
    return {name: unflatten_tree({k: snapshot(v) for k, v in stats.items()})
            for name, stats in sorted(colls.items())}


def load_collections(module: nn.Module, tree: Optional[Mapping]) -> None:
    """Copy a flax ``{collection: tree}`` (a JAX ``NetState.extra``) into
    the module's buffers by name; it must name every collection and
    buffer of the module and nothing else (None for a module without
    any)."""
    colls = _collections(module)
    tree = tree or {}
    if sorted(tree) != sorted(colls):
        raise KeyError(f"mutable collections mismatch: checkpoint "
                       f"{sorted(tree)}, module {sorted(colls)}")
    for name, stats in colls.items():
        _load(stats, tree[name], name)


def batch_stats_tree(module: nn.Module) -> Optional[dict]:
    """The module's ``batch_stats`` collection as a flax tree of f32 numpy
    arrays, or None for a module without BatchNorm or BnLstm layers."""
    return (collections_tree(module) or {}).get("batch_stats")


def load_batch_stats(module: nn.Module, tree: Optional[Mapping]) -> None:
    """Copy a flax ``batch_stats`` tree into the module's buffers by name;
    the tree must name every buffer and nothing else (None for a module
    without any)."""
    _load(_collections(module).get("batch_stats", {}), tree, "batch_stats")
