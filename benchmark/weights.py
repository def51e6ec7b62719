"""Seeded weights in the JAX layout, made on the device.

Every kernel, projection and peephole is N(0, ``scale``) and every bias
zero, as the JAX package's ``kernel_bench.make_params`` draws them. One
net's draws are one call on one generator (``stream`` of the run's seed)
into a flat buffer, cut into leaves in the order of ``shapes``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from benchmark.harness import stream_seed

SCALE = 0.05


def is_bias(name: str) -> bool:
    return name.rsplit(".", 1)[-1] == "bias"


def make(shapes: Dict[str, Tuple[int, ...]], seed: int, stream: int,
         device, scale: float = SCALE) -> Dict[str, torch.Tensor]:
    """``{name: f32 tensor}`` on ``device`` for ``shapes`` (dotted JAX
    names); the same seed and stream give the same values."""
    drawn = [(n, s) for n, s in shapes.items() if not is_bias(n)]
    total = sum(torch.Size(s).numel() for _, s in drawn)
    gen = torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream))
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.normal_(0.0, scale, generator=gen)
    out, at = {}, 0
    for name, shape in shapes.items():
        if is_bias(name):
            out[name] = torch.zeros(shape, dtype=torch.float32,
                                    device=device)
            continue
        n = torch.Size(shape).numel()
        out[name] = flat[at:at + n].view(shape).clone()
        at += n
    return out


def load(module: torch.nn.Module, tree: Dict[str, torch.Tensor]) -> None:
    """Copy ``tree`` into ``module``'s parameters by name; every parameter
    must be named, with its shape."""
    params = dict(module.named_parameters())
    if set(params) != set(tree):
        raise KeyError(f"weights {sorted(set(tree) ^ set(params))} do not "
                       "match the module's parameters")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(tree[name].shape):
                raise ValueError(f"{name}: {tuple(tree[name].shape)} vs "
                                 f"{tuple(p.shape)}")
            p.copy_(tree[name])
