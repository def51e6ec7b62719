"""Small layers shared by the models, in flax's parameter names and
layouts: ``Dense`` (``kernel [in, out]``, ``bias``), ``Conv`` (``kernel
[kh, kw, in, out]`` HWIO, ``bias``) and ``BatchNorm`` (``scale``,
``bias``; its running ``mean`` and ``var`` are buffers, flax's
``batch_stats`` collection)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rsrgan_tpu_torch.ops.lstm import glorot_uniform_


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel [in, out]``, ``bias [out]``, f32."""

    def __init__(self, in_dim: int, out_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = nn.Parameter(glorot_uniform_(torch.empty(in_dim,
                                                               out_dim),
                                                   generator))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class Conv(nn.Module):
    """flax ``nn.Conv(features, kernel_size, padding="SAME")`` at stride 1
    on NCHW activations. The kernel keeps flax's HWIO layout (so a flax
    tree loads by name) and is permuted to OIHW for ``conv2d``. "SAME"
    pads ``(k - 1) // 2`` before and ``k // 2`` after along each axis, as
    XLA does; for an even kernel that is one more row after than before."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kh, kw = kernel_size
        self.kernel = nn.Parameter(glorot_uniform_(
            torch.empty(kh, kw, in_ch, out_ch), generator))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        # F.pad's order: last axis (W) first
        self.pads = ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(F.pad(x, self.pads),
                        self.kernel.permute(3, 2, 0, 1), self.bias)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.99)`` (epsilon 1e-5) over
    ``feature_axis``, as a plain function of tensors.

    In train mode it normalises by the batch's statistics, reduced over
    every other axis, with flax's variance E[x^2] - E[x]^2 (biased,
    clipped at 0), and folds them into the running ``mean`` and ``var``
    in place: ``r = momentum * r + (1 - momentum) * batch``. In eval mode
    it normalises by the running statistics. ``torch.nn.BatchNorm*``
    folds the unbiased variance and reads ``momentum`` as 1 - 0.99, so it
    is not used."""

    def __init__(self, features: int, feature_axis: int = -1,
                 momentum: float = 0.99, epsilon: float = 1e-5):
        super().__init__()
        self.feature_axis = feature_axis
        self.momentum, self.epsilon = momentum, epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        axis = self.feature_axis % x.ndim
        shape = [1] * x.ndim
        shape[axis] = x.shape[axis]
        if train:
            axes = tuple(i for i in range(x.ndim) if i != axis)
            mean = x.mean(axes)
            var = torch.clamp(torch.square(x).mean(axes)
                              - torch.square(mean), min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return (x - mean.reshape(shape)) * mul.reshape(shape) \
            + self.bias.reshape(shape)
