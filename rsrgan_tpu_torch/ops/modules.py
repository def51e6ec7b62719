"""Small layers shared by the models, in flax's parameter names and
layouts: ``Dense`` (``kernel [in, out]``, ``bias``), ``Conv`` (``kernel
[kh, kw, in, out]`` HWIO, ``bias``), the 1-D ``Conv1d`` and
``ConvTranspose1d`` (``kernel [k, in, out]``, ``bias``) and ``BatchNorm``
(``scale``, ``bias``; its running ``mean`` and ``var`` are buffers,
flax's ``batch_stats`` collection).

A module whose buffers are a flax mutable collection names it in the
class attribute ``flax_collection`` and its buffers in ``flax_stats``;
``models/bridge.py`` carries them in and out of flax trees.

Every ``Conv1d`` and ``ConvTranspose1d`` forward is counted by shape in
``conv_calls`` (``spans.count_launch``, as the hand kernels' wrappers
count their launches; the key is ``conv_key``'s), from which the
benchmark bounds the convolutions' time."""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rsrgan_tpu_torch import spans
from rsrgan_tpu_torch.ops.lstm import glorot_uniform_
from rsrgan_tpu_torch.parallel.mesh import global_moments


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


def truncated_normal_(t: torch.Tensor, stddev: float,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """In-place flax ``truncated_normal(stddev)``: a normal cut at two
    standard deviations, scaled so that what remains has ``stddev``."""
    std = stddev / 0.87962566103423978
    with torch.no_grad():
        u = torch.empty(t.shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(u, 0.0, std, -2 * std, 2 * std,
                                    generator=generator)
        t.copy_(u)
    return t


def same_pads(length: int, kwidth: int, stride: int = 1,
              dilation: int = 1) -> Tuple[int, int]:
    """XLA's "SAME" padding of one axis (``lax.padtype_to_pads``): the
    output has ceil(length / stride) positions, and the total padding
    ``max((out - 1) * stride + (kwidth - 1) * dilation + 1 - length, 0)``
    splits ``total // 2`` before and the rest after."""
    out = -(-length // stride)
    total = max((out - 1) * stride + (kwidth - 1) * dilation + 1 - length,
                0)
    return total // 2, total - total // 2


def conv_transpose_pads(kwidth: int, stride: int) -> Tuple[int, int]:
    """``lax._conv_transpose_padding(kwidth, stride, "SAME")``: the pads
    of the stride-dilated input in ``lax.conv_transpose``."""
    pad_len = kwidth + stride - 2
    pad_a = kwidth - 1 if stride > kwidth - 1 else math.ceil(pad_len / 2)
    return pad_a, pad_len - pad_a


# the 1-D convolutions' library calls in this process, by ``conv_key``
conv_calls = SimpleNamespace(launches=0, launches_by_shape={})


def conv_key(x: torch.Tensor, kernel: torch.Tensor, stride: int,
             transposed: bool) -> str:
    """A 1-D convolution's shape key: in and out channels, width, stride,
    input length and rows, whether it is transposed, whether autograd
    records it for a backward (``grad``), and whether that backward
    would take the input's gradient (``dx``). Which kernels get a
    gradient is up to the ``autograd.grad`` call that runs the backward,
    so the key does not say it."""
    k, c_in, c_out = kernel.shape
    grad = torch.is_grad_enabled() and (x.requires_grad
                                        or kernel.requires_grad)
    return (f"in={c_in},out={c_out},k={k},stride={stride},L={x.shape[-1]},"
            f"rows={x.shape[0]},transposed={int(transposed)},"
            f"grad={int(grad)},dx={int(grad and x.requires_grad)}")


class Conv1d(nn.Module):
    """flax ``nn.Conv(out_ch, (kwidth,), strides=(stride,),
    kernel_dilation=(dilation,), padding="SAME")`` on ``[B, C, L]``
    activations (flax's are ``[B, L, C]``). The kernel keeps flax's
    ``[k, in, out]`` layout and is permuted for ``conv1d``; the padding is
    ``same_pads`` of the input's length, asymmetric where the total is
    odd (an even kernel, or a stride that does not divide). Kernel init:
    truncated normal of ``stddev``."""

    def __init__(self, in_ch: int, out_ch: int, kwidth: int,
                 stride: int = 1, dilation: int = 1, use_bias: bool = True,
                 stddev: float = 0.02,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kwidth, self.stride, self.dilation = kwidth, stride, dilation
        self.kernel = nn.Parameter(truncated_normal_(
            torch.empty(kwidth, in_ch, out_ch), stddev, generator))
        self.bias = (nn.Parameter(torch.zeros(out_ch)) if use_bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spans.count_launch(conv_calls, conv_key(x, self.kernel, self.stride,
                                                False))
        pads = same_pads(x.shape[-1], self.kwidth, self.stride,
                         self.dilation)
        return F.conv1d(F.pad(x, pads), self.kernel.permute(2, 1, 0),
                        self.bias, stride=self.stride,
                        dilation=self.dilation)


class ConvTranspose1d(nn.Module):
    """flax ``nn.ConvTranspose(out_ch, (kwidth,), strides=(stride,),
    padding="SAME")`` on ``[B, C, L]`` activations: ``lax.conv_transpose``
    with ``transpose_kernel=False``, i.e. a correlation of the
    stride-dilated input, padded ``conv_transpose_pads``, with the kernel
    as it is, giving ``L * stride`` positions.

    ``F.conv_transpose1d`` scatters each input through the kernel instead,
    which is that correlation with the kernel reversed along its width.
    Output position o of the correlation is position o + (k - 1 - pad_a)
    of ``conv_transpose1d``, so its ``padding`` is k - 1 - pad_a and its
    ``output_padding`` pad_b - pad_a; where that is negative (an odd
    kernel) the surplus last position is cut off instead."""

    def __init__(self, in_ch: int, out_ch: int, kwidth: int, stride: int,
                 use_bias: bool = True, stddev: float = 0.02,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride = stride
        pad_a, pad_b = conv_transpose_pads(kwidth, stride)
        self.padding = kwidth - 1 - pad_a
        self.extra = pad_b - pad_a     # output_padding, or a cut if < 0
        self.kernel = nn.Parameter(truncated_normal_(
            torch.empty(kwidth, in_ch, out_ch), stddev, generator))
        self.bias = (nn.Parameter(torch.zeros(out_ch)) if use_bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spans.count_launch(conv_calls, conv_key(x, self.kernel, self.stride,
                                                True))
        y = F.conv_transpose1d(
            x, self.kernel.flip(0).permute(1, 2, 0), self.bias,
            stride=self.stride, padding=self.padding,
            output_padding=max(self.extra, 0))
        return y[..., :x.shape[-1] * self.stride] if self.extra < 0 else y


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
    is not used. In a data-parallel world the batch's statistics are the
    global batch's (``global_moments``), as under JAX's mesh, and the
    running statistics come out equal on every rank."""

    flax_collection = "batch_stats"
    flax_stats = ("mean", "var")

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
            mean, mean_sq = global_moments(x, axes)
            var = torch.clamp(mean_sq - torch.square(mean), min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return (x - mean.reshape(shape)) * mul.reshape(shape) \
            + self.bias.reshape(shape)
