"""The frame generators DNN, R-CED and CNN (``rsrgan_tpu/models/
feedforward.py``).

A frame model maps spliced frames ``[B, splice * input_dim]`` to
``[B, output_dim]``; a 3-D ``[1, T, D]`` input (one utterance) is
squeezed to its frames and the output gets its leading 1 back. They run
in f32 (the JAX CLI builds the frame trainers in f32 whatever ``--bf16``
says). Parameter names are flax's automatic ones (``Dense_k``,
``Conv_k``, ``BatchNorm_k``, numbered by kind in call order), so a flax
tree loads by name (``load_flax_params``, ``load_batch_stats``).

The convolutions run NCHW on ``torch.nn.functional.conv2d``. The JAX
models are NHWC and flatten ``[B, H, W, C]`` before their dense layer, so
the port permutes to NHWC before it flattens: flattening NCHW would
permute ``Dense_0``'s rows. The products and convolutions are plain XLA
ops in the JAX package, not Pallas kernels.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from rsrgan_tpu_torch.ops.common import MaskSource, dropout
from rsrgan_tpu_torch.ops.modules import BatchNorm, Conv, Dense


def _as_frames(inputs: torch.Tensor) -> torch.Tensor:
    if inputs.ndim == 3:
        if inputs.shape[0] != 1:
            raise ValueError("a 3-D input must be a [1, T, D] utterance, got "
                             f"{tuple(inputs.shape)}")
        return inputs[0]
    return inputs


def _as_input_rank(y: torch.Tensor, inputs: torch.Tensor) -> torch.Tensor:
    return y[None] if inputs.ndim == 3 else y


class DnnGenerator(nn.Module):
    """``Dense(units)`` [+ BatchNorm] + ReLU [+ dropout], ``1 +
    hidden_layers`` times, then a linear ``Dense(output_dim)``."""

    def __init__(self, input_dim: int, output_dim: int, units: int = 1024,
                 hidden_layers: int = 3, keep_prob: float = 1.0,
                 batch_norm: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.keep_prob = keep_prob
        self.batch_norm = batch_norm
        self.num_hidden = 1 + hidden_layers
        width = input_dim
        for k in range(self.num_hidden):
            self.add_module(f"Dense_{k}", Dense(width, units, generator))
            if batch_norm:
                self.add_module(f"BatchNorm_{k}", BatchNorm(units))
            width = units
        self.add_module(f"Dense_{self.num_hidden}",
                        Dense(width, output_dim, generator))

    def forward(self, inputs: torch.Tensor,
                lengths: Optional[torch.Tensor] = None, train: bool = False,
                masks: Optional[MaskSource] = None) -> torch.Tensor:
        """``lengths`` is unused (frames); ``masks``: the dropout's mask
        source, used in train mode with ``keep_prob < 1``."""
        h = _as_frames(inputs)
        for k in range(self.num_hidden):
            h = getattr(self, f"Dense_{k}")(h)
            if self.batch_norm:
                h = getattr(self, f"BatchNorm_{k}")(h, train)
            h = torch.relu(h)
            if train and self.keep_prob < 1.0:
                h = dropout(h, self.keep_prob, masks)
        y = getattr(self, f"Dense_{self.num_hidden}")(h)
        return _as_input_rank(y, inputs)


class _ConvStack(nn.Module):
    """The conv part of R-CED and CNN: the frames as one-channel
    ``splice x input_dim`` images, ``Conv`` [+ BatchNorm] + ReLU per
    layer, flattened in flax's H, W, C order."""

    def __init__(self, input_dim: int, splice: int,
                 filters: Sequence[int], widths: Sequence[int],
                 batch_norm: bool, generator: Optional[torch.Generator]):
        super().__init__()
        self.input_dim, self.splice = input_dim, splice
        self.batch_norm = batch_norm
        self.num_convs = len(filters)
        in_ch = 1
        for k, (n, w) in enumerate(zip(filters, widths)):
            self.add_module(f"Conv_{k}", Conv(in_ch, n, (splice, w),
                                              generator))
            if batch_norm:
                self.add_module(f"BatchNorm_{k}", BatchNorm(n,
                                                            feature_axis=1))
            in_ch = n
        self.flat_dim = splice * input_dim * in_ch

    def features(self, frames: torch.Tensor, train: bool) -> torch.Tensor:
        b = frames.shape[0]
        h = frames.reshape(b, 1, self.splice, self.input_dim)
        for k in range(self.num_convs):
            h = getattr(self, f"Conv_{k}")(h)
            if self.batch_norm:
                h = getattr(self, f"BatchNorm_{k}")(h, train)
            h = torch.relu(h)
        return h.permute(0, 2, 3, 1).reshape(b, self.flat_dim)


class RcedGenerator(_ConvStack):
    """Redundant convolutional encoder-decoder: 9 ``Conv`` layers with
    kernels ``(splice, w)`` over ``[splice, input_dim]`` images, then a
    linear ``Dense(output_dim)`` with its bias set to 0.1."""

    def __init__(self, input_dim: int, splice: int, output_dim: int,
                 filters_num: Sequence[int] = (12, 16, 20, 24, 32, 24, 20,
                                               16, 12),
                 filters_width: Sequence[int] = (13, 11, 9, 7, 7, 7, 9, 11,
                                                 13),
                 batch_norm: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_dim, splice, filters_num, filters_width,
                         batch_norm, generator)
        self.Dense_0 = Dense(self.flat_dim, output_dim, generator)
        with torch.no_grad():
            self.Dense_0.bias.fill_(0.1)

    def forward(self, inputs: torch.Tensor,
                lengths: Optional[torch.Tensor] = None, train: bool = False,
                masks: Optional[MaskSource] = None) -> torch.Tensor:
        y = self.Dense_0(self.features(_as_frames(inputs), train))
        return _as_input_rank(y, inputs)


class CnnGenerator(_ConvStack):
    """Two ``Conv`` + ReLU layers of ``(splice, filters_width)`` kernels,
    then ``Dense(1024)`` + ReLU and a linear ``Dense(output_dim)``. No
    batch norm (the JAX model has none)."""

    def __init__(self, input_dim: int, splice: int, output_dim: int,
                 filters_num: Sequence[int] = (32, 64),
                 filters_width: int = 11,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_dim, splice, filters_num,
                         [filters_width] * len(filters_num), False,
                         generator)
        self.Dense_0 = Dense(self.flat_dim, 1024, generator)
        self.Dense_1 = Dense(1024, output_dim, generator)

    def forward(self, inputs: torch.Tensor,
                lengths: Optional[torch.Tensor] = None, train: bool = False,
                masks: Optional[MaskSource] = None) -> torch.Tensor:
        h = self.features(_as_frames(inputs), train)
        y = self.Dense_1(torch.relu(self.Dense_0(h)))
        return _as_input_rank(y, inputs)
