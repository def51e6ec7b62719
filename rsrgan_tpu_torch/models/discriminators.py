"""The discriminators (counterpart of ``rsrgan_tpu/models/
discriminators.py``): the sequence LSTM-D and the frame DNN-D.

Parameter names and layouts are the JAX ones (``StackedLstm_0/cell_{0,1}``
and ``Dense_0`` for LSTM-D, ``Dense_{0..4}`` for DNN-D), so a flax
checkpoint's D tree loads by name.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
from torch import nn

from rsrgan_tpu_torch.ops.common import MaskSource, dropout, gaussian_noise
from rsrgan_tpu_torch.ops.lstm import StackedLstm
from rsrgan_tpu_torch.ops.modules import Dense


class LstmDiscriminator(nn.Module):
    """Gaussian input noise, 2 x LSTM(256, proj 40, peepholes), then a
    per-frame dense logit: [B, T, D] -> [B, T, 1].

    With ``lstm_impl="wavefront"`` a call of at least
    ``WAVEFRONT_MIN_ROWS`` rows runs both layers in one wavefront launch;
    smaller calls (the train step's B and 2B rows at B=16) run per layer
    on the single-layer kernels (K1 forward, K2/K3 backward). The choice
    is made per call shape, as in the JAX package. With ``keep_prob < 1``
    a train-mode call drops out after each layer (``StackedLstm``), per
    layer at any row count.
    """

    WAVEFRONT_MIN_ROWS = 64

    def __init__(self, input_dim: int = 40, cell_size: int = 256,
                 num_projection: int = 40, num_layers: int = 2,
                 keep_prob: float = 1.0,
                 compute_dtype: torch.dtype = torch.float32,
                 lstm_impl: str = "scan",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lstm_impl = lstm_impl
        self.StackedLstm_0 = StackedLstm(
            input_dim, num_layers, cell_size, num_projection,
            compute_dtype=compute_dtype, dropout_keep_prob=keep_prob,
            lstm_impl=lstm_impl, generator=generator)
        self.Dense_0 = Dense(num_projection, 1, generator)

    def forward(self, inputs: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                noise_std: float = 0.0, train: bool = False,
                noise: Union[torch.Generator, torch.Tensor, None] = None,
                masks: Optional[MaskSource] = None) -> torch.Tensor:
        """``noise``: a generator to draw the input noise from, the
        standard-normal draws themselves, or None for no noise (the JAX
        module adds noise whenever it is given a 'noise' rng); ``masks``:
        the dropout's mask source, used in train mode only."""
        h = gaussian_noise(inputs, noise_std, noise)
        impl = self.lstm_impl
        if impl == "wavefront" and inputs.shape[0] < self.WAVEFRONT_MIN_ROWS:
            impl = "pallas"
        return self.Dense_0(self.StackedLstm_0(h, lengths, train, impl,
                                               masks))


class DnnDiscriminator(nn.Module):
    """The frame discriminator: ``Dense(units)`` + ReLU [+ dropout],
    ``1 + hidden_layers`` times, their kernels drawn from a normal
    truncated to 2 standard deviations and scaled by sqrt(2 / units)
    (jax's ``truncated_normal``), then a glorot ``Dense(1)`` clipped to
    [-0.5, 1.5]: ``[B, input_dim] -> [B, 1]``. No input noise, no
    lengths."""

    def __init__(self, input_dim: int, units: int = 1024,
                 hidden_layers: int = 3, keep_prob: float = 1.0,
                 clip_output: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.keep_prob = keep_prob
        self.clip_output = clip_output
        self.num_hidden = 1 + hidden_layers
        stddev = math.sqrt(2.0 / units)
        width = input_dim
        for k in range(self.num_hidden):
            layer = Dense(width, units, generator)
            with torch.no_grad():
                nn.init.trunc_normal_(layer.kernel, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                layer.kernel.mul_(stddev)
            self.add_module(f"Dense_{k}", layer)
            width = units
        self.add_module(f"Dense_{self.num_hidden}",
                        Dense(width, 1, generator))

    def forward(self, inputs: torch.Tensor, train: bool = False,
                masks: Optional[MaskSource] = None) -> torch.Tensor:
        """``masks``: the dropout's mask source, used in train mode with
        ``keep_prob < 1``."""
        h = inputs
        for k in range(self.num_hidden):
            h = torch.relu(getattr(self, f"Dense_{k}")(h))
            if train and self.keep_prob < 1.0:
                h = dropout(h, self.keep_prob, masks)
        y = getattr(self, f"Dense_{self.num_hidden}")(h)
        return torch.clamp(y, -0.5, 1.5) if self.clip_output else y
