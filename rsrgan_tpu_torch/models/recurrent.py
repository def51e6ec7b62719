"""The recurrent generators (``rsrgan_tpu/models/recurrent.py``
``LstmGenerator``, ``BnLstmGenerator`` and the ``ResLstmGenerator``
family).

Parameter names and layouts are the JAX ones (``lstm_cell_{1..4}/{kernel,
bias,proj_kernel,w_i_diag,w_f_diag,w_o_diag}``, ``forward_out/{kernel,
bias}``; ``Dense_0``, ``StackedLstm_0/cell_{0,1,2}``, ``Dense_1``;
``kernel [D+P, 4U]``, dense ``kernel [in, out]``), so ``load_flax_params``
(``models/bridge.py``) copies a flax checkpoint's G tree in by name. The
JAX package needs a parameter-only ``_CellParams`` twin to give the
wavefront path the scan path's tree; here ``LstmCellP`` holds the
parameters and serves both paths. ``BnLstmGenerator``'s cells are
``cell_{0,1,2}`` with their own names (``input_kernel``,
``state_kernel``, ...) and ``batch_stats`` buffers (``ops/bnlstm.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rsrgan_tpu_torch.ops.bnlstm import BnLstmCell
from rsrgan_tpu_torch.ops.common import MaskSource, dropout, leakyrelu
from rsrgan_tpu_torch.ops.lstm import LstmCellP, StackedLstm
from rsrgan_tpu_torch.ops.modules import Dense
from rsrgan_tpu_torch.ops.wavefront_stack import lstm_stack_wavefront


class ResLstmGenerator(nn.Module):
    """The residual-LSTM family; ``variant`` selects the wiring:

    * "base": 4 stacked LSTM(760, proj=input_dim), no residual
    * "i": 2 layers, input residual — every layer input and the output
      tap add the ORIGINAL inputs
    * "l" (flagship): 4 layers, layer residual — inputs_{k+1} =
      outputs_k + inputs_k, out from outputs4 + inputs4

    ``lstm_impl="wavefront"`` runs "l" and "base" on the wavefront kernel
    (its plain twin for CPU tensors) and "i" per layer on the single-layer
    kernels (the wavefront's per-layer hand-off cannot tap the original
    inputs at the top); "pallas" runs every variant per layer on the
    single-layer kernels (K1 forward, K2/K3 backward); "scan" runs the
    eager cell under autograd. ``train=True`` keeps what the backward
    needs; ``train=False`` (decode) runs without autograd.

    With ``keep_prob < 1`` a train-mode forward drops out each cell's
    output before the residual add (masks from ``masks``), and so runs
    every wiring per layer on the single-layer kernels (the wavefront has
    no dropout points), as the JAX module does; decode keeps the
    wavefront.
    """

    def __init__(self, input_dim: int, output_dim: int, variant: str = "l",
                 cell_size: int = 760, keep_prob: float = 1.0,
                 compute_dtype: torch.dtype = torch.float32,
                 lstm_impl: str = "wavefront",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if variant not in ("l", "base", "i"):
            raise ValueError(f"unknown res_lstm variant {variant}")
        if lstm_impl not in ("wavefront", "pallas", "scan"):
            raise ValueError(f"unknown lstm_impl {lstm_impl}")
        self.variant = variant
        self.keep_prob = keep_prob
        self.lstm_impl = lstm_impl
        self.compute_dtype = compute_dtype
        self.num_layers = 2 if variant == "i" else 4
        P = input_dim  # num_proj equals the input dim so residuals add
        for k in range(self.num_layers):
            self.add_module(f"lstm_cell_{k + 1}",
                            LstmCellP(P, cell_size, P,
                                      compute_dtype=compute_dtype,
                                      lstm_impl=("scan" if lstm_impl == "scan"
                                                 else "pallas"),
                                      generator=generator))
        self.forward_out = Dense(P, output_dim, generator)

    def cells(self):
        return [getattr(self, f"lstm_cell_{k + 1}")
                for k in range(self.num_layers)]

    def forward(self, inputs: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                train: bool = False,
                masks: Optional[MaskSource] = None) -> torch.Tensor:
        """[B, T, D] features, [B] lengths -> [B, T, output_dim];
        ``masks``: the dropout's mask source (``ops.common.dropout``)."""
        if not train:
            with torch.no_grad():
                return self._forward(inputs, lengths, False, None)
        return self._forward(inputs, lengths, True, masks)

    def _forward(self, inputs, lengths, train: bool,
                 masks) -> torch.Tensor:
        cells = self.cells()
        use_dropout = train and self.keep_prob < 1.0

        def drop(h):
            return dropout(h, self.keep_prob, masks) if use_dropout else h

        if (self.lstm_impl == "wavefront" and not use_dropout
                and self.variant in ("l", "base")):
            tap = lstm_stack_wavefront(
                inputs, lengths, [c.params() for c in cells],
                residual=self.variant == "l",
                compute_dtype=self.compute_dtype, save_acts=train)
        elif self.variant == "base":
            tap = inputs
            for cell in cells:
                tap = drop(cell(tap, lengths, save_acts=train))
        elif self.variant == "i":
            out1 = drop(cells[0](inputs, lengths, save_acts=train))
            tap = drop(cells[1](out1 + inputs, lengths,
                                save_acts=train)) + inputs
        else:
            tap = inputs
            for cell in cells:
                tap = drop(cell(tap, lengths, save_acts=train)) + tap
        return self.forward_out(tap)


class LstmGenerator(nn.Module):
    """``--g_type=lstm`` (``rsrgan_tpu/models/recurrent.py``
    ``LstmGenerator``): Dense to ``num_projection`` and leakyrelu, then
    ``num_layers`` x LSTM(``cell_size``, proj ``num_projection``) in a
    ``StackedLstm``, then a linear Dense out. The stack's input is
    ``num_projection`` wide, so with ``lstm_impl="wavefront"`` it runs in
    one wavefront launch (residual off), and per layer on the
    single-layer kernels where dropout sits between its layers (train
    mode, ``keep_prob < 1``)."""

    def __init__(self, input_dim: int, output_dim: int,
                 cell_size: int = 760, num_projection: int = 280,
                 num_layers: int = 3, keep_prob: float = 1.0,
                 compute_dtype: torch.dtype = torch.float32,
                 lstm_impl: str = "wavefront",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if lstm_impl not in ("wavefront", "pallas", "scan"):
            raise ValueError(f"unknown lstm_impl {lstm_impl}")
        self.keep_prob = keep_prob
        self.Dense_0 = Dense(input_dim, num_projection, generator)
        self.StackedLstm_0 = StackedLstm(
            num_projection, num_layers, cell_size, num_projection,
            compute_dtype=compute_dtype, dropout_keep_prob=keep_prob,
            lstm_impl=lstm_impl, generator=generator)
        self.Dense_1 = Dense(num_projection, output_dim, generator)

    def forward(self, inputs: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                train: bool = False,
                masks: Optional[MaskSource] = None) -> torch.Tensor:
        """[B, T, D] features, [B] lengths -> [B, T, output_dim]."""
        if not train:
            with torch.no_grad():
                return self._forward(inputs, lengths, False, None)
        return self._forward(inputs, lengths, True, masks)

    def _forward(self, inputs, lengths, train, masks) -> torch.Tensor:
        h = leakyrelu(self.Dense_0(inputs))
        h = self.StackedLstm_0(h, lengths, train, masks=masks)
        return self.Dense_1(h)


class BnLstmGenerator(nn.Module):
    """``--g_type=bnlstm`` (``rsrgan_tpu/models/recurrent.py``
    ``BnLstmGenerator``): Dense to ``num_projection`` and relu, then
    ``num_layers`` x ``BnLstmCell(cell_size, proj num_projection)``, then a
    linear Dense out. No hand kernel computes its cell (batch norm inside
    the recurrence), so every ``lstm_impl`` runs the eager cell. A
    train-mode forward folds each cell's moving statistics into its
    buffers; eval mode normalises by them. It has no dropout."""

    def __init__(self, input_dim: int, output_dim: int,
                 cell_size: int = 760, num_projection: int = 280,
                 num_layers: int = 3,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        self.Dense_0 = Dense(input_dim, num_projection, generator)
        for k in range(num_layers):
            self.add_module(f"cell_{k}", BnLstmCell(
                num_projection, cell_size, num_projection,
                compute_dtype=compute_dtype, generator=generator))
        self.Dense_1 = Dense(num_projection, output_dim, generator)

    def forward(self, inputs: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                train: bool = False,
                masks: Optional[MaskSource] = None) -> torch.Tensor:
        """[B, T, D] features, [B] lengths -> [B, T, output_dim];
        ``masks`` is accepted for the trainers' call and unused."""
        if not train:
            with torch.no_grad():
                return self._forward(inputs, lengths, False)
        return self._forward(inputs, lengths, True)

    def _forward(self, inputs, lengths, train) -> torch.Tensor:
        h = torch.relu(self.Dense_0(inputs))
        for k in range(self.num_layers):
            h = getattr(self, f"cell_{k}")(h, lengths, train)
        return self.Dense_1(h)
