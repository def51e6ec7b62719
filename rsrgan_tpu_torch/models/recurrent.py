"""The recurrent generators (``rsrgan_tpu/models/recurrent.py``
``LstmGenerator`` and the ``ResLstmGenerator`` family) and the weight
bridge from JAX parameter trees.

Parameter names and layouts are the JAX ones (``lstm_cell_{1..4}/{kernel,
bias,proj_kernel,w_i_diag,w_f_diag,w_o_diag}``, ``forward_out/{kernel,
bias}``; ``Dense_0``, ``StackedLstm_0/cell_{0,1,2}``, ``Dense_1``;
``kernel [D+P, 4U]``, dense ``kernel [in, out]``), so ``load_flax_params``
copies a flax checkpoint's G tree in by name. The
JAX package needs a parameter-only ``_CellParams`` twin to give the
wavefront path the scan path's tree; here ``LstmCellP`` holds the
parameters and serves both paths.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

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
