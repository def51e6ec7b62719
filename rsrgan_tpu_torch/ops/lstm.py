"""Peephole + projection LSTM, eager PyTorch (``rsrgan_tpu/ops/lstm.py``).

``tf.contrib.rnn.LSTMCell(num_units, use_peepholes=True, num_proj=...)``
driven by ``tf.nn.dynamic_rnn(sequence_length=...)``, as the JAX scan
path computes it:

* gate order i, j, f, o in one ``kernel [D+P, 4U]``;
* peepholes act on c_prev for i and f, and on c_new for o;
* ``forget_bias`` is added inside the f gate's sigmoid;
* past a row's length the state freezes and the output is zero.

This is the port's ``--lstm_impl scan`` path (differentiable by
autograd, the f32 oracle of the kernels) and the plain reference that the
wavefront kernel's twin is tested beside. Matmuls follow the JAX
precision policy: operands in ``compute_dtype``, products accumulated in
f32, and (as XLA returns a bf16 product for bf16 operands) the product
rounded to ``compute_dtype`` before it joins the f32 state math.

``LstmCellP(lstm_impl="pallas")`` runs the layer on the single-layer
kernels instead (``ops/lstm_seq.py``: K1 forward, K2/K3 backward), and
``StackedLstm`` (MultiRNNCell) chains layers, with the wavefront kernel
where no dropout sits between them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from rsrgan_tpu_torch.ops.common import MaskSource, dropout
from rsrgan_tpu_torch.ops.lstm_seq import lstm_seq
from rsrgan_tpu_torch.ops.wavefront_stack import lstm_stack_wavefront


def glorot_uniform_(t: torch.Tensor,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """In-place Glorot-uniform init of a 2-D tensor (flax's default)."""
    fan_in, fan_out = t.shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        u = torch.rand(t.shape, generator=generator, dtype=torch.float32)
        t.copy_(u * (2 * limit) - limit)
    return t


def cdt_matmul(a: torch.Tensor, w: torch.Tensor,
               compute_dtype: torch.dtype) -> torch.Tensor:
    """f32 result of ``a @ w`` under the scan path's precision policy."""
    if compute_dtype == torch.float32:
        return a @ w
    out = a.to(compute_dtype).float() @ w.to(compute_dtype).float()
    return out.to(compute_dtype).float()


def lstm_cell_forward(inputs: torch.Tensor, lengths: Optional[torch.Tensor],
                      params: Dict[str, torch.Tensor],
                      forget_bias: float = 1.0,
                      compute_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """One layer over time: inputs [B, T, D] -> outputs [B, T, P]."""
    B, T, D = inputs.shape
    kernel = params["kernel"]
    proj = params["proj_kernel"]
    U, P = proj.shape
    w_i, w_f, w_o = (params[k][0] for k in ("w_i_diag", "w_f_diag",
                                            "w_o_diag"))
    w_x, w_h = kernel[:D], kernel[D:]
    # hoisted input projection over all timesteps
    xw = cdt_matmul(inputs.transpose(0, 1), w_x, compute_dtype)  # [T, B, 4U]
    steps = torch.arange(T, device=inputs.device)[:, None]
    if lengths is None:
        live = torch.ones((T, B), dtype=torch.bool, device=inputs.device)
    else:
        live = steps < lengths.to(inputs.device)[None, :]

    c = inputs.new_zeros((B, U))
    h = inputs.new_zeros((B, P))
    outs = []
    for t in range(T):
        gates = xw[t] + cdt_matmul(h, w_h, compute_dtype)
        gates = gates + params["bias"]
        i, j, f, o = gates.split(U, dim=1)
        c_new = (torch.sigmoid(f + forget_bias + w_f * c) * c
                 + torch.sigmoid(i + w_i * c) * torch.tanh(j))
        m = torch.sigmoid(o + w_o * c_new) * torch.tanh(c_new)
        h_new = cdt_matmul(m, proj, compute_dtype)
        keep = live[t][:, None]
        c = torch.where(keep, c_new, c)
        h = torch.where(keep, h_new, h)
        outs.append(torch.where(keep, h_new, torch.zeros_like(h_new)))
    return torch.stack(outs, dim=1)


class LstmCellP(nn.Module):
    """One peephole + projection LSTM layer. Its parameters carry the JAX
    names and layouts (``kernel [D+P, 4U]``, ``bias [4U]``,
    ``proj_kernel [U, P]``, ``w_{i,f,o}_diag [1, U]``), so one module
    serves the eager path (``lstm_impl="scan"``), the single-layer kernels
    (``"pallas"``) and the wavefront kernel (``params()``), and a flax
    checkpoint loads into any of them."""

    def __init__(self, input_dim: int, num_units: int, num_proj: int,
                 forget_bias: float = 1.0,
                 compute_dtype: torch.dtype = torch.float32,
                 lstm_impl: str = "scan",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if lstm_impl not in ("scan", "pallas"):
            raise ValueError(f"unknown lstm_impl {lstm_impl}")
        D, U, P = input_dim, num_units, num_proj
        self.forget_bias = forget_bias
        self.compute_dtype = compute_dtype
        self.lstm_impl = lstm_impl
        self.kernel = nn.Parameter(torch.empty(D + P, 4 * U))
        self.bias = nn.Parameter(torch.zeros(4 * U))
        self.proj_kernel = nn.Parameter(torch.empty(U, P))
        self.w_i_diag = nn.Parameter(torch.empty(1, U))
        self.w_f_diag = nn.Parameter(torch.empty(1, U))
        self.w_o_diag = nn.Parameter(torch.empty(1, U))
        for p in (self.kernel, self.proj_kernel, self.w_i_diag,
                  self.w_f_diag, self.w_o_diag):
            glorot_uniform_(p.data, generator)

    def params(self) -> Dict[str, torch.Tensor]:
        return {"kernel": self.kernel, "bias": self.bias,
                "proj_kernel": self.proj_kernel, "w_i_diag": self.w_i_diag,
                "w_f_diag": self.w_f_diag, "w_o_diag": self.w_o_diag}

    def forward(self, inputs: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                save_acts: bool = True) -> torch.Tensor:
        """[B, T, D] -> [B, T, P]. On the kernels ``save_acts=False`` is
        the inference forward (no activation stream, not
        differentiable); the eager path ignores it."""
        if self.lstm_impl == "scan":
            return lstm_cell_forward(inputs, lengths, self.params(),
                                     self.forget_bias, self.compute_dtype)
        D = inputs.shape[2]
        cdt = self.compute_dtype
        # hoisted input projection: W-operand product, rounded to W
        xw = cdt_matmul(inputs.transpose(0, 1), self.kernel[:D], cdt)
        out = lstm_seq(xw, lengths, self.kernel[D:], self.proj_kernel,
                       self.bias, self.w_i_diag[0], self.w_f_diag[0],
                       self.w_o_diag[0], self.forget_bias, cdt, save_acts)
        return out.transpose(0, 1)


class StackedLstm(nn.Module):
    """MultiRNNCell: ``num_layers`` LstmCellP layers ``cell_0``, ``cell_1``,
    ... (``rsrgan_tpu/ops/lstm.py`` ``StackedLstm``).

    ``lstm_impl="wavefront"`` runs the whole stack in one wavefront launch
    (residual off) when the input width equals num_proj, and per layer on
    the single-layer kernels otherwise; "pallas" always per layer; "scan"
    the eager cell. ``train`` keeps the activations for the backward.
    With ``dropout_keep_prob < 1`` a train-mode call drops out after every
    layer (masks from ``masks``) and so runs per layer, the wavefront
    stack having no dropout points, as in the JAX package."""

    def __init__(self, input_dim: int, num_layers: int, num_units: int,
                 num_proj: int, compute_dtype: torch.dtype = torch.float32,
                 dropout_keep_prob: float = 1.0, lstm_impl: str = "scan",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if lstm_impl not in ("scan", "pallas", "wavefront"):
            raise ValueError(f"unknown lstm_impl {lstm_impl}")
        self.num_proj = num_proj
        self.compute_dtype = compute_dtype
        self.lstm_impl = lstm_impl
        self.keep_prob = dropout_keep_prob
        cell_impl = "scan" if lstm_impl == "scan" else "pallas"
        for k in range(num_layers):
            self.add_module(f"cell_{k}", LstmCellP(
                input_dim if k == 0 else num_proj, num_units, num_proj,
                compute_dtype=compute_dtype, lstm_impl=cell_impl,
                generator=generator))
        self.num_layers = num_layers

    def cells(self):
        return [getattr(self, f"cell_{k}") for k in range(self.num_layers)]

    def forward(self, inputs: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                train: bool = False,
                lstm_impl: Optional[str] = None,
                masks: Optional[MaskSource] = None) -> torch.Tensor:
        """``lstm_impl`` overrides the module's for this call ("pallas"
        keeps a wavefront stack on the single-layer kernels); ``masks``
        is the dropout's mask source (``ops.common.dropout``)."""
        impl = lstm_impl or self.lstm_impl
        use_dropout = train and self.keep_prob < 1.0
        if (impl == "wavefront" and not use_dropout
                and inputs.shape[-1] == self.num_proj):
            return lstm_stack_wavefront(
                inputs, lengths, [c.params() for c in self.cells()],
                residual=False, compute_dtype=self.compute_dtype,
                save_acts=train)
        h = inputs
        for cell in self.cells():
            h = cell(h, lengths, save_acts=train)
            if use_dropout:
                h = dropout(h, self.keep_prob, masks)
        return h
