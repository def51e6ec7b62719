"""The LSTM cell with recurrent batch normalization (counterpart of
``rsrgan_tpu/ops/bnlstm.py``, arXiv 1603.09025).

Separate input and state kernels; batch norm on ``x @ W_xh``, on
``h @ W_hh`` and on the cell state (``c`` is carried raw, ``tanh(BN(c))``
feeds the output); peepholes and a projection; TF gate order i, j, f, o
with ``forget_bias`` on f. The BN scales (initialised to 0.1) and offsets
are shared across steps.

In train mode each step normalises by that step's batch statistics: the
mean and the population variance (``correction=0``, as ``jnp.var``) over
all B rows, padded rows included. The six moving statistics fold with
decay 0.999 at every step where any row is valid, carried through the
loop and written to the buffers once per forward (flax's ``batch_stats``
collection). Gradients flow through the batch statistics, never through
the moving ones. Eval mode normalises by the moving statistics.
``rsqrt(var + 1e-3)``. The products run in ``compute_dtype`` and are
taken to f32; state and statistics are f32.

This cell reaches no Pallas kernel in the JAX package (its BN sits inside
the recurrence, which the fused ``[D+P, 4U]`` kernels cannot compute), so
the port is plain PyTorch: one step's ops at a time under autograd.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rsrgan_tpu_torch.ops.lstm import glorot_uniform_
from rsrgan_tpu_torch.parallel.mesh import current_world, global_moments

BN_DECAY = 0.999
BN_EPS = 1e-3

# the BN sites in the order of the six moving statistics' fold
_SITES = ("input", "state", "cell")


class BnLstmCell(nn.Module):
    """One recurrent-batch-norm LSTM layer over time: (inputs [B, T, D],
    lengths [B] or None, train) -> [B, T, P]. Masking follows
    ``dynamic_rnn``: past a row's length its state freezes and its output
    is zero."""

    flax_collection = "batch_stats"
    flax_stats = tuple(f"{site}_{stat}" for site in _SITES
                       for stat in ("mean", "var"))

    def __init__(self, input_dim: int, num_units: int, num_proj: int,
                 forget_bias: float = 1.0, use_peepholes: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        U, P = num_units, num_proj
        self.num_units, self.num_proj = U, P
        self.forget_bias = forget_bias
        self.use_peepholes = use_peepholes
        self.compute_dtype = compute_dtype

        def glorot(*shape):
            return nn.Parameter(glorot_uniform_(torch.empty(*shape),
                                                generator))

        self.input_kernel = glorot(input_dim, 4 * U)
        self.state_kernel = glorot(P, 4 * U)
        self.bias = nn.Parameter(torch.zeros(4 * U))
        self.projection_kernel = glorot(U, P)
        if use_peepholes:
            self.w_i_diag = glorot(1, U)
            self.w_f_diag = glorot(1, U)
            self.w_o_diag = glorot(1, U)
        for site, size in zip(_SITES, (4 * U, 4 * U, U)):
            setattr(self, f"{site}_scale",
                    nn.Parameter(torch.full((size,), 0.1)))
            setattr(self, f"{site}_offset", nn.Parameter(torch.zeros(size)))
            self.register_buffer(f"{site}_mean", torch.zeros(size))
            self.register_buffer(f"{site}_var", torch.ones(size))

    def _norm(self, site: str, x: torch.Tensor, mean: torch.Tensor,
              var: torch.Tensor) -> torch.Tensor:
        return ((x - mean) * torch.rsqrt(var + BN_EPS)
                * getattr(self, f"{site}_scale")
                + getattr(self, f"{site}_offset"))

    def _stats(self, site: str, x: torch.Tensor, train: bool, dim: int = 0):
        """(mean, var) of x over ``dim`` (the batch) in train mode, else
        the moving statistics. In a data-parallel world the train-mode
        statistics are the global batch's, in two passes as here: the
        global mean, then the global mean of the squared deviations (two
        all-reduces a call, as JAX's mesh reduces ``jnp.var``)."""
        if train and current_world().data_size > 1:
            return global_moments(x, (dim,), centred=True)
        if train:
            return x.mean(dim), x.var(dim, correction=0)
        return getattr(self, f"{site}_mean"), getattr(self, f"{site}_var")

    def forward(self, inputs: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        B, T, _ = inputs.shape
        U, P, cdt = self.num_units, self.num_proj, self.compute_dtype
        device = inputs.device
        # the input product and its BN for every step at once (the step's
        # statistics are over that step's B rows, [T, B, 4U] -> [T, 4U])
        xw = (inputs.transpose(0, 1).to(cdt)
              @ self.input_kernel.to(cdt)).float()
        mx, vx = self._stats("input", xw, train, dim=1)
        if train:
            nx = self._norm("input", xw, mx[:, None], vx[:, None])
        else:
            nx = self._norm("input", xw, mx, vx)
        if lengths is not None:
            mask = (torch.arange(T, device=device)[:, None]
                    < lengths.to(device)[None, :])
        else:
            mask = torch.ones((T, B), dtype=torch.bool, device=device)
        w_hh = self.state_kernel.to(cdt)
        w_proj = self.projection_kernel.to(cdt)
        if self.use_peepholes:
            w_i, w_f, w_o = (self.w_i_diag[0], self.w_f_diag[0],
                             self.w_o_diag[0])

        c = torch.zeros((B, U), device=device)
        h = torch.zeros((B, P), device=device)
        outs, step_stats = [], []
        for t in range(T):
            hh = (h.to(cdt) @ w_hh).float()
            mh, vh = self._stats("state", hh, train)
            gates = nx[t] + self._norm("state", hh, mh, vh) + self.bias
            i, j, f, o = gates.chunk(4, dim=1)
            if self.use_peepholes:
                c_new = (torch.sigmoid(f + self.forget_bias + w_f * c) * c
                         + torch.sigmoid(i + w_i * c) * torch.tanh(j))
            else:
                c_new = (torch.sigmoid(f + self.forget_bias) * c
                         + torch.sigmoid(i) * torch.tanh(j))
            mc, vc = self._stats("cell", c_new, train)
            nc = self._norm("cell", c_new, mc, vc)
            if self.use_peepholes:
                m = torch.sigmoid(o + w_o * c_new) * torch.tanh(nc)
            else:
                m = torch.sigmoid(o) * torch.tanh(nc)
            h_new = (m.to(cdt) @ w_proj).float()
            keep = mask[t][:, None]
            c = torch.where(keep, c_new, c)
            h = torch.where(keep, h_new, h)
            outs.append(torch.where(keep, h_new, torch.zeros_like(h_new)))
            if train:
                step_stats.append((mh, vh, mc, vc))
        if train:
            valid = mask.any(1)
            world = current_world()
            if world.data_size > 1:   # a step any row of the global batch has
                valid = world.all_reduce_sum_(valid.float()) > 0
            self._fold(valid, mx, vx, step_stats)
        return torch.stack(outs, dim=1)

    @torch.no_grad()
    def _fold(self, valid: torch.Tensor, mx: torch.Tensor, vx: torch.Tensor,
              step_stats: list) -> None:
        """The moving statistics' per-step fold, frozen at steps where no
        row is valid; the six statistics side by side in one vector."""
        names = self.flax_stats
        bufs = [getattr(self, n) for n in names]
        moving = torch.cat(bufs)
        new = torch.cat([mx, vx, *(torch.stack(s) for s in
                                   zip(*step_stats))], dim=1).detach()
        for t in range(new.shape[0]):
            moving = torch.where(
                valid[t], moving * BN_DECAY + new[t] * (1 - BN_DECAY),
                moving)
        for buf, value in zip(bufs, moving.split([b.numel() for b in bufs])):
            buf.copy_(value)
