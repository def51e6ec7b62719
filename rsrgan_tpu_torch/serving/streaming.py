"""Streaming (chunked) enhancement for the causal generator zoo
(counterpart of ``rsrgan_tpu/serving/streaming.py``).

Every LSTM generator is causal (unidirectional LSTMs and per-frame dense
layers), so chunked processing with carried recurrent state is exact:
this module recomputes the generator forward from the trained parameter
tree with explicit ``(c, h)`` state threading, one chunk per ``step``.

The cell is the plain PyTorch cell (``torch.cat`` and a product per
step; gate order i, j, f, o, peepholes, ``forget_bias`` in the f gate).
No hand kernel runs here: the wavefront kernel starts from zero state
and has no state input (ROADMAP.md, S9). Every product has the shape of
one step, ``[B, D]``, whatever the chunk's length, so the bits a stream
gets do not depend on how it was cut into chunks (cuBLAS picks its
kernel by shape). A different batch ``B`` may change the last bits.

Supported wirings. The constructor validates the parameter tree against
the variant's expected shape (cell count, dense heads, peephole and
projection params), so structurally mismatched checkpoints raise.
``res_lstm_l`` and ``res_lstm_base`` have identical trees; ``cli/serve.py``
tells them apart by the checkpoint's ``.meta.json`` sidecar.

* ``res_lstm_l``  — 4 layers, layer residual
* ``res_lstm_base`` — 4 stacked layers, no residual
* ``res_lstm_i``  — 2 layers, input residual
* ``lstm``        — leakyrelu input projection + 3 stacked cells

``bnlstm`` is rejected: its recurrent batch-norm cell depends on per-step
moving statistics that the plain LSTM recurrence cannot reproduce.

Usage::

    enhancer = StreamingEnhancer(params, variant="res_lstm_l")
    state = enhancer.init_state(batch=1)
    for chunk in chunks:                         # [B, T_chunk, 257]
        out, state = enhancer.step(chunk, state) # [B, T_chunk, 40]
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from rsrgan_tpu_torch.device import resolve_device
from rsrgan_tpu_torch.ops.common import leakyrelu

_RES_VARIANTS = ("res_lstm_l", "res_lstm_base", "res_lstm_i")
SUPPORTED_VARIANTS = _RES_VARIANTS + ("lstm",)
_CELL_KEYS = {"kernel", "bias", "proj_kernel", "w_i_diag", "w_f_diag",
              "w_o_diag"}

State = List[Tuple[torch.Tensor, torch.Tensor]]


def _cell_step(cell: Dict[str, torch.Tensor], forget_bias: float,
               carry: Tuple[torch.Tensor, torch.Tensor],
               x_t: torch.Tensor):
    """One LSTM timestep (TF LSTMCell equations, gate order i, j, f, o)."""
    c, h = carry
    gates = torch.addmm(cell["bias"], torch.cat([x_t, h], dim=-1),
                        cell["kernel"])
    i, j, f, o = gates.chunk(4, dim=-1)
    c_new = (torch.sigmoid(f + forget_bias + cell["w_f_diag"][0] * c) * c
             + torch.sigmoid(i + cell["w_i_diag"][0] * c) * torch.tanh(j))
    m = torch.sigmoid(o + cell["w_o_diag"][0] * c_new) * torch.tanh(c_new)
    h_new = m @ cell["proj_kernel"]
    return (c_new, h_new), h_new


def _masked_cell_step(cell, forget_bias, carry, x_t, keep):
    """Cell step that freezes ``(c, h)`` for lanes past their valid
    length (``keep`` [B, 1] bool); masked outputs are zero and must be
    ignored by the caller."""
    (c_new, h_new), _ = _cell_step(cell, forget_bias, carry, x_t)
    c, h = carry
    c_new = torch.where(keep, c_new, c)
    h_new = torch.where(keep, h_new, h)
    return (c_new, h_new), torch.where(keep, h_new, torch.zeros_like(h_new))


def _dense_steps(x: torch.Tensor, dense: Dict[str, torch.Tensor]
                 ) -> torch.Tensor:
    """``x [T, B, D] @ kernel + bias``, one ``[B, D]`` product per step, so
    that a frame's bits do not depend on the chunk's length."""
    return torch.stack([torch.addmm(dense["bias"], x_t, dense["kernel"])
                        for x_t in x])


def _lookup(tree, dotted: str):
    for key in dotted.split("."):
        tree = tree[key]
    return tree


def _to_tensors(tree, device: torch.device):
    """A flax-named tree of arrays (numpy or tensors) as f32 tensors on
    ``device``, the same nesting."""
    if isinstance(tree, Mapping):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        tree = torch.from_numpy(np.array(tree, np.float32))
    return tree.to(device=device, dtype=torch.float32)


class StreamingEnhancer:
    """Chunked generator forward with carried state, variant-aware."""

    def __init__(self, params, variant: str = "res_lstm_l",
                 forget_bias: float = 1.0, device="cuda"):
        """``params``: the generator's flax-named parameter tree (nested
        dicts of numpy arrays or tensors), e.g. G's ``params`` of a
        checkpoint read by ``training/checkpoints.py``. It is converted
        once to f32 tensors on ``device`` (default ``cuda``; a missing
        card raises).

        Raises ``ValueError`` when ``variant`` is unsupported or the
        parameter tree does not match the variant's expected wiring.
        """
        if variant not in SUPPORTED_VARIANTS:
            raise ValueError(
                f"StreamingEnhancer does not support variant {variant!r} "
                f"(supported: {SUPPORTED_VARIANTS}); bnlstm's recurrent "
                "batch-norm cannot be streamed exactly")
        self.variant = variant
        self.forget_bias = float(forget_bias)

        if variant == "lstm":
            stack = params.get("StackedLstm_0")
            if (stack is None or "Dense_0" not in params
                    or "Dense_1" not in params):
                raise ValueError(
                    "parameter tree does not look like models/lstm.py "
                    "(expected Dense_0 + StackedLstm_0 + Dense_1; got "
                    f"{sorted(params)})")
            names = [f"StackedLstm_0.cell_{k}" for k in range(
                len([k for k in stack if k.startswith("cell_")]))]
        else:
            names = sorted(k for k in params if k.startswith("lstm_cell_"))
            expected = 2 if variant == "res_lstm_i" else 4
            if len(names) != expected or "forward_out" not in params:
                raise ValueError(
                    f"parameter tree does not match {variant} (expected "
                    f"{expected} lstm_cell_* + forward_out; got "
                    f"{sorted(params)})")
        cells = [_lookup(params, n) for n in names]
        for cell in cells:
            missing = _CELL_KEYS - set(cell)
            if missing:
                raise ValueError(
                    f"LSTM cell params missing {sorted(missing)} — not a "
                    "peephole-projection cell checkpoint")

        self.device = resolve_device(str(device))
        self.params = _to_tensors(params, self.device)
        self._cells = [_lookup(self.params, n) for n in names]
        self.num_layers = len(self._cells)
        self.num_units, self.num_proj = self._cells[0]["proj_kernel"].shape

    def init_state(self, batch: int) -> State:
        """Zero ``(c [B, U], h [B, P])`` per layer on the device."""
        return [(torch.zeros((batch, c["proj_kernel"].shape[0]),
                             device=self.device),
                 torch.zeros((batch, c["proj_kernel"].shape[1]),
                             device=self.device))
                for c in self._cells]

    @torch.no_grad()
    def step(self, chunk, state: State, lengths=None
             ) -> Tuple[torch.Tensor, State]:
        """``[B, T_chunk, P]`` (numpy or tensor) -> (``[B, T_chunk, out]``
        tensor on the device, new state).

        Exact continuation: feeding chunks back-to-back reproduces the
        whole-utterance forward.

        ``lengths`` ([B] int, optional) marks per-lane valid frame counts:
        a lane's recurrent state freezes after its length, and its outputs
        beyond it are zeros to be discarded. This lets independent streams
        of uneven progress share one batched step (StreamPool).
        """
        if not isinstance(chunk, torch.Tensor):
            chunk = torch.tensor(np.asarray(chunk), dtype=torch.float32)
        x = chunk.to(device=self.device, dtype=torch.float32).transpose(0, 1)
        step_mask = None
        if lengths is not None:
            lengths = torch.as_tensor(np.asarray(lengths, np.int64),
                                      device=self.device)
            steps = torch.arange(x.shape[0], device=self.device)
            step_mask = steps[:, None] < lengths[None, :]   # [T, B]
        new_state = []

        def run_cell(cell, k, seq):
            carry, outs = state[k], []
            for t in range(seq.shape[0]):
                if step_mask is None:
                    carry, out = _cell_step(cell, self.forget_bias, carry,
                                            seq[t])
                else:
                    carry, out = _masked_cell_step(
                        cell, self.forget_bias, carry, seq[t],
                        step_mask[t][:, None])
                outs.append(out)
            new_state.append(carry)
            return torch.stack(outs)

        p = self.params
        if self.variant == "lstm":
            h = leakyrelu(_dense_steps(x, p["Dense_0"]))
            for k, cell in enumerate(self._cells):
                h = run_cell(cell, k, h)
            y = _dense_steps(h, p["Dense_1"])
        else:
            layer_in = x
            for k, cell in enumerate(self._cells):
                out = run_cell(cell, k, layer_in)
                if self.variant == "res_lstm_l":
                    layer_in = out + layer_in  # layer residual
                elif self.variant == "res_lstm_i":
                    layer_in = out + x  # input residual (original inputs)
                else:  # res_lstm_base: plain stack
                    layer_in = out
            y = _dense_steps(layer_in, p["forward_out"])
        if step_mask is not None:
            # residual wiring and biases leak input past the mask; zero it
            # so masked lanes visibly produce no output
            y = torch.where(step_mask[:, :, None], y, torch.zeros_like(y))
        return y.transpose(0, 1), new_state
