"""res_lstm_l / plain L-layer stacks on the wavefront kernel (counterpart
of ``rsrgan_tpu/ops/wavefront_stack.py``).

Forward: one wavefront launch runs all L layers. Inference
(``save_acts=False``, decode) returns the top tap only and runs under
``torch.no_grad()``; training (``save_acts=True``) keeps every layer's
tap, c, h and gate activations. Backward (``StackFn``, the JAX
``_stack_bwd`` custom_vjp): the single-layer reverse kernels of
``ops/lstm_seq.py`` walked from the top layer down, chaining d(tap_k);
dW_x and d(in_k) are ``torch.matmul`` products outside the kernels, as
JAX leaves them to ``einsum``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from rsrgan_tpu_torch import spans
from rsrgan_tpu_torch.ops.lstm_seq import fold_forget_bias, lstm_layer_bwd
from rsrgan_tpu_torch.ops.wavefront import (lstm_wavefront_fwd,
                                            lstm_wavefront_fwd_train)

_KEYS = ("kernel", "bias", "proj_kernel", "w_i_diag", "w_f_diag",
         "w_o_diag")


def _prep(params_list: List[Dict[str, torch.Tensor]], D: int,
          forget_bias: float):
    """Stack per-layer parameters for the kernel (no gate padding).

    params_list: per-layer dicts with 'kernel' [D+P, 4U], 'bias' [4U],
    'proj_kernel' [U, P], 'w_i_diag'/'w_f_diag'/'w_o_diag' [1, U].
    Returns wx [L, D, G], wh [L, P, G], bias [L, G] with forget_bias
    folded into the f quarter, proj [L, U, P], wi/wf/wo [L, U].
    """
    wx = torch.stack([p["kernel"][:D] for p in params_list])
    wh = torch.stack([p["kernel"][D:] for p in params_list])
    bias = torch.stack([fold_forget_bias(p["bias"], forget_bias)
                        for p in params_list])
    proj = torch.stack([p["proj_kernel"] for p in params_list])
    wi, wf, wo = (torch.stack([p[name][0] for p in params_list])
                  for name in ("w_i_diag", "w_f_diag", "w_o_diag"))
    return wx, wh, bias, proj, wi, wf, wo


def _kernel_args(x, params_list, forget_bias, compute_dtype):
    """(xw1, wx[1:], wh, proj, bias, wi, wf, wo, wx) for the kernel."""
    P_in = x.shape[2]
    wx, wh, bias, proj, wi, wf, wo = _prep(params_list, P_in, forget_bias)
    if wh.shape[1] != P_in:
        raise ValueError("the wavefront stack requires num_proj == "
                         f"input dim ({wh.shape[1]} != {P_in})")
    wx, wh, proj = (a.to(compute_dtype).contiguous() for a in (wx, wh, proj))
    # layer-1 projection hoisted out of the kernel (as JAX leaves it to
    # XLA): an f32 product of f32 x and W-rounded W_x, then cast to W
    xw1 = torch.matmul(x, wx[0].float()).to(compute_dtype)
    return (xw1, wx[1:].contiguous(), wh, proj, bias.contiguous(),
            wi.contiguous(), wf.contiguous(), wo.contiguous(), wx)


class StackFn(torch.autograd.Function):
    """Wavefront forward in training mode + the per-layer reverse walk.

    forward(x [T, B, P] f32, lengths [B] int32, residual, forget_bias,
    compute_dtype, *flat) with flat = 6 tensors per layer in ``_KEYS``
    order; returns the top tap [T, B, P] f32."""

    @staticmethod
    def forward(ctx, x, lengths, residual, forget_bias, compute_dtype,
                *flat):
        L = len(flat) // 6
        params_list = [dict(zip(_KEYS, flat[6 * k:6 * k + 6]))
                       for k in range(L)]
        xw1, wx_rest, wh, proj, bias, wi, wf, wo, wx = _kernel_args(
            x, params_list, forget_bias, compute_dtype)
        taps, c_s, h_s, acts = lstm_wavefront_fwd_train(
            xw1, lengths, x, wx_rest, wh, proj, bias, wi, wf, wo,
            residual=residual)
        ctx.residual = residual
        ctx.compute_dtype = compute_dtype
        ctx.save_for_backward(x, lengths, taps, c_s, h_s, acts, wx, wh,
                              proj, wi, wf, wo)
        return taps[L - 1]

    @staticmethod
    def backward(ctx, dtap_top):
        with spans.span("glue.stack_bwd"):
            x, lengths, taps, c_s, h_s, acts, wx, wh, proj, wi, wf, wo = \
                ctx.saved_tensors
            cdt = ctx.compute_dtype
            T, B, P = x.shape
            L = wh.shape[0]
            # layer inputs: in_0 = x, in_k = tap_{k-1}
            ins = [x] + [taps[k] for k in range(L - 1)]
            dtap = dtap_top.float().contiguous()
            grads = [None] * L
            for k in reversed(range(L)):
                dxw, dwh, dproj, dbias, dwi, dwf, dwo = lstm_layer_bwd(
                    acts[k], lengths, dtap, c_s[k], h_s[k], wh[k], proj[k],
                    wi[k], wf[k], wo[k])
                dxw_f = dxw.to(cdt).float().reshape(T * B, -1)
                d_in = (dxw_f @ wx[k].float().t()).reshape(T, B, -1)
                dwx = ins[k].to(cdt).float().reshape(T * B, -1).t() @ dxw_f
                grads[k] = (torch.cat([dwx, dwh], dim=0), dbias, dproj,
                            dwi[None], dwf[None], dwo[None])
                # d(tap_{k-1}) = d(in_k): the residual carries dtap through
                dtap = (dtap + d_in if ctx.residual else d_in).contiguous()
            flat_grads = [g for layer in grads for g in layer]
            return (dtap, None, None, None, None, *flat_grads)


def lstm_stack_wavefront(x_bm: torch.Tensor, lengths: Optional[torch.Tensor],
                         params_list: List[Dict[str, torch.Tensor]],
                         residual: bool, forget_bias: float = 1.0,
                         compute_dtype: torch.dtype = torch.bfloat16,
                         save_acts: bool = False) -> torch.Tensor:
    """[B, T, P] batch-major input -> top tap [B, T, P] (pre-dense).

    residual=True is res_lstm_l (in_{k+1} = out_k + in_k); False is the
    plain MultiRNNCell wiring. Every layer's input dim must equal num_proj.
    ``save_acts=False`` is the inference forward and is not
    differentiable; ``save_acts=True`` is the training forward, whose
    gradients flow to ``x_bm`` and every parameter.
    """
    with spans.span("glue.stack_fwd"):
        B, T, _ = x_bm.shape
        x = x_bm.transpose(0, 1).float().contiguous()       # [T, B, P]
        if lengths is None:
            lengths = torch.full((B,), T, dtype=torch.int32)
        lengths = lengths.to(device=x.device, dtype=torch.int32).contiguous()
        if save_acts:
            flat = [p[key] for p in params_list for key in _KEYS]
            tap = StackFn.apply(x, lengths, residual, forget_bias,
                                compute_dtype, *flat)
        else:
            with torch.no_grad():
                xw1, wx_rest, wh, proj, bias, wi, wf, wo, _ = _kernel_args(
                    x, params_list, forget_bias, compute_dtype)
                tap = lstm_wavefront_fwd(xw1, lengths, x, wx_rest, wh, proj,
                                         bias, wi, wf, wo, residual=residual)
        return tap.transpose(0, 1)
