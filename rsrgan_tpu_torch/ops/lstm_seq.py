"""The single-layer LSTM kernels and their autograd (counterpart of
``rsrgan_tpu/ops/pallas_lstm.py``).

Three kernels, each with a wrapper that counts its launches and a plain
PyTorch twin in this module; a wrapper runs its twin for CPU tensors and
launches its kernel for CUDA tensors, or raises:

* ``lstm_fwd`` (K1, ``_fwd_kernel``): one layer over T from a precomputed
  input projection, on one of two kernels of ``csrc/resident.cu`` that
  the plans decide (``fwd_route``): where the layer's weights fit one
  block (the D layer) the row-group kernel, one block per group of at
  most 16 rows holding the whole layer's W_h and proj in shared memory
  and walking all T steps with block barriers only, as ``rowgroup_plan``
  lays it out; elsewhere (G width) K4's resident grid at L = 1 without the
  residual (``ops/wavefront.py`` ``resident_plan``), whose blocks each
  hold a slice of W_h and proj for the whole walk.
* ``lstm_bwd`` (K2, ``_bwd_kernel``): the reverse walk over the saved gate
  activations; emits dgates (dxw), masked m and masked dh_total. The
  weight gradients are reduced outside (``lstm_weight_grads``). Its
  kernel is the resident one of ``csrc/resident.cu``: each block of a
  one-block-per-SM grid holds a slice of W_h and proj in shared memory
  for the whole walk, as ``resident_plan`` partitions them.
* ``lstm_bwd_acc`` (K3, ``_bwd_kernel_acc``): the same walk with the
  weight gradients reduced by the kernels, on one of three routes that
  the plans decide (``bwd_acc_route``): where the layer's weights fit in
  one block (the D layer) the row-group walk of ``csrc/resident.cu``
  (K1's design backwards: ``rowgroup_bwd_plan``), which also sums the
  dbias and peephole terms per row group; elsewhere, where K2's resident
  grid fits (G width), K2's walk in its accumulate mode
  (``resident_plan(..., acc=True)``), whose blocks sum those terms for
  their own units. Either walk is followed by ``lstm_wgrad_kernel``,
  which reduces dW_h and dproj from the walk's streams in a fixed
  split-K order (``wgrad_plan``; bf16 on tensor cores). The other shapes
  (G width in f32 past ``RESIDENT_F32_MAX_ROWS`` rows, where it is the
  faster route) take ``csrc/lstm_bwd.cu`` (``acc=1``), which streams its
  weights from L2.

``lstm_layer_bwd`` picks K2 below ``ACC_BWD_MIN_BATCH`` rows and K3 from
there, as the JAX package does; ``lstm_seq`` is the differentiable layer
(the JAX ``lstm_seq_pallas`` custom_vjp, here a ``torch.autograd.Function``).

Shapes are natural, never padded: gates G = 4U in TF order i, j, f, o;
the TPU's 128-lane gate padding, rows-per-step R and VMEM budget are
TPU choices and are dropped. W is the compute dtype (f32 or bf16): the
operands of every product are rounded to W and accumulate in f32; state,
bias and peepholes stay f32; dxw, m and dh streams are stored in W.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Tuple

import torch

from rsrgan_tpu_torch import spans
from rsrgan_tpu_torch.ops import _build, resident, wavefront

# Rows from which the backward reduces its weight gradients inside the
# kernel (K3) rather than in products outside (K2), as
# rsrgan_tpu/ops/pallas_lstm.py `_ACC_BWD_MIN_BATCH`.
ACC_BWD_MIN_BATCH = 32


def _rnd(a: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    return a.to(cdt).float()


def _live(lengths: torch.Tensor, T: int, device) -> torch.Tensor:
    """[T, B, 1] bool: step t of row b is inside its length."""
    return (torch.arange(T, device=device)[:, None]
            < lengths.to(device)[None, :])[:, :, None]


# ---------------------------------------------------------------------------
# K1: forward
# ---------------------------------------------------------------------------

def lstm_fwd_reference(xw, lengths, w_h, proj, bias, wi, wf, wo,
                       save_acts=True):
    """Plain twin of K1.

    xw [T, B, G] input projection in W; lengths [B]; w_h [P, G] and
    proj [U, P] in W; bias [G] f32 with forget_bias folded in; peepholes
    wi/wf/wo [U] f32. Returns (out [T, B, P], c_hist [T, B, U],
    h_hist [T, B, P], acts [T, B, G] in W or None): out is zero past a
    row's length, c_hist/h_hist are the post-mask state, acts the gate
    activations [si, tj, sf, so].
    """
    T, B, G = xw.shape
    U, P = proj.shape
    cdt = w_h.dtype
    live = _live(lengths, T, xw.device)
    w_hf, w_pf = w_h.float(), proj.float()
    c = xw.new_zeros((B, U), dtype=torch.float32)
    h = xw.new_zeros((B, P), dtype=torch.float32)
    outs, cs, hs, acts = [], [], [], []
    for t in range(T):
        gates = xw[t].float() + _rnd(h, cdt) @ w_hf + bias
        i, j, f, o = gates.split(U, dim=1)
        si = torch.sigmoid(i + wi * c)
        sf = torch.sigmoid(f + wf * c)
        tj = torch.tanh(j)
        c_new = sf * c + si * tj
        so = torch.sigmoid(o + wo * c_new)
        h_new = _rnd(so * torch.tanh(c_new), cdt) @ w_pf
        c = torch.where(live[t], c_new, c)
        h = torch.where(live[t], h_new, h)
        outs.append(torch.where(live[t], h_new, torch.zeros_like(h_new)))
        cs.append(c)
        hs.append(h)
        if save_acts:
            acts.append(torch.cat([si, tj, sf, so], dim=1).to(cdt))
    return (torch.stack(outs), torch.stack(cs), torch.stack(hs),
            torch.stack(acts) if save_acts else None)


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """The layout of K1's row-group kernel (csrc/resident.cu).

    Block i walks rows [row_bounds[i], row_bounds[i+1]), at most
    ``group_rows``: the fewest rows (a power of two up to ``ROW_TILE``, one
    mma tile of M) that keep the blocks within the card's SMs, so that
    each SM runs as few cells and moves as few stream bytes a step as it
    can (1 row a block at the D step's 16 and 32 rows); fewer still where
    the staging would not fit. Unit group q (units 8q .. 8q+7, ``ngrp``
    groups) is owned by warp ``owner(q)`` of ``ROW_WARPS``; its four gate
    tiles are the 32 packed W_h rows 32q .. 32q+31. Products (A rows
    padded to 16): the gates h·W_h with K = Kh = P padded, and h = m·proj
    with K = Km = U padded over Np = P padded output rows in 8-row tiles,
    K split into ``ks`` chunks of ``kchunk`` 16-wide steps, one (tile,
    chunk) task a warp, whose partials [ks, group_rows, Np] are summed in
    chunk order. ldh and ldm are the row strides of the packed weights and
    of their A operands. Step t's xw rows are staged in shared memory
    [group_rows, ldx] in ``xchunk``-byte copies (the cell phase reads them
    there and writes the gate activations in their place, which leave in
    the same chunks). ``offsets`` is the shared-memory layout, ``n_res_*``
    the weight rows held there (the rest is read from the packed weights
    in global memory)."""
    B: int
    U: int
    P: int
    group_rows: int
    groups: int
    row_bounds: Tuple[int, ...]
    ngrp: int
    Kh: int
    ldh: int
    Np: int
    Km: int
    ldm: int
    ks: int
    kchunk: int
    ldx: int
    xchunk: int
    n_res_h: int
    n_res_p: int
    offsets: Dict[str, int]
    smem: int

    @staticmethod
    def owner(q: int) -> int:
        """The warp that computes unit group q's gates and cell."""
        return q % ROW_WARPS

    def weights_resident(self) -> bool:
        return self.n_res_h == 32 * self.ngrp and self.n_res_p == self.Np


ROW_TILE = 16   # most rows a block: one mma tile of M (kRows)
ROW_WARPS = 16  # warps per block (kRowWarps)


@functools.lru_cache(maxsize=None)
def rowgroup_plan(B: int, U: int, P: int, dtype: torch.dtype,
                  sms: int) -> FwdPlan:
    """K1's launch on a card with ``sms`` SMs: ceil(B / group_rows)
    blocks over balanced row groups. Raises ValueError, with the shape,
    where no layout fits."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"weights must be float32 or bfloat16, got {dtype}")
    bf16 = dtype == torch.bfloat16
    wb, pad = (2, 8) if bf16 else (4, 4)
    shape = f"B={B} U={U} P={P} {dtype}"
    if min(B, U, P, sms) < 1:
        raise ValueError(f"no row-group K1 plan for {shape} on {sms} SMs")
    ngrp = -(-U // 8)
    Kh, Km, Np = (resident.round_up(n, m) for n, m in
                  ((P, 16), (U, 16), (P, 8)))
    ldh, ldm = Kh + pad, Km + pad
    # 16 bytes more than a row, so the 8 rows a warp reads at once sit in
    # different banks
    ldx = 4 * U + 16 // wb
    xchunk = 16 if 4 * U * wb % 16 == 0 else 8
    ksteps = Km // 16
    fewest = 1
    while fewest < ROW_TILE and -(-B // fewest) > sms:
        fewest *= 2
    # the projection's K in ks chunks of kchunk k-steps, so that the
    # (8-column tile, chunk) tasks give every warp one
    ks = max(1, min(ROW_WARPS // (Np // 8), ksteps))
    kchunk = -(-ksteps // ks)
    ks = -(-ksteps // kchunk)
    for group_rows in (r for r in (16, 8, 4, 2, 1) if r <= fewest):
        try:
            offsets, rows, smem = resident.layout(
                {"x": group_rows * ldx * wb,
                 "h": ROW_TILE * ldh * wb, "m": ROW_TILE * ldm * wb,
                 "c": group_rows * U * 4, "hf": group_rows * P * 4,
                 "part": ks * group_rows * Np * 4,
                 "k": (7 * U + ROW_TILE) * 4},
                [("wp", ldm * wb, Np), ("wh", ldh * wb, 32 * ngrp)],
                multiple={"wp": 8, "wh": 32})
            break
        except ValueError as e:
            error = e
    else:
        raise ValueError(f"no row-group K1 plan for {shape}: {error}")
    groups = -(-B // group_rows)
    return FwdPlan(B, U, P, group_rows, groups,
                   tuple(resident.balanced_bounds(B, groups)), ngrp, Kh, ldh,
                   Np, Km, ldm, ks, kchunk, ldx, xchunk, rows["wh"],
                   rows["wp"], offsets, smem)


def pack_fwd_weights(w_h, proj, plan: FwdPlan):
    """K1's weights in the layout its products read: wh_pk [ngrp·32, ldh]
    (row 32q + 8g + i = W_h[:, g·U + 8q + i]) and wp_pk [Np, ldm] (row p =
    proj[:, p]); zero in every pad."""
    U, P, ngrp = plan.U, plan.P, plan.ngrp
    wh4 = torch.cat([w_h.reshape(P, 4, U),
                     w_h.new_zeros((P, 4, 8 * ngrp - U))], 2)
    wh_pk = w_h.new_zeros((32 * ngrp, plan.ldh))
    wh_pk[:, :P] = wh4.reshape(P, 4, ngrp, 8).permute(2, 1, 3, 0).reshape(
        32 * ngrp, P)
    wp_pk = proj.new_zeros((plan.Np, plan.ldm))
    wp_pk[:P, :U] = proj.t()
    return wh_pk, wp_pk


def _check_fwd(xw, lengths, w_h, proj, bias, wi, wf, wo):
    T, B, G = xw.shape
    U, P = proj.shape
    cdt = w_h.dtype
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"weights must be float32 or bfloat16, got {cdt}")
    f32 = torch.float32
    want = {"xw": ((T, B, G), cdt), "lengths": ((B,), torch.int32),
            "w_h": ((P, G), cdt), "proj": ((U, P), cdt),
            "bias": ((G,), f32), "wi": ((U,), f32), "wf": ((U,), f32),
            "wo": ((U,), f32)}
    got = dict(xw=xw, lengths=lengths, w_h=w_h, proj=proj, bias=bias, wi=wi,
               wf=wf, wo=wo)
    for name, (shape, dtype) in want.items():
        t = got[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != xw.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {xw.device}")
    if T < 1 or B < 1 or G != 4 * U:
        raise ValueError(f"bad sizes T={T} B={B} G={G} U={U}")


def _launch_fwd_rowgroup(xw, lengths, w_h, proj, bias, wi, wf, wo,
                         save_acts):
    """One launch of K1's row-group kernel on CUDA tensors."""
    _check_fwd(xw, lengths, w_h, proj, bias, wi, wf, wo)
    T, B, G = xw.shape
    U, P = proj.shape
    cdt, dev = w_h.dtype, xw.device
    with torch.cuda.device(dev):
        with spans.span("launch.plan"):
            plan = rowgroup_plan(B, U, P, cdt, resident.sm_count(dev))
        with spans.span("launch.pack"):
            wh_pk, wp_pk = pack_fwd_weights(w_h, proj, plan)
        rows = resident.upload_int32(plan.row_bounds, dev)
        f32 = dict(dtype=torch.float32, device=dev)
        out = torch.empty((T, B, P), **f32)
        if save_acts:
            saved = (torch.empty((T, B, U), **f32),
                     torch.empty((T, B, P), **f32),
                     torch.empty((T, B, G), dtype=cdt, device=dev))
            saved_ptrs = [t.data_ptr() for t in saved]
        else:
            saved, saved_ptrs = (None, None, None), [None] * 3
        o = plan.offsets
        params = resident.RowParams(
            *(t.data_ptr() for t in (xw, lengths, wh_pk, wp_pk, bias, wi, wf,
                                     wo, rows, out)),
            *saved_ptrs, T, B, U, P, int(save_acts), plan.groups,
            plan.group_rows, plan.ngrp,
            plan.Kh, plan.ldh, plan.Np, plan.Km, plan.ldm, plan.ks,
            plan.kchunk, plan.ldx, plan.xchunk, plan.n_res_h, plan.n_res_p,
            o["x"], o["h"], o["m"], o["c"], o["hf"], o["part"], o["k"],
            o["wh"], o["wp"], plan.smem)
        resident.launch("lstm_fwd_rowgroup", params, cdt == torch.bfloat16,
                        dev, f"T={T} B={B} U={U} P={P} {cdt}")
    return (out,) + saved


def _launch_fwd_resident(xw, lengths, w_h, proj, bias, wi, wf, wo,
                         save_acts):
    """One launch of K1 on K4's resident grid (L = 1, residual off:
    ``wavefront._launch_resident``) on CUDA tensors: (out, c_hist, h_hist,
    acts), or (out, None, None, None) without ``save_acts``."""
    _check_fwd(xw, lengths, w_h, proj, bias, wi, wf, wo)
    P, G = w_h.shape
    stack = (w_h.new_empty((0, P, G)), w_h[None], proj[None], bias[None],
             wi[None], wf[None], wo[None])
    saved = wavefront._launch_resident(xw, lengths, None, *stack,
                                       residual=False, save_acts=save_acts)
    if save_acts:
        return tuple(t[0] for t in saved)
    return saved, None, None, None


def fwd_route(B: int, U: int, P: int, dtype: torch.dtype, sms: int) -> str:
    """K1's kernel at these sizes on a card with ``sms`` SMs, a pure
    function of the shape: "rowgroup" where the layer's bf16 weights all
    fit one row-group block (``rowgroup_plan``: the D layer, in either
    dtype); else "resident" where K4's grid holds the layer at L = 1
    (``wavefront.resident_plan``: G width). Raises ValueError, with the
    shape, where neither fits."""
    try:
        if rowgroup_plan(B, U, P, torch.bfloat16, sms).weights_resident():
            return "rowgroup"
    except ValueError:
        pass
    try:
        wavefront.resident_plan(B, 1, U, P, dtype, sms)
    except ValueError as e:
        raise ValueError(f"no K1 kernel for B={B} U={U} P={P} {dtype}: "
                         f"{e}") from None
    return "resident"


def shape_key(proj, rows: int) -> str:
    """The key of a launch count by shape: the layer's U and P (``proj``
    is [U, P]) and its rows, the sizes that choose the kernel's plan."""
    return f"U={proj.shape[0]},P={proj.shape[1]},B={rows}"


def lstm_fwd(xw, lengths, w_h, proj, bias, wi, wf, wo, save_acts=True):
    """K1 (arguments and results as ``lstm_fwd_reference``). CPU tensors
    take the twin; CUDA tensors launch the kernel ``fwd_route`` names (the
    row-group kernel of csrc/resident.cu, ``rowgroup_plan``, or K4's
    resident grid at L = 1) or raise; each launch is counted in total, by
    shape and by route. With ``save_acts=False`` only ``out`` is computed
    (the rest is None)."""
    if xw.device.type == "cpu":
        return lstm_fwd_reference(xw, lengths, w_h, proj, bias, wi, wf, wo,
                                  save_acts)
    if xw.device.type != "cuda":
        raise ValueError(f"no LSTM forward kernel for device {xw.device}")
    B = xw.shape[1]
    U, P = proj.shape
    with spans.span("launch.k1"):
        with spans.span("launch.plan"):
            route = fwd_route(B, U, P, w_h.dtype,
                              resident.sm_count(xw.device))
        launch = (_launch_fwd_rowgroup if route == "rowgroup"
                  else _launch_fwd_resident)
        out = launch(xw, lengths, w_h, proj, bias, wi, wf, wo, save_acts)
        spans.count_launch(lstm_fwd, shape_key(proj, B), route)
    return out


lstm_fwd.launches = 0  # kernel launches in this process
lstm_fwd.launches_by_shape = {}  # the same launches by shape_key
lstm_fwd.launches_by_route = {}  # the same launches by fwd_route's name


# ---------------------------------------------------------------------------
# K2 / K3: the reverse walk
# ---------------------------------------------------------------------------

def _reverse_walk(acts, lengths, dout, c_hist, h_hist, w_h, proj, wi, wf,
                  wo, acc):
    """The twins of K2 (acc=False) and K3 (acc=True), step by step."""
    T, B, G = acts.shape
    U, P = proj.shape
    cdt = w_h.dtype
    live = _live(lengths, T, acts.device)
    w_hf, w_pf = w_h.float(), proj.float()
    dc = dout.new_zeros((B, U))
    dh = dout.new_zeros((B, P))
    zeros_u = dout.new_zeros((B, U))
    dxw, m_s, dh_s = [None] * T, [None] * T, [None] * T
    if acc:
        dwh, dproj = w_hf.new_zeros((P, G)), w_pf.new_zeros((U, P))
        dbias = dout.new_zeros(G)
        dwi, dwf, dwo = (dout.new_zeros(U) for _ in range(3))
    for t in reversed(range(T)):
        keep = live[t]
        c_new = c_hist[t]
        c_prev = c_hist[t - 1] if t > 0 else zeros_u
        si, tj, sf, so = acts[t].float().split(U, dim=1)
        tc = torch.tanh(c_new)
        dh_total = dout[t] + dh
        dm = _rnd(dh_total, cdt) @ w_pf.t()
        dm = torch.where(keep, dm, 0.0)
        d_o = dm * tc * so * (1.0 - so)
        dc_total = (dc * keep + dm * so * (1.0 - tc * tc) + d_o * wo)
        d_f = dc_total * c_prev * sf * (1.0 - sf)
        d_i = dc_total * tj * si * (1.0 - si)
        d_j = dc_total * si * (1.0 - tj * tj)
        dc_prev = dc_total * sf + d_f * wf + d_i * wi
        dgates = torch.where(keep, torch.cat([d_i, d_j, d_f, d_o], dim=1),
                             0.0)
        m_m = torch.where(keep, so * tc, 0.0)
        dh_m = torch.where(keep, dh_total, 0.0)
        dxw[t] = dgates.to(cdt)
        m_s[t], dh_s[t] = m_m.to(cdt), dh_m.to(cdt)
        if acc:
            h_prev = h_hist[t - 1] if t > 0 else torch.zeros_like(dh)
            dwh += _rnd(h_prev, cdt).t() @ _rnd(dgates, cdt)
            dproj += _rnd(m_m, cdt).t() @ _rnd(dh_m, cdt)
            dbias += dgates.sum(0)
            k = keep.float()
            dwi += (d_i * c_prev * k).sum(0)
            dwf += (d_f * c_prev * k).sum(0)
            dwo += (d_o * c_new * k).sum(0)
        dh_new = _rnd(dgates, cdt) @ w_hf.t()
        dc = torch.where(keep, dc_prev, dc)
        dh = torch.where(keep, dh_new, dh)
    dxw = torch.stack(dxw)
    if acc:
        return dxw, dwh, dproj, dbias, dwi, dwf, dwo
    return dxw, torch.stack(m_s), torch.stack(dh_s)


def lstm_bwd_reference(acts, lengths, dout, c_hist, w_h, proj, wi, wf, wo):
    """Plain twin of K2.

    acts [T, B, G] in W (the forward's gate activations), lengths [B],
    dout [T, B, P] f32 (gradient of the layer output), c_hist [T, B, U]
    f32 post-mask cell state, w_h [P, G] and proj [U, P] in W, peepholes
    [U] f32. Returns (dxw [T, B, G], m [T, B, U], dh [T, B, P]), all in W:
    the gate gradients (zero at masked steps), the masked m and the masked
    dh_total that ``lstm_weight_grads`` reduces.
    """
    return _reverse_walk(acts, lengths, dout, c_hist, None, w_h, proj, wi,
                         wf, wo, acc=False)


def lstm_bwd_acc_reference(acts, lengths, dout, c_hist, h_hist, w_h, proj,
                           wi, wf, wo):
    """Plain twin of K3 (arguments as ``lstm_bwd_reference`` plus h_hist
    [T, B, P] f32). Returns (dxw [T, B, G] in W, dwh [P, G], dproj [U, P],
    dbias [G], dwi, dwf, dwo [U]) with the weight gradients in f32: dwh and
    dproj from W-rounded operands, dbias and the peepholes from the f32
    dgates."""
    return _reverse_walk(acts, lengths, dout, c_hist, h_hist, w_h, proj, wi,
                         wf, wo, acc=True)


_ARGTYPES = ([ctypes.c_void_p] * 23 + [ctypes.c_int] * 7
             + [ctypes.c_void_p])


def _library() -> ctypes.CDLL:
    lib = _build.load_library("lstm_bwd")
    if lib.lstm_bwd.argtypes is None:
        lib.lstm_bwd.argtypes = _ARGTYPES
        lib.lstm_bwd.restype = ctypes.c_int
        lib.lstm_bwd_grid.argtypes = [ctypes.c_int] * 6
        lib.lstm_bwd_grid.restype = ctypes.c_int
        lib.lstm_bwd_error_string.argtypes = [ctypes.c_int]
        lib.lstm_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_bwd(acts, lengths, dout, c_hist, h_hist, w_h, proj, wi, wf, wo):
    T, B, G = acts.shape
    U, P = proj.shape
    cdt = w_h.dtype
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"weights must be float32 or bfloat16, got {cdt}")
    f32 = torch.float32
    want = {"acts": ((T, B, G), cdt), "lengths": ((B,), torch.int32),
            "dout": ((T, B, P), f32), "c_hist": ((T, B, U), f32),
            "w_h": ((P, G), cdt), "proj": ((U, P), cdt),
            "wi": ((U,), f32), "wf": ((U,), f32), "wo": ((U,), f32)}
    got = dict(acts=acts, lengths=lengths, dout=dout, c_hist=c_hist,
               w_h=w_h, proj=proj, wi=wi, wf=wf, wo=wo)
    if h_hist is not None:
        want["h_hist"] = ((T, B, P), f32)
        got["h_hist"] = h_hist
    for name, (shape, dtype) in want.items():
        t = got[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != acts.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {acts.device}")
    if T < 1 or B < 1 or G != 4 * U:
        raise ValueError(f"bad sizes T={T} B={B} G={G} U={U}")


def _launch_bwd(acts, lengths, dout, c_hist, h_hist, w_h, proj, wi, wf, wo,
                acc):
    if acts.device.type != "cuda":
        raise ValueError(f"no LSTM backward kernel for device {acts.device}")
    _check_bwd(acts, lengths, dout, c_hist, h_hist, w_h, proj, wi, wf, wo)
    lib = _library()
    T, B, G = acts.shape
    U, P = proj.shape
    cdt = w_h.dtype
    dev = acts.device
    with torch.cuda.device(dev):
        f32 = dict(dtype=torch.float32, device=dev)
        w_hT = w_h.t().contiguous()     # [G, P]: lanes on consecutive p
        projT = proj.t().contiguous()   # [P, U]: lanes on consecutive u
        dc = torch.zeros((B, U), **f32)
        dh = torch.zeros((B, P), **f32)
        dg = torch.empty((B, G), **f32)
        dxw = torch.empty((T, B, G), dtype=cdt, device=dev)
        m_out = torch.empty((T, B, U), dtype=cdt, device=dev)
        dh_out = torch.empty((T, B, P), dtype=cdt, device=dev)
        if acc:
            grads = (torch.empty((T, B, G), **f32),   # dgf scratch
                     torch.empty((P, G), **f32), torch.empty((U, P), **f32),
                     torch.empty((G,), **f32), torch.empty((U,), **f32),
                     torch.empty((U,), **f32), torch.empty((U,), **f32))
            grad_ptrs = [t.data_ptr() for t in grads]
        else:
            grad_ptrs = [None] * 7
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [acts.data_ptr(), lengths.data_ptr(), dout.data_ptr(),
                c_hist.data_ptr(),
                h_hist.data_ptr() if h_hist is not None else None,
                w_hT.data_ptr(), projT.data_ptr(), wi.data_ptr(),
                wf.data_ptr(), wo.data_ptr(), dc.data_ptr(), dh.data_ptr(),
                dg.data_ptr(), dxw.data_ptr(), m_out.data_ptr(),
                dh_out.data_ptr()]
        with spans.span("launch.call"):
            err = lib.lstm_bwd(*ptrs, *grad_ptrs, T, B, U, P, int(acc),
                               int(cdt == torch.bfloat16),
                               dev.index if dev.index is not None
                               else torch.cuda.current_device(), stream)
    if err != 0:
        raise RuntimeError(
            f"lstm_bwd launch failed: CUDA error {err} "
            f"({lib.lstm_bwd_error_string(err).decode()})")
    if acc:
        return (dxw,) + grads[1:]
    return dxw, m_out, dh_out


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """The partition of K2's resident kernel (csrc/resident.cu).

    Block i owns units [unit_bounds[i], unit_bounds[i+1]) (at most NU) and
    dh columns [col_bounds[i], col_bounds[i+1]). Products (A rows padded to
    Mp): dm = dh_total·projᵀ with K1 = P padded and NUn output rows of the
    packed proj slice; the partial dh = dgates·W_hᵀ with K2 = 4·NU padded
    and Np = P padded output rows. ld1 and ld2 are the row strides of the
    packed slices and of their A operands. Phase B sums an element's
    ``blocks`` partials with tpi threads (``resident.threads_per_sum``).
    ``offsets`` is the shared-memory layout, ``n_res_*`` the weight rows
    held there (the rest is read from the packed slice in global
    memory). With ``acc`` (K3's walk) each thread also sums the dbias and
    peephole terms of its (row, unit) cells, at most ``ACC_CELLS``, over
    the steps in registers; at the end the block sums them over its rows
    in row order through shared memory [7, B, NU] laid over region "a"."""
    B: int
    U: int
    P: int
    blocks: int
    unit_bounds: Tuple[int, ...]
    col_bounds: Tuple[int, ...]
    NU: int
    NUn: int
    K1: int
    ld1: int
    Np: int
    K2: int
    ld2: int
    Mp: int
    n_res_proj: int
    n_res_wh: int
    tpi: int
    offsets: Dict[str, int]
    smem: int
    acc: bool

    def weights_resident(self) -> bool:
        return self.n_res_proj == self.NUn and self.n_res_wh == self.Np


RESIDENT_THREADS = 256  # threads a block of the resident grids (kThreads)
ACC_CELLS = 8           # (row, unit) cells a thread sums in acc mode


@functools.lru_cache(maxsize=None)
def resident_plan(B: int, U: int, P: int, dtype: torch.dtype,
                  sms: int, acc: bool = False) -> BwdPlan:
    """K2's grid on a card with ``sms`` SMs: one block per SM, at most one
    per unit; units and dh columns split into balanced contiguous slices.
    ``acc``: the same walk as K3's, which also sums dbias and the peephole
    gradients (a block's B·NU cells within ACC_CELLS a thread, region "a"
    large enough for the sums' row reduction). Raises ValueError, with the
    shape, where no layout fits."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"weights must be float32 or bfloat16, got {dtype}")
    wb = 2 if dtype == torch.bfloat16 else 4
    shape = f"B={B} U={U} P={P} {dtype}"
    name = "K3" if acc else "K2"
    if min(B, U, P, sms) < 1:
        raise ValueError(f"no resident {name} plan for {shape} on {sms} SMs")
    blocks = min(sms, U)
    units = resident.balanced_bounds(U, blocks)
    NU = max(b - a for a, b in zip(units, units[1:]))
    NUn, Np, Mp = (resident.round_up(n, m) for n, m in
                   ((NU, 8), (P, 8), (B, 16)))
    K1, K2 = resident.round_up(P, 16), resident.round_up(4 * NU, 16)
    ld1, ld2 = K1 + 8, K2 + 8
    a_bytes = Mp * ld1 * wb
    if acc:
        if B * NU > ACC_CELLS * RESIDENT_THREADS:
            raise ValueError(
                f"no resident K3 plan for {shape}: {B} rows x {NU} units a "
                f"block exceed {ACC_CELLS * RESIDENT_THREADS} summed cells")
        a_bytes = max(a_bytes, 7 * B * NU * 4)
    try:
        offsets, rows, smem = resident.layout(
            {"a": a_bytes, "dm": B * NU * 4, "dg": Mp * ld2 * wb,
             "dc": B * NU * 4, "k": (3 * NU + B) * 4},
            [("proj", ld1 * wb, NUn), ("wh", ld2 * wb, Np)])
    except ValueError as e:
        raise ValueError(f"no resident {name} plan for {shape}: {e}") \
            from None
    cols = resident.balanced_bounds(P, blocks)
    tpi = resident.threads_per_sum(
        B * max(b - a for a, b in zip(cols, cols[1:])))
    return BwdPlan(B, U, P, blocks, tuple(units), tuple(cols), NU, NUn,
                   K1, ld1, Np, K2, ld2, Mp, rows["proj"], rows["wh"], tpi,
                   offsets, smem, acc)


def pack_bwd_weights(w_h, proj, plan: BwdPlan):
    """Each block's weight slices in the layout its products read:
    proj_pk [blocks, NUn, ld1] (row u = proj[u0 + u, :]) and wh_pk
    [blocks, Np, ld2] (row p, column g·NU + u = W_h[p, g·U + u0 + u]);
    zero in every pad."""
    U, P, NU, nb = plan.U, plan.P, plan.NU, plan.blocks
    idx = resident.unit_index(plan.unit_bounds, NU, U, w_h.device)
    proj_pad = torch.cat([proj, proj.new_zeros((1, P))])          # [U+1, P]
    proj_pk = proj.new_zeros((nb, plan.NUn, plan.ld1))
    proj_pk[:, :NU, :P] = proj_pad[idx]
    wh4 = torch.cat([w_h.reshape(P, 4, U), w_h.new_zeros((P, 4, 1))], 2)
    wh_g = wh4[:, :, idx].permute(2, 0, 1, 3).reshape(nb, P, 4 * NU)
    wh_pk = w_h.new_zeros((nb, plan.Np, plan.ld2))
    wh_pk[:, :P, :4 * NU] = wh_g
    return proj_pk, wh_pk


def _launch_bwd_resident(acts, lengths, dout, c_hist, w_h, proj, wi, wf,
                         wo, acc=False):
    """One launch of K2's resident kernel on CUDA tensors: (dxw, m, dh),
    with ``acc`` (K3's walk) also (dbias, dwi, dwf, dwo) in f32."""
    _check_bwd(acts, lengths, dout, c_hist, None, w_h, proj, wi, wf, wo)
    T, B, G = acts.shape
    U, P = proj.shape
    cdt, dev = w_h.dtype, acts.device
    with torch.cuda.device(dev):
        with spans.span("launch.plan"):
            plan = resident_plan(B, U, P, cdt, resident.sm_count(dev), acc)
        with spans.span("launch.pack"):
            proj_pk, wh_pk = pack_bwd_weights(w_h, proj, plan)
        bounds = resident.upload_int32(plan.unit_bounds + plan.col_bounds,
                                       dev)
        f32 = dict(dtype=torch.float32, device=dev)
        dh = torch.zeros((B, P), **f32)
        partial = torch.empty((plan.blocks, B, P), **f32)
        dxw = torch.empty((T, B, G), dtype=cdt, device=dev)
        m_out = torch.empty((T, B, U), dtype=cdt, device=dev)
        dh_out = torch.empty((T, B, P), dtype=cdt, device=dev)
        sums = (torch.empty((G,), **f32),) + tuple(
            torch.empty((U,), **f32) for _ in range(3)) if acc else ()
        o = plan.offsets
        params = resident.BwdParams(
            *(t.data_ptr() for t in (acts, lengths, dout, c_hist, wi, wf, wo,
                                     proj_pk, wh_pk, bounds, dh, partial,
                                     dxw, m_out, dh_out) + sums),
            *[None] * (4 - len(sums)),
            T, B, U, P, plan.blocks, plan.NU, plan.NUn, plan.K1, plan.ld1,
            plan.Np, plan.K2, plan.ld2, plan.Mp, plan.n_res_proj,
            plan.n_res_wh, plan.tpi, int(acc), o["a"], o["dm"], o["dg"],
            o["dc"], o["k"], o["proj"], o["wh"], plan.smem)
        resident.launch("lstm_bwd_resident", params, cdt == torch.bfloat16,
                        dev, f"T={T} B={B} U={U} P={P} {cdt}")
    return (dxw, m_out, dh_out) + sums


def lstm_bwd(acts, lengths, dout, c_hist, w_h, proj, wi, wf, wo):
    """K2 (arguments and results as ``lstm_bwd_reference``). CPU tensors
    take the twin; CUDA tensors launch the resident kernel of
    csrc/resident.cu (``resident_plan``) or raise."""
    if acts.device.type == "cpu":
        return lstm_bwd_reference(acts, lengths, dout, c_hist, w_h, proj,
                                  wi, wf, wo)
    if acts.device.type != "cuda":
        raise ValueError(f"no LSTM backward kernel for device {acts.device}")
    with spans.span("launch.k2"):
        out = _launch_bwd_resident(acts, lengths, dout, c_hist, w_h, proj,
                                   wi, wf, wo)
        spans.count_launch(lstm_bwd, shape_key(proj, acts.shape[1]))
    return out


lstm_bwd.launches = 0  # kernel launches in this process
lstm_bwd.launches_by_shape = {}  # the same launches by shape_key


@dataclasses.dataclass(frozen=True)
class RowBwdPlan:
    """The layout of K3's row-group walk (csrc/resident.cu).

    Block i walks rows [row_bounds[i], row_bounds[i+1]) back from T - 1,
    at most ``group_rows`` (as ``rowgroup_plan``: as few as the card's SMs
    allow). Unit group q (units 8q .. 8q+7, ``ngrp`` groups, at most four
    a warp) is owned by warp ``owner(q)``: it computes the group's dm and
    its lanes run the group's cells. Products: dm = dh_total·projᵀ with
    K = K1 = P padded over the 8·ngrp packed proj rows, and dh =
    dgates·W_hᵀ with K = K2 = 4U padded over Np = P padded packed W_h
    rows; bf16 on mma tiles (A rows padded to 16), the dh product's K
    split into ``ks`` chunks of ``kchunk`` 16-wide steps, one (8-row tile,
    chunk) task a warp, whose partials [ks, group_rows, Np] are summed in
    chunk order; f32 on CUDA cores (A rows the group's), dm by the cell's
    lane, dh one warp an output over all of K (ks = 1). ld1 and ld2 are
    the row strides of the packed
    weights and of their A operands. The next step's acts arrive in
    shared memory [group_rows, lda] and c(t-2) in a two-slot ring
    [2, group_rows, ldc] by cp.async, in ``achunk``- and ``cchunk``-byte
    copies. ``offsets`` is the shared-memory layout, ``n_res_*`` the
    weight rows held there (the rest is read from the packed weights in
    global memory)."""
    B: int
    U: int
    P: int
    group_rows: int
    groups: int
    row_bounds: Tuple[int, ...]
    ngrp: int
    K1: int
    ld1: int
    K2: int
    ld2: int
    Np: int
    ks: int
    kchunk: int
    lda: int
    achunk: int
    ldc: int
    cchunk: int
    n_res_p: int
    n_res_h: int
    offsets: Dict[str, int]
    smem: int

    owner = staticmethod(FwdPlan.owner)

    def weights_resident(self) -> bool:
        return self.n_res_p == 8 * self.ngrp and self.n_res_h == self.Np


ROW_THREADS = 32 * ROW_WARPS
EPI_PER_THREAD = 2  # the walk's epilogue elements a thread (kEpi)


@functools.lru_cache(maxsize=None)
def rowgroup_bwd_plan(B: int, U: int, P: int, dtype: torch.dtype,
                      sms: int) -> RowBwdPlan:
    """K3's walk on a card with ``sms`` SMs: ceil(B / group_rows) blocks
    over balanced row groups. Raises ValueError, with the shape, where no
    layout fits (more than 512 units, or a group's staging beyond shared
    memory)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"weights must be float32 or bfloat16, got {dtype}")
    bf16 = dtype == torch.bfloat16
    wb, pad = (2, 8) if bf16 else (4, 4)
    shape = f"B={B} U={U} P={P} {dtype}"
    if min(B, U, P, sms) < 1:
        raise ValueError(f"no row-group K3 plan for {shape} on {sms} SMs")
    ngrp = -(-U // 8)
    if ngrp > 4 * ROW_WARPS:
        raise ValueError(f"no row-group K3 plan for {shape}: a block's "
                         f"warps own at most {32 * ROW_WARPS} units")
    K1, K2, Np = (resident.round_up(n, m) for n, m in
                  ((P, 16), (4 * U, 16), (P, 8)))
    ld1, ld2 = K1 + pad, K2 + pad
    lda = 4 * U + 16 // wb  # as K1's ldx: 16 bytes more than a row
    achunk = 16 if 4 * U * wb % 16 == 0 else 8
    ldc = resident.round_up(U, 4)
    cchunk = 16 if U % 4 == 0 else 8 if U % 2 == 0 else 4
    ksteps = K2 // 16
    fewest = 1
    while fewest < ROW_TILE and -(-B // fewest) > sms:
        fewest *= 2
    if bf16:  # (8-column tile, K chunk) tasks, one a warp
        ks = max(1, min(ROW_WARPS // (Np // 8), ksteps))
        kchunk = -(-ksteps // ks)
        ks = -(-ksteps // kchunk)
    else:  # f32: one warp an output over the whole K
        ks, kchunk = 1, ksteps
    error = None
    for group_rows in (r for r in (16, 8, 4, 2, 1) if r <= fewest):
        if group_rows * P > EPI_PER_THREAD * ROW_THREADS:
            error = (f"{group_rows} rows of {P} columns exceed the "
                     f"epilogue's {EPI_PER_THREAD * ROW_THREADS} elements")
            continue
        a_rows = ROW_TILE if bf16 else group_rows
        try:
            offsets, rows, smem = resident.layout(
                {"a1": a_rows * ld1 * wb, "a2": a_rows * ld2 * wb,
                 "dm": group_rows * 8 * ngrp * 4,
                 "acts": group_rows * lda * wb, "c": 2 * group_rows * ldc * 4,
                 "dc": group_rows * U * 4, "part": ks * group_rows * Np * 4,
                 "len": ROW_TILE * 4},
                [("wp", ld1 * wb, 8 * ngrp), ("wh", ld2 * wb, Np)],
                multiple={"wp": 8, "wh": 8})
            break
        except ValueError as e:
            error = e
    else:
        raise ValueError(f"no row-group K3 plan for {shape}: {error}")
    groups = -(-B // group_rows)
    return RowBwdPlan(B, U, P, group_rows, groups,
                      tuple(resident.balanced_bounds(B, groups)), ngrp, K1,
                      ld1, K2, ld2, Np, ks, kchunk, lda, achunk, ldc, cchunk,
                      rows["wp"], rows["wh"], offsets, smem)


def pack_bwd_rowgroup_weights(w_h, proj, plan: RowBwdPlan):
    """K3's walk's weights in the layout its products read: wp_pk
    [8·ngrp, ld1] (row u = proj[u, :]) and wh_pk [Np, ld2] (row p =
    W_h[p, :]); zero in every pad."""
    U, P = plan.U, plan.P
    wp_pk = proj.new_zeros((8 * plan.ngrp, plan.ld1))
    wp_pk[:U, :P] = proj
    wh_pk = w_h.new_zeros((plan.Np, plan.ld2))
    wh_pk[:P, :4 * U] = w_h
    return wp_pk, wh_pk


@functools.lru_cache(maxsize=None)
def rowgroup_bwd_route(B: int, U: int, P: int, sms: int) -> bool:
    """Whether K3 at these sizes takes the row-group walk (on a card with
    ``sms`` SMs): where the layer's bf16 weights all fit in one block, as
    the D layer's do, in either dtype."""
    try:
        return rowgroup_bwd_plan(B, U, P, torch.bfloat16,
                                 sms).weights_resident()
    except ValueError:
        return False


# Most rows for which f32 takes the resident walk. Its f32 products run on
# CUDA cores and grow with the rows faster than csrc/lstm_bwd.cu's, which
# is the faster route past this at G width on the H100
# (tools/time_k3_routes.py; PERF.md section 6).
RESIDENT_F32_MAX_ROWS = 48


def bwd_acc_route(B: int, U: int, P: int, dtype: torch.dtype,
                  sms: int) -> str:
    """K3's route at these sizes on a card with ``sms`` SMs, a pure
    function of the shape: "rowgroup" where ``rowgroup_bwd_route`` holds
    (the D layer); else "resident" where K2's grid holds the walk in acc
    mode (``resident_plan(..., acc=True)``: G width at B=32..256 in bf16)
    and, in f32, B is at most RESIDENT_F32_MAX_ROWS; else "streaming"
    (csrc/lstm_bwd.cu: G width in f32 past those rows)."""
    if rowgroup_bwd_route(B, U, P, sms):
        return "rowgroup"
    if dtype == torch.float32 and B > RESIDENT_F32_MAX_ROWS:
        return "streaming"
    try:
        resident_plan(B, U, P, dtype, sms, acc=True)
    except ValueError:
        return "streaming"
    return "resident"


WG_TILE = 64   # the reduction's output tile edge (kWgTile)
WG_K = 32      # K rows its f32 path stages at a time (kWgK)
WG_THREADS = 256
WG_FILL = 4    # blocks an SM the K split aims for, where K allows


@dataclasses.dataclass(frozen=True)
class WgradPlan:
    """The grid of K3's weight-gradient reduction (``lstm_wgrad_kernel``).

    dW_h [P, 4U] in ``tiles_wh`` 64 x 64 tiles, then dproj [U, P]: tiles
    ``tiles`` in all, each reduced over its K = (T-1)·B (dW_h) or T·B
    (dproj) row-steps in ``splits`` slices of ``rows_wh`` / ``rows_proj``
    rows, one block a (slice, tile), the slices then summed in order.
    After the row-group walk the launcher adds the blocks that sum dbias
    and the peepholes over its group partials."""
    tiles_wh: int
    tiles: int
    splits: int
    rows_wh: int
    rows_proj: int


@functools.lru_cache(maxsize=None)
def wgrad_plan(T: int, B: int, U: int, P: int, sms: int) -> WgradPlan:
    """K split so that the (slice, tile) blocks give every SM at least
    WG_FILL (G width: 300 tiles in 2 slices; the D layer: 20 in 27), where
    K has that many WG_K-row slices."""
    G, ceil = 4 * U, lambda a, b: -(-a // b)  # noqa: E731
    tiles_wh = ceil(P, WG_TILE) * ceil(G, WG_TILE)
    tiles = tiles_wh + ceil(U, WG_TILE) * ceil(P, WG_TILE)
    splits = max(1, min(ceil(WG_FILL * sms, tiles), ceil(T * B, WG_K)))

    def rows(K):
        return max(WG_K, resident.round_up(ceil(K, splits), WG_K))
    return WgradPlan(tiles_wh, tiles, splits, rows((T - 1) * B), rows(T * B))


def _launch_wgrad(h_hist, dxw, m, dh, part=None):
    """K3's weight-gradient reduction on CUDA tensors, after a walk: (dwh,
    dproj) in f32 from the walk's streams dxw, m and dh and from h_hist;
    with the row-group walk's group partials ``part`` [groups, 7U] also
    (dbias, dwi, dwf, dwo)."""
    T, B, G = dxw.shape
    U, P = m.shape[2], dh.shape[2]
    cdt, dev = dxw.dtype, dxw.device
    with torch.cuda.device(dev):
        with spans.span("launch.plan"):
            wplan = wgrad_plan(T, B, U, P, resident.sm_count(dev))
        f32 = dict(dtype=torch.float32, device=dev)
        grads = (torch.empty((P, G), **f32), torch.empty((U, P), **f32))
        if part is not None:
            grads += (torch.empty((G,), **f32),) + tuple(
                torch.empty((U,), **f32) for _ in range(3))
        split = torch.empty((wplan.splits, P * G + U * P), **f32)
        counters = torch.zeros(wplan.tiles, dtype=torch.int32, device=dev)
        ptrs = [t.data_ptr() for t in grads] + [None] * (6 - len(grads))
        wparams = resident.WgradParams(
            h_hist.data_ptr(), dxw.data_ptr(), m.data_ptr(), dh.data_ptr(),
            None if part is None else part.data_ptr(), split.data_ptr(),
            counters.data_ptr(), *ptrs, T, B, U, P,
            0 if part is None else part.shape[0], wplan.splits,
            wplan.tiles_wh, wplan.tiles, wplan.rows_wh, wplan.rows_proj)
        resident.launch("lstm_wgrad", wparams, cdt == torch.bfloat16, dev,
                        f"T={T} B={B} U={U} P={P} {cdt}")
    return grads


def _launch_bwd_rowgroup_walk(acts, lengths, dout, c_hist, w_h, proj, wi,
                              wf, wo):
    """K3's row-group walk on CUDA tensors: (dxw, m, dh, the group
    partials [groups, 7U] of dbias and the peephole sums)."""
    T, B, G = acts.shape
    U, P = proj.shape
    cdt, dev = w_h.dtype, acts.device
    bf16, shape = cdt == torch.bfloat16, f"T={T} B={B} U={U} P={P} {cdt}"
    with torch.cuda.device(dev):
        with spans.span("launch.plan"):
            plan = rowgroup_bwd_plan(B, U, P, cdt, resident.sm_count(dev))
        with spans.span("launch.pack"):
            wp_pk, wh_pk = pack_bwd_rowgroup_weights(w_h, proj, plan)
        rows = resident.upload_int32(plan.row_bounds, dev)
        f32 = dict(dtype=torch.float32, device=dev)
        dxw = torch.empty((T, B, G), dtype=cdt, device=dev)
        m_out = torch.empty((T, B, U), dtype=cdt, device=dev)
        dh_out = torch.empty((T, B, P), dtype=cdt, device=dev)
        part = torch.empty((plan.groups, 7 * U), **f32)
        o = plan.offsets
        params = resident.RowBwdParams(
            *(t.data_ptr() for t in (acts, lengths, dout, c_hist, wp_pk,
                                     wh_pk, wi, wf, wo, rows, dxw, m_out,
                                     dh_out, part)),
            T, B, U, P, plan.groups, plan.group_rows, plan.ngrp, plan.K1,
            plan.ld1, plan.K2, plan.ld2, plan.Np, plan.ks, plan.kchunk,
            plan.lda, plan.achunk, plan.ldc, plan.cchunk, plan.n_res_p,
            plan.n_res_h, o["a1"], o["a2"], o["dm"], o["acts"], o["c"],
            o["dc"], o["part"], o["len"], o["wp"], o["wh"], plan.smem)
        resident.launch("lstm_bwd_rowgroup", params, bf16, dev, shape)
    return dxw, m_out, dh_out, part


def _launch_bwd_rowgroup(acts, lengths, dout, c_hist, h_hist, w_h, proj, wi,
                         wf, wo):
    """K3 on CUDA tensors: the row-group walk, then the reduction."""
    _check_bwd(acts, lengths, dout, c_hist, h_hist, w_h, proj, wi, wf, wo)
    dxw, m, dh, part = _launch_bwd_rowgroup_walk(acts, lengths, dout, c_hist,
                                                 w_h, proj, wi, wf, wo)
    return (dxw,) + _launch_wgrad(h_hist, dxw, m, dh, part)


def _launch_bwd_resident_acc(acts, lengths, dout, c_hist, h_hist, w_h, proj,
                             wi, wf, wo):
    """K3 on CUDA tensors: K2's resident walk in acc mode (dxw, m, dh
    and the dbias and peephole sums), then the reduction."""
    _check_bwd(acts, lengths, dout, c_hist, h_hist, w_h, proj, wi, wf, wo)
    dxw, m, dh, *sums = _launch_bwd_resident(
        acts, lengths, dout, c_hist, w_h, proj, wi, wf, wo, acc=True)
    return (dxw,) + _launch_wgrad(h_hist, dxw, m, dh) + tuple(sums)


def lstm_bwd_acc(acts, lengths, dout, c_hist, h_hist, w_h, proj, wi, wf,
                 wo):
    """K3 (arguments and results as ``lstm_bwd_acc_reference``). CPU
    tensors take the twin; CUDA tensors launch the route ``bwd_acc_route``
    names: the row-group walk and the reduction of csrc/resident.cu
    ("rowgroup"), the resident walk and the reduction ("resident") or
    csrc/lstm_bwd.cu ("streaming"), each launch counted in total, by
    shape and by that route's name; a refused launch raises."""
    if acts.device.type == "cpu":
        return lstm_bwd_acc_reference(acts, lengths, dout, c_hist, h_hist,
                                      w_h, proj, wi, wf, wo)
    if acts.device.type != "cuda":
        raise ValueError(f"no LSTM backward kernel for device {acts.device}")
    _, B, _ = acts.shape
    U, P = proj.shape
    args = (acts, lengths, dout, c_hist, h_hist, w_h, proj, wi, wf, wo)
    with spans.span("launch.k3"):
        with spans.span("launch.plan"):
            route = bwd_acc_route(B, U, P, w_h.dtype,
                                  resident.sm_count(acts.device))
        if route == "rowgroup":
            out = _launch_bwd_rowgroup(*args)
        elif route == "resident":
            out = _launch_bwd_resident_acc(*args)
        else:
            out = _launch_bwd(*args, acc=True)
        spans.count_launch(lstm_bwd_acc, shape_key(proj, B), route)
    return out


lstm_bwd_acc.launches = 0  # kernel launches (walk + reduction: one)
lstm_bwd_acc.launches_by_shape = {}  # the same launches by shape_key
lstm_bwd_acc.launches_by_route = {}  # the same by bwd_acc_route's name


def lstm_bwd_grid(B: int, U: int, P: int, acc: bool, bf16: bool,
                  device: int = 0) -> int:
    """Blocks a backward launch at these sizes uses (co-resident cap
    applied)."""
    grid = _library().lstm_bwd_grid(B, U, P, int(acc), int(bf16), device)
    if grid < 0:
        raise RuntimeError(f"lstm_bwd grid query failed: CUDA error {-grid}")
    return grid


def lstm_weight_grads(U, dxw, m, dh, c_hist, h_hist):
    """Weight gradients from K2's streams, as full-sequence products
    outside the kernel (``pallas_lstm.py`` ``lstm_weight_grads``). Returns
    (dwh [P, G], dproj [U, P], dbias [G], dwi, dwf, dwo [U]) in f32.

    h(t-1) and c(t-1) pair with dgates(t); at t = 0 the previous state is
    the zero initial state, so those sums run over t = 1..T-1. dw_o pairs
    with c(t) (c_new), dw_i and dw_f with c(t-1)."""
    dxf = dxw.float()
    dwh = torch.einsum("tbp,tbg->pg", h_hist[:-1], dxf[1:])
    dproj = torch.einsum("tbu,tbp->up", m.float(), dh.float())
    dbias = dxf.sum((0, 1))
    d_i, _, d_f, d_o = dxf.split(U, dim=2)
    dwi = (d_i[1:] * c_hist[:-1]).sum((0, 1))
    dwf = (d_f[1:] * c_hist[:-1]).sum((0, 1))
    dwo = (d_o * c_hist).sum((0, 1))
    return dwh, dproj, dbias, dwi, dwf, dwo


def lstm_layer_bwd(acts, lengths, dout, c_hist, h_hist, w_h, proj, wi, wf,
                   wo):
    """One layer's backward from the saved forward streams. Returns (dxw
    in W, dwh, dproj, dbias, dwi, dwf, dwo in f32). Below
    ``ACC_BWD_MIN_BATCH`` rows K2 streams dgates/m/dh out and the weight
    gradients are reduced here with ``torch.einsum``; from there K3
    reduces them in the kernel (``pallas_lstm.py`` ``lstm_layer_bwd``)."""
    with spans.span("glue.layer_bwd"):
        if acts.shape[1] >= ACC_BWD_MIN_BATCH:
            return lstm_bwd_acc(acts, lengths, dout, c_hist, h_hist, w_h,
                                proj, wi, wf, wo)
        dxw, m, dh = lstm_bwd(acts, lengths, dout, c_hist, w_h, proj, wi, wf,
                              wo)
        return (dxw,) + lstm_weight_grads(proj.shape[0], dxw, m, dh, c_hist,
                                          h_hist)


# ---------------------------------------------------------------------------
# the differentiable layer
# ---------------------------------------------------------------------------

def fold_forget_bias(bias: torch.Tensor, forget_bias: float) -> torch.Tensor:
    """bias [..., 4U] with forget_bias added to the f quarter."""
    U = bias.shape[-1] // 4
    fb = torch.zeros(4, U, dtype=bias.dtype, device=bias.device)
    fb[2] = forget_bias
    return bias + fb.reshape(-1)


class LstmSeqFn(torch.autograd.Function):
    """K1 forward, K2/K3 backward: the JAX ``lstm_seq_pallas`` custom_vjp.

    Inputs xw [T, B, G] f32 (W-representable), lengths [B], w_h [P, G]
    and proj [U, P] in W, bias [G] (forget_bias folded), peepholes [U].
    Output out [T, B, P] f32. Gradients: dxw in f32, dW_h and dproj
    rounded to W (as the JAX vjp casts them to the weights' dtype), the
    rest f32."""

    @staticmethod
    def forward(ctx, xw, lengths, w_h, proj, bias, wi, wf, wo):
        out, c_hist, h_hist, acts = lstm_fwd(
            xw.to(w_h.dtype).contiguous(), lengths, w_h, proj, bias, wi,
            wf, wo, save_acts=True)
        ctx.save_for_backward(acts, lengths, c_hist, h_hist, w_h, proj, wi,
                              wf, wo)
        return out

    @staticmethod
    def backward(ctx, dout):
        with spans.span("glue.seq_bwd"):
            acts, lengths, c_hist, h_hist, w_h, proj, wi, wf, wo = \
                ctx.saved_tensors
            dxw, dwh, dproj, dbias, dwi, dwf, dwo = lstm_layer_bwd(
                acts, lengths, dout.float().contiguous(), c_hist, h_hist,
                w_h, proj, wi, wf, wo)
            return (dxw.float(), None, dwh.to(w_h.dtype),
                    dproj.to(proj.dtype), dbias, dwi, dwf, dwo)


def lstm_seq(xw, lengths, w_h, proj, bias, wi, wf, wo, forget_bias=1.0,
             compute_dtype=torch.float32, save_acts=True):
    """One fused LSTM layer with natural shapes (``pallas_lstm.py``
    ``lstm_seq``): xw [T, B, 4U] f32, lengths [B] or None, w_h [P, 4U],
    proj [U, P], bias [4U], peepholes [U]. Returns out [T, B, P] f32.

    ``compute_dtype`` sets the products' operand precision and the dtype
    of the saved activations. ``save_acts=False`` is the inference
    forward (K1 without the activation stream), which is not
    differentiable."""
    with spans.span("glue.seq_fwd"):
        T, B, _ = xw.shape
        if lengths is None:
            lengths = torch.full((B,), T, dtype=torch.int32)
        lengths = lengths.to(device=xw.device,
                             dtype=torch.int32).contiguous()
        w_h = w_h.to(compute_dtype).contiguous()
        proj = proj.to(compute_dtype).contiguous()
        bias = fold_forget_bias(bias, forget_bias).contiguous()
        wi, wf, wo = (w.contiguous() for w in (wi, wf, wo))
        if not save_acts:
            with torch.no_grad():
                return lstm_fwd(xw.to(compute_dtype).contiguous(), lengths,
                                w_h, proj, bias, wi, wf, wo,
                                save_acts=False)[0]
        return LstmSeqFn.apply(xw, lengths, w_h, proj, bias, wi, wf, wo)
