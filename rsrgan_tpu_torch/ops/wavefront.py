"""The wavefront multi-layer LSTM forward: CUDA kernel wrapper and its
plain PyTorch twin (counterpart of ``rsrgan_tpu/ops/pallas_wavefront.py``).

``lstm_wavefront_fwd`` (inference, the TPU kernel's ``save_acts=False``:
the top layer's tap) and ``lstm_wavefront_fwd_train`` (``save_acts=True``:
every layer's tap, c, h and gate activations for the backward) run the
resident kernel of ``csrc/resident.cu`` for CUDA tensors (each block of a
one-block-per-SM grid holds one layer's slice of W_h, W_x and proj in
shared memory for the whole launch, as ``resident_plan`` partitions
them) and ``lstm_wavefront_fwd_reference`` for CPU tensors; they never
fall back from one to the other. Each counts its own launches
(``spans.count_launch``) and names its host side in a span
(``launch.k4_decode``, ``launch.k4_train``: the plan, the packing, the
uploads and the call within). A shape the plan cannot hold raises, with
the shape in the message.

``_launch_resident`` at L = 1 without the residual is also K1's kernel
where a layer's weights do not fit one SM (G width: ``ops/lstm_seq.py``
``fwd_route``), launched and counted by ``lstm_fwd``, not by the two
wrappers here.

``_launch`` runs the earlier kernel, ``csrc/wavefront_fwd.cu``, which
streams its weights from L2; no path of the port calls it, and
``chip_smoke.py`` times it beside the kernels that replaced it (K4 here,
and at L = 1 K1, ``ops/lstm_seq.py`` ``lstm_fwd``).

Differences from the TPU launcher, all TPU-only choices: no 128-lane gate
padding (U stays 760), no rows-per-step coarsening, and the per-layer
block-shifted mask becomes a ``lengths`` vector the kernel reads itself.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from rsrgan_tpu_torch import spans
from rsrgan_tpu_torch.ops import _build, resident


def lstm_wavefront_fwd_reference(xw1, lengths, x, wx, wh, proj, bias,
                                 wi, wf, wo, residual=True, save_acts=False):
    """Plain PyTorch twin of the kernel, layer by layer and step by step.

    xw1 [T, B, G] layer-1 input projection in the compute dtype W;
    lengths [B]; x [T, B, P] f32 raw inputs; wx [L-1, P, G], wh [L, P, G],
    proj [L, U, P] in W; bias [L, G] (forget_bias folded) and peepholes
    wi/wf/wo [L, U] in f32. Returns the top tap [T, B, P] f32; with
    ``save_acts`` the training streams (taps, c_hist, h_hist, acts) of
    ``lstm_wavefront_fwd_train`` instead.

    Precision as the kernel: the operands of each product (layer input,
    h, m, weights) are rounded to W, products accumulate in f32 (an f32
    matmul of W-rounded values is exact per product), state stays f32.
    """
    T, B, G = xw1.shape
    L, U = wh.shape[0], G // 4
    cdt = wh.dtype

    def rnd(a):
        return a.to(cdt).float()

    live = (torch.arange(T, device=x.device)[:, None]
            < lengths.to(x.device)[None, :])[:, :, None]   # [T, B, 1]
    layer_in = x
    streams = ([], [], [], [])  # taps, c_hist, h_hist, acts per layer
    for k in range(L):
        xw = (xw1.float() if k == 0
              else rnd(layer_in) @ wx[k - 1].float())       # [T, B, G]
        w_h, w_p = wh[k].float(), proj[k].float()
        c = x.new_zeros((B, U))
        h = x.new_zeros((B, x.shape[2]))
        outs, cs, hs, acts = [], [], [], []
        for t in range(T):
            gates = xw[t] + rnd(h) @ w_h + bias[k]
            i, j, f, o = gates.split(U, dim=1)
            si = torch.sigmoid(i + wi[k] * c)
            sf = torch.sigmoid(f + wf[k] * c)
            tj = torch.tanh(j)
            c_new = sf * c + si * tj
            so = torch.sigmoid(o + wo[k] * c_new)
            h_new = rnd(so * torch.tanh(c_new)) @ w_p
            c = torch.where(live[t], c_new, c)
            h = torch.where(live[t], h_new, h)
            outs.append(torch.where(live[t], h_new, torch.zeros_like(h_new)))
            if save_acts:
                cs.append(c)
                hs.append(h)
                acts.append(torch.cat([si, tj, sf, so], dim=1).to(cdt))
        out = torch.stack(outs)
        layer_in = out + layer_in if residual else out
        if save_acts:
            streams[0].append(layer_in)
            for stream, steps in zip(streams[1:], (cs, hs, acts)):
                stream.append(torch.stack(steps))
    if save_acts:
        return tuple(torch.stack(s) for s in streams)
    return layer_in


_ARGTYPES = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 9
             + [ctypes.c_void_p])


def _library() -> ctypes.CDLL:
    lib = _build.load_library("wavefront_fwd")
    if lib.wavefront_fwd.argtypes is None:
        lib.wavefront_fwd.argtypes = _ARGTYPES
        lib.wavefront_fwd.restype = ctypes.c_int
        lib.wavefront_error_string.argtypes = [ctypes.c_int]
        lib.wavefront_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(xw1, lengths, x, wx, wh, proj, bias, wi, wf, wo):
    """Shapes, dtypes and devices of the kernels' arguments; ``x`` may be
    None (the resident kernel without the residual never reads it)."""
    T, B, G = xw1.shape
    L, P, U = wh.shape[0], wh.shape[1], G // 4
    cdt = wh.dtype
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"weights must be float32 or bfloat16, got {cdt}")
    want = {"xw1": ((T, B, G), cdt), "lengths": ((B,), torch.int32),
            "x": ((T, B, P), torch.float32), "wx": ((L - 1, P, G), cdt),
            "wh": ((L, P, G), cdt), "proj": ((L, U, P), cdt),
            "bias": ((L, G), torch.float32), "wi": ((L, U), torch.float32),
            "wf": ((L, U), torch.float32), "wo": ((L, U), torch.float32)}
    got = dict(xw1=xw1, lengths=lengths, x=x, wx=wx, wh=wh, proj=proj,
               bias=bias, wi=wi, wf=wf, wo=wo)
    for name, (shape, dtype) in want.items():
        t = got[name]
        if t is None and name == "x":
            continue
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != xw1.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {xw1.device}")
    if T < 1 or B < 1 or G % 4:
        raise ValueError(f"bad sizes T={T} B={B} G={G}")


def _launch(xw1, lengths, x, wx, wh, proj, bias, wi, wf, wo, residual,
            save_acts):
    """One launch of csrc/wavefront_fwd.cu on CUDA tensors: the top tap,
    or with ``save_acts`` the (taps, c_hist, h_hist, acts) streams."""
    _check_inputs(xw1, lengths, x, wx, wh, proj, bias, wi, wf, wo)
    lib = _library()
    T, B, G = xw1.shape
    L, P, U = wh.shape[0], x.shape[2], G // 4
    dev = x.device
    with torch.cuda.device(dev):
        f32 = dict(dtype=torch.float32, device=dev)
        c = torch.zeros((L, B, U), **f32)
        h = torch.zeros((L, B, P), **f32)
        m = torch.empty((L, B, U), **f32)
        inbuf = torch.empty((2, L, B, P), **f32)
        if save_acts:
            saved = (torch.empty((L, T, B, P), **f32),
                     torch.empty((L, T, B, U), **f32),
                     torch.empty((L, T, B, P), **f32),
                     torch.empty((L, T, B, G), dtype=wh.dtype, device=dev))
            saved_ptrs = [t.data_ptr() for t in saved]
            y, y_ptr = None, None  # the top tap is saved[0][L-1]
        else:
            y = torch.empty((T, B, P), **f32)
            saved_ptrs, y_ptr = [None] * 4, y.data_ptr()
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [t.data_ptr() for t in (xw1, x, lengths, wx, wh, proj, bias,
                                       wi, wf, wo, c, h, m, inbuf)]
        err = lib.wavefront_fwd(*ptrs, y_ptr, *saved_ptrs, T, B, L, U, P,
                                int(bool(residual)), int(save_acts),
                                int(wh.dtype == torch.bfloat16),
                                dev.index if dev.index is not None
                                else torch.cuda.current_device(), stream)
    if err != 0:
        raise RuntimeError(
            f"wavefront_fwd launch failed: CUDA error {err} "
            f"({lib.wavefront_error_string(err).decode()})")
    return saved if save_acts else y


@dataclasses.dataclass(frozen=True)
class WavefrontPlan:
    """The partition of K4's resident kernel (csrc/resident.cu).

    Block i is (layer i // nbl, unit slice i % nbl): it owns units
    [unit_bounds[j], unit_bounds[j+1]) of its layer (at most NU, padded
    to an even NU so that the NG = 4·NU gate columns fill 8-wide tiles)
    and the (layer, column) pairs [pair_bounds[i], pair_bounds[i+1]) of
    the L·P pairs (pair = layer·P + column) in phase B. Products (A rows
    padded to Mp): the gates [h | in]·[W_h; W_x] with K = Kp = 2P padded
    (at L = 1, K1's layer, h·W_h alone with K = Kp = P padded: a single
    layer has no in-part) and the partial h = m·proj with K = Km = NU
    padded and Np = P padded output rows (f32 at L = 1: one output a
    thread over the block's units, rows ldm = NU + 1 apart); ldw and ldm
    are the row strides of the packed slices and of their A operands.
    Phase B sums a pair's nbl partials with tpi threads
    (``resident.threads_per_sum``). ``offsets`` is the shared-memory
    layout, ``n_res_*`` the weight rows held there."""
    B: int
    L: int
    U: int
    P: int
    nbl: int
    unit_bounds: Tuple[int, ...]
    pair_bounds: Tuple[int, ...]
    NU: int
    NG: int
    Kp: int
    ldw: int
    Np: int
    Km: int
    ldm: int
    Mp: int
    n_res_g: int
    n_res_p: int
    tpi: int
    offsets: Dict[str, int]
    smem: int

    @property
    def blocks(self) -> int:
        return self.L * self.nbl

    def weights_resident(self) -> bool:
        return self.n_res_g == self.NG and self.n_res_p == self.Np


# Units a block at L = 1 (K1's layer at G width): a step's time there is
# the latencies of staging h, of the partial h's stores and of phase B's
# sums over the blocks, which fall with fewer blocks, against the block's
# own gate product, which grows with its units; bf16's tiles take 16 units
# (the projection's K in one 16-wide step), f32's products on CUDA cores
# fewer (tools/time_k1_plans.py on the H100; PERF.md).
SINGLE_LAYER_UNITS = {torch.bfloat16: 16, torch.float32: 8}


@functools.lru_cache(maxsize=None)
def resident_plan(B: int, L: int, U: int, P: int, dtype: torch.dtype,
                  sms: int, nbl: Optional[int] = None) -> WavefrontPlan:
    """K4's grid on a card with ``sms`` SMs: ``nbl`` blocks per layer
    (default sms // L, and at L = 1 enough for SINGLE_LAYER_UNITS units a
    block; at most one per unit), units and (layer, column) pairs split
    into balanced contiguous slices. Raises ValueError, with the shape,
    where no layout fits."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"weights must be float32 or bfloat16, got {dtype}")
    wb = 2 if dtype == torch.bfloat16 else 4
    shape = f"B={B} L={L} U={U} P={P} {dtype}"
    most = sms // L if L >= 1 else 0
    if nbl is None:
        nbl = -(-U // SINGLE_LAYER_UNITS[dtype]) if L == 1 else most
    nbl = min(nbl, most, U)
    if min(B, U, P, nbl) < 1:
        raise ValueError(f"no resident K4 plan for {shape} on {sms} SMs")
    units = resident.balanced_bounds(U, nbl)
    NU = resident.round_up(max(b - a for a, b in zip(units, units[1:])), 2)
    Kp = resident.round_up(P if L == 1 else 2 * P, 16)
    Km = resident.round_up(NU, 16)
    ldw, ldm = Kp + 8, Km + 8
    # f32 at L = 1 reads the projection slice one output a thread, threads
    # on consecutive rows (block_gemm_direct): an odd row stride puts them
    # in different banks; rows resident in fours keep the copy in 16 bytes
    direct = L == 1 and wb == 4
    if direct:
        ldm = NU + 1
    Np, Mp = resident.round_up(P, 8), resident.round_up(B, 16)
    try:
        offsets, rows, smem = resident.layout(
            {"a": Mp * ldw * wb, "gate": B * 4 * NU * 4, "m": Mp * ldm * wb,
             "c": B * NU * 4, "k": (7 * NU + B) * 4},
            [("wp", ldm * wb, Np), ("wg", ldw * wb, 4 * NU)],
            multiple={"wp": 4} if direct else None)
    except ValueError as e:
        raise ValueError(f"no resident K4 plan for {shape}: {e}") from None
    pairs = resident.balanced_bounds(L * P, L * nbl)
    tpi = resident.threads_per_sum(
        B * max(b - a for a, b in zip(pairs, pairs[1:])))
    return WavefrontPlan(B, L, U, P, nbl, tuple(units), tuple(pairs),
                         NU, 4 * NU, Kp, ldw, Np, Km, ldm, Mp, rows["wg"],
                         rows["wp"], tpi, offsets, smem)


def pack_wavefront_weights(wx, wh, proj, plan: WavefrontPlan):
    """Each block's weight slices in the layout its products read:
    wg_pk [L, nbl, NG, ldw] (row g·NU + u of block (k, j) = [W_h[k][:, c] |
    W_x[k-1][:, c] | 0], c = g·U + u0 + u, zero W_x part for layer 0, none
    at L = 1) and wp_pk [L, nbl, Np, ldm] (row p, column u =
    proj[k][u0 + u, p]); zero in every pad."""
    L, U, P, NU, nbl = plan.L, plan.U, plan.P, plan.NU, plan.nbl
    idx = resident.unit_index(plan.unit_bounds, NU, U, wh.device)

    def gate_cols(w):  # [L, P, G] -> [L, nbl, NG, P]
        w4 = torch.cat([w.reshape(L, P, 4, U), w.new_zeros((L, P, 4, 1))], 3)
        return w4[:, :, :, idx].permute(0, 3, 2, 4, 1).reshape(
            L, nbl, 4 * NU, P)

    wg_pk = wh.new_zeros((L, nbl, plan.NG, plan.ldw))
    wg_pk[..., :P] = gate_cols(wh)
    if L > 1:
        wx_all = torch.cat([wx.new_zeros((1,) + tuple(wh.shape[1:])), wx])
        wg_pk[..., P:2 * P] = gate_cols(wx_all)
    proj_pad = torch.cat([proj, proj.new_zeros((L, 1, P))], 1)  # [L, U+1, P]
    wp_pk = wh.new_zeros((L, nbl, plan.Np, plan.ldm))
    wp_pk[:, :, :P, :NU] = proj_pad[:, idx].transpose(2, 3)
    return wg_pk, wp_pk


def _launch_resident(xw1, lengths, x, wx, wh, proj, bias, wi, wf, wo,
                     residual, save_acts, plan=None):
    """One launch of K4's resident kernel on CUDA tensors: the top tap,
    or with ``save_acts`` the (taps, c_hist, h_hist, acts) streams. ``x``
    is read only by the residual and may be None without it (K1's layer,
    ``ops/lstm_seq.py``, launches it so at L = 1). ``plan``: another
    ``resident_plan`` than the default one for this shape (timing
    tools)."""
    if x is None and residual:
        raise ValueError("the residual wiring needs the raw inputs x")
    _check_inputs(xw1, lengths, x, wx, wh, proj, bias, wi, wf, wo)
    T, B, G = xw1.shape
    L, P, U = wh.shape[0], wh.shape[1], G // 4
    cdt, dev = wh.dtype, xw1.device
    with torch.cuda.device(dev):
        if plan is None:
            with spans.span("launch.plan"):
                plan = resident_plan(B, L, U, P, cdt, resident.sm_count(dev))
        with spans.span("launch.pack"):
            wg_pk, wp_pk = pack_wavefront_weights(wx, wh, proj, plan)
        bounds = resident.upload_int32(plan.unit_bounds + plan.pair_bounds,
                                       dev)
        f32 = dict(dtype=torch.float32, device=dev)
        h = torch.zeros((L, B, P), **f32)
        inbuf = torch.empty((2, L, B, P), **f32)
        partial = torch.empty((L, plan.nbl, B, P), **f32)
        if save_acts:
            saved = (torch.empty((L, T, B, P), **f32),
                     torch.empty((L, T, B, U), **f32),
                     torch.empty((L, T, B, P), **f32),
                     torch.empty((L, T, B, G), dtype=cdt, device=dev))
            y, out_ptrs = None, [None] + [t.data_ptr() for t in saved]
        else:
            y = torch.empty((T, B, P), **f32)
            out_ptrs = [y.data_ptr()] + [None] * 4
        o = plan.offsets
        params = resident.FwdParams(
            xw1.data_ptr(), None if x is None else x.data_ptr(),
            *(t.data_ptr() for t in (lengths, wg_pk, wp_pk, bias, wi, wf, wo,
                                     bounds, h, inbuf, partial)),
            *out_ptrs, T, B, L, U, P, int(bool(residual)), int(save_acts),
            plan.nbl, plan.NU, plan.NG, plan.Kp, plan.ldw, plan.Np, plan.Km,
            plan.ldm, plan.Mp, plan.n_res_g, plan.n_res_p, plan.tpi,
            o["a"], o["gate"],
            o["m"], o["c"], o["k"], o["wg"], o["wp"], plan.smem)
        resident.launch("wavefront_resident", params, cdt == torch.bfloat16,
                        dev, f"T={T} B={B} L={L} U={U} P={P} {cdt}")
    return saved if save_acts else y


def _device_check(x):
    if x.device.type != "cuda":
        raise ValueError(f"no wavefront kernel for device {x.device}")


def shape_key(proj, rows: int, residual: bool) -> str:
    """The key of a launch count by shape: the stack's L, U and P
    (``proj`` is [L, U, P]), its rows and the residual, the sizes that
    choose the kernel's plan."""
    L, U, P = proj.shape
    return f"L={L},U={U},P={P},B={rows},residual={int(residual)}"


def lstm_wavefront_fwd(xw1, lengths, x, wx, wh, proj, bias, wi, wf, wo,
                       residual=True):
    """Top tap [T, B, P] f32 of the wavefront stack, inference mode
    (arguments as ``lstm_wavefront_fwd_reference``). CPU tensors take the
    plain twin; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return lstm_wavefront_fwd_reference(xw1, lengths, x, wx, wh, proj,
                                            bias, wi, wf, wo, residual)
    _device_check(x)
    with spans.span("launch.k4_decode"):
        y = _launch_resident(xw1, lengths, x, wx, wh, proj, bias, wi, wf, wo,
                             residual, save_acts=False)
        spans.count_launch(lstm_wavefront_fwd,
                           shape_key(proj, x.shape[1], residual))
    return y


lstm_wavefront_fwd.launches = 0  # kernel launches in this process
lstm_wavefront_fwd.launches_by_shape = {}  # the same by shape_key


def lstm_wavefront_fwd_train(xw1, lengths, x, wx, wh, proj, bias, wi, wf,
                             wo, residual=True):
    """The training forward (the TPU kernel's ``save_acts=True``): per
    layer k, de-skewed [L, T, B, *] streams

    * taps [L, T, B, P] f32: tap_k(t), the input of layer k+1 (taps[L-1]
      is the stack's output);
    * c_hist [L, T, B, U] and h_hist [L, T, B, P] f32, post-mask state;
    * acts [L, T, B, 4U] in W: gate activations [si, tj, sf, so].

    Arguments as ``lstm_wavefront_fwd_reference``. CPU tensors take the
    plain twin; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return lstm_wavefront_fwd_reference(xw1, lengths, x, wx, wh, proj,
                                            bias, wi, wf, wo, residual,
                                            save_acts=True)
    _device_check(x)
    with spans.span("launch.k4_train"):
        saved = _launch_resident(xw1, lengths, x, wx, wh, proj, bias, wi, wf,
                                 wo, residual, save_acts=True)
        spans.count_launch(lstm_wavefront_fwd_train,
                           shape_key(proj, x.shape[1], residual))
    return saved


lstm_wavefront_fwd_train.launches = 0  # kernel launches in this process
lstm_wavefront_fwd_train.launches_by_shape = {}  # the same by shape_key

