#!/usr/bin/env python3
"""Smoke run of the PyTorch port (rsrgan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases build,kernels_train   # a subset

First the card's ``name, power.limit`` (nvidia-smi), then phases, one
JSON line each; any failure ends the run non-zero:

1. build — compiles every rsrgan_tpu_torch/csrc/*.cu with nvcc for sm_90a
   (one nvcc per source, all started together) and loads them (ctypes).
2. kernel / kernel_small — the wavefront kernel in decode mode (K4,
   save_acts=False, the resident kernel of csrc/resident.cu) against its
   plain twin at res_lstm_l's full width (L=4, U=760, P=257, T=512,
   ragged lengths) at B=16, 1 and 64, in f32 and bf16, with the streaming
   kernel it replaced (csrc/wavefront_fwd.cu) timed beside it; then at
   small odd shapes (SMALL) in both wirings. Every resident case is also
   launched twice and must give the same bits.
3. kernels_train — every training kernel against its plain twin, every
   output stream, in f32 and bf16, at the shapes the train steps give
   it: K4 in train mode (save_acts=True) at G's width, B=16, T=500, and
   at --g_type=lstm's stack (L=3, U=760, P=280, residual off); K1 (the
   D forward, the row-group kernel) at 16 and 32 rows, and at G's width
   (U=760, P=257: res_lstm_l with dropout) at 16 and 32 rows; K2 at G's
   width (16 rows) and D's (16 rows); K3 at D's width (the row-group walk
   and its reduction) at 32 and 64 rows, and at G's width at B=32, 64,
   128 and 256 (K2's resident walk in acc mode and the reduction, the
   walk and the reduction also timed apart; csrc/lstm_bwd.cu for f32 past
   48 rows, where it is faster, the resident walk timed beside where its
   plan fits), each on the route bwd_acc_route names, checked by its
   launch count; the redesigned kernels (K4, K2, K1, K3) also for
   bit-equal relaunches and beside the streaming kernels they replaced.
   Then all four at small odd shapes (U=13, P=9 and U=200, P=40; B=1, 3,
   33 and 64; a zero-length row), K1 also without its saved streams and
   at G's width.
4. grad — gradients of the full-width G stack (B=16, and B=32 with K3's
   resident route in every layer) and of D (16 and 32 rows) through the
   kernels' autograd Functions against the eager cell under autograd,
   f32.
5. prepare — Kaldi arks and scp files of 128 seeded train utterances
   (four length buckets of 32: two batches of each at B=16, interleaved
   by the shuffle, so the JAX CLI's update order, which the port
   follows, is not the batcher's) and 16 cv utterances (150-600 frames,
   257 -> 40), every other matrix compressed, and Kaldi CMVN stats,
   written through the port; then ``python -m
   rsrgan_tpu_torch.cli.prepare`` cmvn, make-store (train, cv), split and
   verify-store as processes, each exiting 0; every stored matrix
   bit-equal to the port's read of its ark with the CMVN applied;
   make-store's frames/s.
6. train — from the prepare phase's stores and train_cmvn.npz: one
   epoch of ``rsrgan_tpu_torch.cli.train.main(
   ["--trainer=gan_rnn", "--g_type=res_lstm_l", "--batch_size=16",
   ...])`` with ``--device_feed=off`` (the host feed), then one with the
   default flags on the bf16 kernel path, which on a card feed from the
   resident tables (the main path: every kernel's launch count is reset
   before it and read after it); the two checkpoints and metrics rows
   must be bit-equal, and both feeds' train frames/s and ms per
   iteration are printed on a line of their own; one epoch with
   ``--same_batch=false`` (the graph-fed loop) and one with
   ``--d_conditioned=true``, each with finite losses and on the kernel
   routes (launch counts); one with ``--keep_prob=0.8`` (G per layer: K1
   at G width 4 x 3 times an iteration past the main path's launches,
   K2 backward, no K4 train launch; its ms per iteration beside the
   main path's); one with ``--g_type=lstm`` (K4 train at P=280, two
   launches an iteration) and ``--decode`` from its checkpoint; two with
   ``--checkpoint_every_secs=1`` and the default ``--tensorboard`` (the
   event files' records and steps against metrics_*.jsonl, the periodic
   snapshot read back by load_newest_state); decode from the main path's
   checkpoint; one
   f32 train step on one batch through the kernels against
   --lstm_impl=scan; and one bf16 train step at T=600 under
   torch.profiler (device time by kernel, device busy share; the D
   step's backward must show on K3's row-group kernels and not on
   csrc/lstm_bwd.cu), then one at B=32, the CLI's default (the 32
   longest utterances): its 8 G-layer backwards on K3's resident route
   (counts set to 0 just before the step), none on csrc/lstm_bwd.cu;
   then the peak device memory of one bf16 step at B=64, T=600, which
   must stay below the device feed's reserve (FEED_RESERVE_BYTES).
7. feed — a seeded store of ~1.7 M frames (~2 GB of f32 tables): the
   upload of its f32 and bf16 tables (GB/s over the f32 bytes that cross
   the link, twice each, and the reference corpus's ~36 M frames
   extrapolated from it); the gather of one batch at B=16 and 32,
   T_pad=600, against SequenceBatcher._make_batch plus pageable copies
   of the same indices (bit-equal); the rotating feed over 1,200 of its
   utterances under a small RSRGAN_FEED_HBM_BUDGET (>= 3 shards,
   prefetch on, block 1, two passes, each residency's gathers queued
   behind a device sleep), every gathered batch bit-equal to the host
   batch of its shard's StoreView batcher.
8. decode — a seeded full-width res_lstm_l checkpoint, a 32-utterance
   test store, ``cli.train.main(["--decode", ...])`` at
   --decode_batch_size=16 on the default bf16 kernel path (the decode
   path: its launch count is reset before and read after), and f32 runs
   of the kernel and of --lstm_impl=scan held against each other.

Then a {"kernels": [...]} line, the card's ``name, power.limit``, and last
{"ok": true, "device": {...}}. Without a CUDA device, or without the rest
of the repository beside it, it fails and prints no result.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
RESIDENT = "rsrgan_tpu_torch/csrc/resident.cu"
REPLACES = "rsrgan_tpu/ops/pallas_wavefront.py:48"
# the two bf16 instantiations of the resident walk, as the profiler names
# them: K2, and K3's walk in acc mode
K2_BF16_KERNEL = "lstm_bwd_resident_kernel<__nv_bfloat16, false>"
K3_WALK_BF16_KERNEL = "lstm_bwd_resident_kernel<__nv_bfloat16, true>"

# res_lstm_l at full width; B is bench.py's batch, T a 128-padded length
L, U, P, OUT = 4, 760, 257, 40
# --g_type=lstm: Dense 257 -> 280, 3 x LSTM(760, proj 280), Dense 280 -> 40
LSTM_P = 280
B, T = 16, 512
LENGTHS = [512, 497, 301, 150, 384, 511, 256, 199,
           420, 128, 333, 480, 275, 64, 448, 1]

# Tolerances, kernel vs twin on the same card. Both accumulate in f32 and
# differ only in summation order (8-way split of the 257- and 760-long
# dots, then a tree of partials), so in f32 the gap is rounding noise,
# carried through T+L-1 = 515 dependent steps: 1e-4 on outputs of order
# 1-10 is ~1000x below one bf16 ulp. In bf16 both round the same
# operands, but a last-bit f32 difference can flip a bf16 rounding of h
# or m (one bf16 ulp = 2^-8 relative), which then propagates: 2e-2.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# f32 decode, kernel vs eager scan cell: the same f32 math with other
# summation orders, through the dense layer and CMVN denormalisation.
DECODE_TOL_F32 = 1e-3

# The train step's shapes: bench.py's batch B=16 at T=500; D is
# 2 x LSTM(256, proj 40) on 40-dim frames, at B rows (G steps) and 2B
# rows (the D step stacks real and fake).
TT = 500
TRAIN_LENGTHS = [500, 497, 301, 150, 384, 411, 256, 199,
                 420, 128, 333, 480, 275, 64, 448, 1]
DU, DP = 256, 40
# Training kernels vs their twins, every stream, gated at
# TOL[dtype] * max(1, max |twin|): the backward streams and the weight
# gradients (sums over T*B = 8,000 rows) reach magnitudes of 10-100, and
# their f32 summation-order noise grows with them.
# f32 gradients, kernels' autograd Functions vs the eager cell under
# autograd (grad phase) and kernel vs scan train step (train phase):
# max |diff| / max |ref| per tensor. The same f32 math in other orders
# through 500 dependent steps and 8,000-row sums gives ~1e-5; a pairing
# or masking fault gives O(1).
GRAD_TOL = 1e-3
K3_GRADS = ("dxw", "dwh", "dproj", "dbias", "dwi", "dwf", "dwo")
# The batches at which K3 runs at G's width: the CLI's default 32, 64, 128
# and bench.py's 256 (the recipe's 8 takes K2)
K3_G_BATCHES = (32, 64, 128, 256)
# Published peaks of one H100 SXM (dense), for the bounds.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def glorot(rng, shape):
    limit = np.sqrt(6.0 / (shape[0] + shape[1]))
    return rng.uniform(-limit, limit, size=shape).astype(np.float32)


def generator_tree(seed: int) -> dict:
    """Seeded res_lstm_l G parameters in the JAX tree layout."""
    rng = np.random.default_rng(seed)
    tree = {}
    for k in range(L):
        tree[f"lstm_cell_{k + 1}"] = {
            "kernel": glorot(rng, (2 * P, 4 * U)),
            "bias": rng.normal(0, 0.1, 4 * U).astype(np.float32),
            "proj_kernel": glorot(rng, (U, P)),
            "w_i_diag": glorot(rng, (1, U)),
            "w_f_diag": glorot(rng, (1, U)),
            "w_o_diag": glorot(rng, (1, U)),
        }
    tree["forward_out"] = {"kernel": glorot(rng, (P, OUT)),
                           "bias": rng.normal(0, 0.1, OUT).astype(np.float32)}
    return tree


def cuda_time_ms(fn, reps: int) -> float:
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build() -> dict:
    from rsrgan_tpu_torch.ops import _build
    t0 = time.monotonic()
    libs = _build.load_all()
    info = {name: _build.BUILD_LOG.get(name, {}) for name in libs}
    out = {"phase": "build", "ok": True,
           "seconds": round(time.monotonic() - t0, 3),
           "nvcc_seconds": {n: i.get("seconds") for n, i in info.items()},
           "libraries": {n: lib._name for n, lib in libs.items()},
           "nvcc": _build.find_nvcc(), "flags": _build.NVCC_FLAGS,
           "ptxas": {n: [ln.strip() for ln in i.get("ptxas", "").splitlines()
                         if "registers" in ln or "spill" in ln]
                     for n, i in info.items()}}
    emit(out)
    return out


def kernel_inputs(seed, L_, U_, P_, B_, T_, lengths, cdt, device):
    """Kernel arguments as lstm_stack_wavefront prepares them."""
    import torch
    from rsrgan_tpu_torch.ops.wavefront_stack import _prep
    rng = np.random.default_rng(seed)
    params = [{"kernel": glorot(rng, (2 * P_, 4 * U_)),
               "bias": rng.normal(0, 0.1, 4 * U_).astype(np.float32),
               "proj_kernel": glorot(rng, (U_, P_)),
               "w_i_diag": glorot(rng, (1, U_)),
               "w_f_diag": glorot(rng, (1, U_)),
               "w_o_diag": glorot(rng, (1, U_))} for _ in range(L_)]
    params = [{k: torch.from_numpy(v).to(device) for k, v in p.items()}
              for p in params]
    x = torch.from_numpy(rng.normal(size=(T_, B_, P_)).astype(np.float32))
    x = x.to(device)
    wx, wh, bias, proj, wi, wf, wo = _prep(params, P_, 1.0)
    wx, wh, proj = (a.to(cdt).contiguous() for a in (wx, wh, proj))
    xw1 = torch.matmul(x, wx[0].float()).to(cdt)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return (xw1, lens, x, wx[1:].contiguous(), wh, proj, bias.contiguous(),
            wi.contiguous(), wf.contiguous(), wo.contiguous())


def same_bits(fn) -> bool:
    """Two launches on the same inputs give bit-equal outputs."""
    import torch
    a, b = fn(), fn()
    a, b = (a,) if torch.is_tensor(a) else a, (b,) if torch.is_tensor(b) else b
    return all(torch.equal(x, y) for x, y in zip(a, b))


def resident_grid(plan) -> dict:
    return {"grid": plan.blocks, "design": "resident",
            "smem_bytes": plan.smem,
            "weights_resident": plan.weights_resident()}


def rowgroup_grid(plan) -> dict:
    return {"grid": plan.groups, "design": "rowgroup",
            "group_rows": plan.group_rows, "smem_bytes": plan.smem,
            "weights_resident": plan.weights_resident()}


def phase_kernel(dtype_name: str) -> dict:
    """K4 decode at B=16 (the main path's batch), then B=1 and B=64
    (--decode_batch_size 1 and 64), each against its twin; the streaming
    kernel (csrc/wavefront_fwd.cu) timed on the same inputs at B=16."""
    import torch
    from rsrgan_tpu_torch.ops import wavefront as wf
    cdt = getattr(torch, dtype_name)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"phase": "kernel", "dtype": dtype_name, "L": L, "U": U, "P": P,
           "T": T, "tol": TOL[dtype_name], "by_batch": {}}
    ok = True
    for rows in (B, 1, 64):
        lens = (LENGTHS * 4)[:rows]
        args = kernel_inputs(1, L, U, P, rows, T, lens, cdt, "cuda")
        run = lambda: wf.lstm_wavefront_fwd(*args, residual=True)  # noqa
        got = run()
        torch.cuda.synchronize()
        want = wf.lstm_wavefront_fwd_reference(*args, residual=True)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        finite = bool(torch.isfinite(got).all())
        r = {"max_abs_err": err, "max_abs_ref": float(want.abs().max()),
             "ms": cuda_time_ms(run, 10), "finite": finite,
             "deterministic": same_bits(run),
             **resident_grid(wf.resident_plan(rows, L, U, P, cdt, sms))}
        if rows == B:
            r["plain_ms"] = cuda_time_ms(
                lambda: wf.lstm_wavefront_fwd_reference(*args,
                                                        residual=True), 1)
            r["streaming_ms"] = cuda_time_ms(
                lambda: wf._launch(*args, residual=True, save_acts=False), 5)
            out.update(B=B, **r)
        out["by_batch"][rows] = r
        ok = ok and finite and err <= TOL[dtype_name] and r["deterministic"]
    out["ok"] = ok
    emit(out)
    return out


# Odd shapes of the resident kernels: U and P not multiples of the mma
# tiles, units that do not divide the grid evenly (200 over 33 blocks per
# layer), B = 1, 3, 33 and 64, L = 1 and 3 without the residual.
SMALL = [(4, True, 13, 9, 3), (3, False, 13, 9, 3), (1, False, 13, 9, 1),
         (4, True, 200, 40, 33), (3, False, 200, 40, 64),
         (1, True, 200, 40, 3)]


def phase_kernel_small() -> dict:
    """K4 decode mode at the SMALL shapes, every length row ragged and one
    of length 0, f32, each also checked for bit-equal relaunches."""
    import torch
    from rsrgan_tpu_torch.ops.wavefront import (lstm_wavefront_fwd,
                                                lstm_wavefront_fwd_reference)
    errs, ok = {}, True
    for L_, residual, U_, P_, B_ in SMALL:
        args = kernel_inputs(2, L_, U_, P_, B_, 17, ([17, 11, 0] * 22)[:B_],
                             torch.float32, "cuda")
        run = lambda: lstm_wavefront_fwd(*args, residual=residual)  # noqa
        got = run()
        want = lstm_wavefront_fwd_reference(*args, residual=residual)
        torch.cuda.synchronize()
        tag = f"L{L_}_residual_{residual}_U{U_}_B{B_}"
        errs[tag] = float((got - want).abs().max())
        ok = ok and errs[tag] <= 1e-5 and same_bits(run)
    out = {"phase": "kernel_small", "max_abs_err": errs, "tol": 1e-5,
           "ok": ok}
    emit(out)
    return out


def bound(flops: float, nbytes: float, dtype_name: str) -> dict:
    """The least time the card could take: the larger of operations over
    the peak rate of their type and bytes over the memory rate."""
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def true_steps(lengths, T_) -> int:
    return int(sum(min(int(n), T_) for n in lengths))


# The bounds' byte counts read each input stream once at the true row-steps
# only (a masked step needs no input: its outputs are zeros or the carried
# state) and write each output once in full, masked rows included.


def wavefront_bound(L_, U_, P_, B_, T_, lengths, dtype_name, train,
                    residual=True):
    """K4: per true row-step and layer, h·W_h (and in·W_x above layer 1)
    and m·proj. Bytes: weights, xw1 at the true row-steps, lengths, with
    the residual wiring (res_lstm_l) x at every row (the tap of a masked
    row is x itself); out: the top tap (decode) or the saved streams
    (train)."""
    G_, wb = 4 * U_, 2 if dtype_name == "bfloat16" else 4
    n = true_steps(lengths, T_)
    flops = n * (L_ * 2 * P_ * G_ + (L_ - 1) * 2 * P_ * G_ + L_ * 2 * U_ * P_)
    nbytes = (((2 * L_ - 1) * P_ * G_ + L_ * U_ * P_) * wb
              + L_ * (G_ + 3 * U_) * 4 + n * G_ * wb + B_ * 4
              + (T_ * B_ * P_ * 4 if residual else 0))
    if train:
        nbytes += L_ * T_ * B_ * ((2 * P_ + U_) * 4 + G_ * wb)
    else:
        nbytes += T_ * B_ * P_ * 4
    return bound(flops, nbytes, dtype_name)


def k1_bound(U_, P_, B_, T_, lengths, dtype_name):
    """K1: weights, xw at the true row-steps, lengths; out, c_hist,
    h_hist and acts written in full."""
    G_, wb = 4 * U_, 2 if dtype_name == "bfloat16" else 4
    n = true_steps(lengths, T_)
    flops = n * (2 * P_ * G_ + 2 * U_ * P_)
    nbytes = ((P_ * G_ + U_ * P_) * wb + (G_ + 3 * U_) * 4 + B_ * 4
              + n * G_ * wb + T_ * B_ * (G_ * wb + (2 * P_ + U_) * 4))
    return bound(flops, nbytes, dtype_name)


def bwd_bound(U_, P_, B_, T_, lengths, dtype_name, acc):
    """K2: per true row-step dh_total·projᵀ and dgates·W_hᵀ; K3 adds the
    weight-gradient products h(t-1)ᵀ·dgates and mᵀ·dh. Bytes: weights,
    peepholes, lengths, and acts, dout, c_hist (K3: h_hist) at the true
    row-steps; dxw (K2: m, dh; K3: the weight gradients) written."""
    G_, wb = 4 * U_, 2 if dtype_name == "bfloat16" else 4
    n = true_steps(lengths, T_)
    flops = n * (2 * P_ * U_ + 2 * G_ * P_)
    nbytes = ((P_ * G_ + U_ * P_) * wb + 3 * U_ * 4 + B_ * 4
              + n * (G_ * wb + P_ * 4 + U_ * 4)   # acts, dout, c_hist
              + T_ * B_ * G_ * wb)                # dxw
    if acc:
        flops += n * (2 * P_ * G_ + 2 * U_ * P_)
        nbytes += n * P_ * 4 + (P_ * G_ + U_ * P_ + G_ + 3 * U_) * 4
    else:
        nbytes += T_ * B_ * (U_ + P_) * wb        # m, dh
    return bound(flops, nbytes, dtype_name)


def layer_params(rng, D_, U_, P_, cdt, device):
    """One seeded LSTM layer as the single-layer kernels take it: w_x
    [D, G] f32, w_h [P, G] and proj [U, P] in W, bias [G] with
    forget_bias folded, peepholes [U]."""
    import torch
    from rsrgan_tpu_torch.ops.lstm_seq import fold_forget_bias
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    kernel = glorot(rng, (D_ + P_, 4 * U_))
    return {"w_x": t(kernel[:D_]),
            "w_h": t(kernel[D_:]).to(cdt).contiguous(),
            "proj": t(glorot(rng, (U_, P_))).to(cdt).contiguous(),
            "bias": fold_forget_bias(
                t(rng.normal(0, 0.1, 4 * U_).astype(np.float32)), 1.0),
            "wi": t(glorot(rng, (1, U_))[0]), "wf": t(glorot(rng, (1, U_))[0]),
            "wo": t(glorot(rng, (1, U_))[0])}


def compare_streams(names, got, want, dtype_name, tol=None):
    """max |got - want| per stream, each gated at tol * max(1, max|want|)."""
    tol = TOL[dtype_name] if tol is None else tol
    errs, refs, ok = {}, {}, True
    for name, g, w in zip(names, got, want):
        errs[name] = float((g.float() - w.float()).abs().max())
        refs[name] = float(w.float().abs().max())
        finite = bool(torch_isfinite(g))
        ok = ok and finite and errs[name] <= tol * max(1.0, refs[name])
    return errs, refs, ok


def torch_isfinite(t) -> bool:
    import torch
    return bool(torch.isfinite(t.float()).all())


def timed(name, dtype_name, fn, twin, names, reps=5, tol=None,
          streaming=None, steps=None, check=None, **extra):
    """Run kernel and twin on the same inputs, compare every stream, time
    both (kernel over ``reps`` launches, twin over its one run); a
    redesigned kernel
    (``streaming``: the kernel it replaced, which streams its weights
    from L2, on the same inputs) is also checked for bit-equal relaunches
    and timed beside it; with ``steps`` (the recurrence's length) also µs
    per step; with ``check`` (read after every launch) also that the calls
    took the kernel they should; emit the phase."""
    import torch
    got = fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want = twin()   # run once: compared and timed
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    errs, refs, ok = compare_streams(names, got, want, dtype_name, tol)
    ms = cuda_time_ms(fn, reps)
    if streaming is not None:
        extra["deterministic"] = same_bits(fn)
        extra["streaming_ms"] = cuda_time_ms(streaming, reps)
        ok = ok and extra["deterministic"]
    if steps:
        extra["us_per_step"] = ms * 1e3 / steps
    if check is not None:
        extra["route_ok"] = check()
        ok = ok and extra["route_ok"]
    out = {"phase": "kernels_train", "kernel": name, "dtype": dtype_name,
           **extra, "max_abs_err": errs, "max_abs_ref": refs,
           "tol": TOL[dtype_name] if tol is None else tol,
           "ms": ms, "plain_ms": plain_ms, "ok": ok}
    emit(out)
    return out


def streaming_bwd(acts, lengths, dout, c_hist, w_h, proj, wi, wf, wo):
    """The streaming K2 kernel (csrc/lstm_bwd.cu, acc=0), for timing
    beside the resident one."""
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    return ls._launch_bwd(acts, lengths, dout, c_hist, None, w_h, proj, wi,
                          wf, wo, acc=False)


def streaming_fwd(xw, lengths, w_h, proj, bias, wi, wf, wo):
    """The streaming K1 kernel (csrc/wavefront_fwd.cu at L = 1, residual
    off), for timing beside the row-group one: (out, c_hist, h_hist,
    acts)."""
    import torch
    from rsrgan_tpu_torch.ops import wavefront
    T_, B_, _ = xw.shape
    P_ = proj.shape[1]
    args = (xw, lengths, xw.new_empty((T_, B_, P_), dtype=torch.float32),
            w_h.new_empty((0, P_, w_h.shape[1])), w_h[None], proj[None],
            bias[None], wi[None], wf[None], wo[None])
    taps, c_hist, h_hist, acts = wavefront._launch(
        *(a.contiguous() for a in args), residual=False, save_acts=True)
    return taps[0], c_hist[0], h_hist[0], acts[0]


def phase_kernels_train(dtype_name: str) -> list:
    """K4 train mode (res_lstm_l's stack, and lstm's: L=3, P=280, residual
    off), K1 (D, and G's width as dropout runs it), K2 (G and D) and K3
    (D, and G at B=32, 64, 128 and 256) at the train steps' shapes."""
    import torch
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    from rsrgan_tpu_torch.ops import wavefront as wf
    from rsrgan_tpu_torch.ops.wavefront import (lstm_wavefront_fwd_reference,
                                                lstm_wavefront_fwd_train)
    cdt = getattr(torch, dtype_name)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = []
    streams4 = ("taps", "c_hist", "h_hist", "acts")
    args = kernel_inputs(5, L, U, P, B, TT, TRAIN_LENGTHS, cdt, "cuda")
    r = timed("wavefront_fwd_train", dtype_name,
              lambda: lstm_wavefront_fwd_train(*args, residual=True),
              lambda: lstm_wavefront_fwd_reference(*args, residual=True,
                                                   save_acts=True),
              streams4,
              streaming=lambda: wf._launch(*args, residual=True,
                                           save_acts=True),
              L=L, U=U, P=P, B=B, T=TT,
              **resident_grid(wf.resident_plan(B, L, U, P, cdt, sms)),
              **wavefront_bound(L, U, P, B, TT, TRAIN_LENGTHS, dtype_name,
                                train=True))
    results.append(r)

    # K4 in train mode at LstmGenerator's stack (--g_type=lstm): L=3,
    # U=760, P=280, residual off
    lstm_args = kernel_inputs(15, 3, U, LSTM_P, B, TT, TRAIN_LENGTHS, cdt,
                              "cuda")
    results.append(timed(
        "wavefront_fwd_train", dtype_name,
        lambda: lstm_wavefront_fwd_train(*lstm_args, residual=False),
        lambda: lstm_wavefront_fwd_reference(*lstm_args, residual=False,
                                             save_acts=True),
        streams4,
        streaming=lambda: wf._launch(*lstm_args, residual=False,
                                     save_acts=True),
        net="G_lstm", L=3, U=U, P=LSTM_P, B=B, T=TT,
        **resident_grid(wf.resident_plan(B, 3, U, LSTM_P, cdt, sms)),
        **wavefront_bound(3, U, LSTM_P, B, TT, TRAIN_LENGTHS, dtype_name,
                          train=True, residual=False)))

    # K2 at G's width on layer 1 of the training forward's streams
    taps, c_s, h_s, acts = lstm_wavefront_fwd_train(*args, residual=True)
    rng = np.random.default_rng(6)
    lens = args[1]
    dout = torch.from_numpy(
        rng.normal(size=(TT, B, P)).astype(np.float32)).cuda()
    _, _, _, wh, proj, _, wi, wf, wo = args[1:]
    g_args = (acts[0], lens, dout, c_s[0], wh[0], proj[0], wi[0], wf[0],
              wo[0])
    results.append(timed(
        "lstm_bwd", dtype_name, lambda: ls.lstm_bwd(*g_args),
        lambda: ls.lstm_bwd_reference(*g_args), ("dxw", "m", "dh"),
        streaming=lambda: streaming_bwd(*g_args), net="G", U=U, P=P, B=B, T=TT,
        **resident_grid(ls.resident_plan(B, U, P, cdt, sms)),
        **bwd_bound(U, P, B, TT, TRAIN_LENGTHS, dtype_name, acc=False)))

    # K1 at G's width, as dropout runs G per layer (--keep_prob < 1): B=16
    # (bench.py) and 32 (the CLI's default), one row a block
    for rows in (B, 2 * B):
        rng = np.random.default_rng(20 + rows)
        g_lens = (TRAIN_LENGTHS * 2)[:rows]
        prm = layer_params(rng, P, U, P, cdt, "cuda")
        x = torch.from_numpy(
            rng.normal(size=(TT, rows, P)).astype(np.float32)).cuda()
        xw = (x.to(cdt).float() @ prm["w_x"].to(cdt).float()).to(cdt)
        k1_args = (xw, torch.tensor(g_lens, dtype=torch.int32, device="cuda"),
                   prm["w_h"], prm["proj"], prm["bias"], prm["wi"],
                   prm["wf"], prm["wo"])
        results.append(timed(
            "lstm_fwd", dtype_name, lambda: ls.lstm_fwd(*k1_args),
            lambda: ls.lstm_fwd_reference(*k1_args), streams4,
            streaming=lambda: streaming_fwd(*k1_args), steps=TT,
            net="G", U=U, P=P, B=rows, T=TT,
            **rowgroup_grid(ls.rowgroup_plan(rows, U, P, cdt, sms)),
            **k1_bound(U, P, rows, TT, g_lens, dtype_name)))

    # K3 at G's width, at the batches where every G layer's backward takes
    # it: B=32 (the CLI's default --batch_size), 64 and 256 (bench.py)
    for rows in K3_G_BATCHES:
        results.append(k3_g_width(rows, dtype_name, sms))

    # D: K1 at 16 and 32 rows, K2 at 16, K3 at 32 and 64 (the D step at
    # --batch_size 16 and 32)
    for rows in (B, 2 * B, 4 * B):
        rng = np.random.default_rng(7 + rows)
        d_lens = (TRAIN_LENGTHS * 4)[:rows]
        prm = layer_params(rng, DP, DU, DP, cdt, "cuda")
        x = torch.from_numpy(
            rng.normal(size=(TT, rows, DP)).astype(np.float32)).cuda()
        xw = (x.to(cdt).float() @ prm["w_x"].to(cdt).float()).to(cdt)
        lens_t = torch.tensor(d_lens, dtype=torch.int32, device="cuda")
        k1_args = (xw, lens_t, prm["w_h"], prm["proj"], prm["bias"],
                   prm["wi"], prm["wf"], prm["wo"])
        if rows <= 2 * B:
            results.append(timed(
                "lstm_fwd", dtype_name, lambda: ls.lstm_fwd(*k1_args),
                lambda: ls.lstm_fwd_reference(*k1_args), streams4,
                streaming=lambda: streaming_fwd(*k1_args), steps=TT,
                net="D", U=DU, P=DP, B=rows, T=TT,
                **rowgroup_grid(ls.rowgroup_plan(rows, DU, DP, cdt, sms)),
                **k1_bound(DU, DP, rows, TT, d_lens, dtype_name)))
        out, c_h, h_h, d_acts = ls.lstm_fwd(*k1_args)
        d_dout = torch.from_numpy(
            rng.normal(size=(TT, rows, DP)).astype(np.float32)).cuda()
        common = (d_acts, lens_t, d_dout, c_h)
        weights = (prm["w_h"], prm["proj"], prm["wi"], prm["wf"], prm["wo"])
        if rows < ls.ACC_BWD_MIN_BATCH:
            results.append(timed(
                "lstm_bwd", dtype_name, lambda: ls.lstm_bwd(*common, *weights),
                lambda: ls.lstm_bwd_reference(*common, *weights),
                ("dxw", "m", "dh"),
                streaming=lambda: streaming_bwd(*common, *weights),
                net="D", U=DU, P=DP, B=rows, T=TT,
                **resident_grid(ls.resident_plan(rows, DU, DP, cdt, sms)),
                **bwd_bound(DU, DP, rows, TT, d_lens, dtype_name, acc=False)))
        else:
            before = ls.lstm_bwd_acc.launches
            results.append(timed(
                "lstm_bwd_acc", dtype_name,
                lambda: ls.lstm_bwd_acc(*common, h_h, *weights),
                lambda: ls.lstm_bwd_acc_reference(*common, h_h, *weights),
                K3_GRADS,
                streaming=lambda: ls._launch_bwd(*common, h_h, *weights,
                                                 acc=True),
                # the route: every call (1 + 5 timed + 2 relaunches) took
                # the row-group walk
                check=lambda: ls.lstm_bwd_acc.launches == before + 8,
                steps=TT, net="D", U=DU, P=DP, B=rows, T=TT,
                **rowgroup_grid(ls.rowgroup_bwd_plan(rows, DU, DP, cdt, sms)),
                **bwd_bound(DU, DP, rows, TT, d_lens, dtype_name, acc=True)))
    return results


def wgrad_bound(U_, P_, B_, T_, lengths, dtype_name):
    """K3's reduction: dW_h = Σ h(t-1)ᵀ·dxw(t) and dproj = Σ mᵀ·dh over
    the true row-steps; reads h_hist (f32) and the walk's dxw, m and dh
    there, writes dW_h and dproj."""
    G_, wb = 4 * U_, 2 if dtype_name == "bfloat16" else 4
    n = true_steps(lengths, T_)
    return bound(n * (2 * P_ * G_ + 2 * U_ * P_),
                 n * (P_ * 4 + (G_ + U_ + P_) * wb) + (P_ * G_ + U_ * P_) * 4,
                 dtype_name)


def k3_g_width(rows: int, dtype_name: str, sms: int) -> dict:
    """K3 at G's width, B=rows, T=500, on one layer's forward streams
    (from the twin): all seven outputs against the twin, bit-equal
    relaunches, the route ``bwd_acc_route`` names checked by its count,
    csrc/lstm_bwd.cu timed beside it; on the resident route also the
    walk and the reduction timed apart; on the streaming route the
    resident one where its plan fits (f32 past RESIDENT_F32_MAX_ROWS)."""
    import torch
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    cdt = getattr(torch, dtype_name)
    rng = np.random.default_rng(10 + rows)
    lens = (TRAIN_LENGTHS * (rows // B))[:rows]
    prm = layer_params(rng, P, U, P, cdt, "cuda")
    x = torch.from_numpy(
        rng.normal(size=(TT, rows, P)).astype(np.float32)).cuda()
    xw = (x.to(cdt).float() @ prm["w_x"].to(cdt).float()).to(cdt)
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    weights = (prm["w_h"], prm["proj"], prm["wi"], prm["wf"], prm["wo"])
    _, c_h, h_h, acts = ls.lstm_fwd_reference(
        xw, lens_t, prm["w_h"], prm["proj"], prm["bias"], prm["wi"],
        prm["wf"], prm["wo"])
    dout = torch.from_numpy(
        rng.normal(size=(TT, rows, P)).astype(np.float32)).cuda()
    args = (acts, lens_t, dout, c_h, h_h, *weights)
    route = ls.bwd_acc_route(rows, U, P, cdt, sms)
    count = {"resident": "resident_launches",
             "streaming": "streaming_launches"}[route]
    extra = {"route": route, "net": "G", "U": U, "P": P, "B": rows, "T": TT}
    if route == "resident":
        walk = lambda: ls._launch_bwd_resident(  # noqa: E731
            acts, lens_t, dout, c_h, *weights, acc=True)
        dxw, m, dh = walk()[:3]
        extra.update(
            walk_ms=cuda_time_ms(walk, 2),
            reduction_ms=cuda_time_ms(
                lambda: ls._launch_wgrad(h_h, dxw, m, dh), 5),
            walk_bound_ms=bwd_bound(U, P, rows, TT, lens, dtype_name,
                                    acc=False)["bound_ms"],
            reduction_bound_ms=wgrad_bound(U, P, rows, TT, lens,
                                           dtype_name)["bound_ms"],
            reduction_splits=ls.wgrad_plan(TT, rows, U, P, sms).splits,
            **resident_grid(ls.resident_plan(rows, U, P, cdt, sms,
                                             acc=True)))
    else:
        extra.update(design="streaming", grid=ls.lstm_bwd_grid(
            rows, U, P, True, cdt == torch.bfloat16))
        try:  # f32 past RESIDENT_F32_MAX_ROWS: the slower route, timed
            ls.resident_plan(rows, U, P, cdt, sms, acc=True)
            extra["resident_ms"] = cuda_time_ms(
                lambda: ls._launch_bwd_resident_acc(*args), 2)
        except ValueError:
            pass
    before = getattr(ls.lstm_bwd_acc, count)
    return timed(
        "lstm_bwd_acc", dtype_name, lambda: ls.lstm_bwd_acc(*args),
        lambda: ls.lstm_bwd_acc_reference(*args), K3_GRADS, reps=2,
        streaming=lambda: ls._launch_bwd(*args, acc=True), steps=TT,
        # the route: every call (1 + 2 timed + 2 relaunches) took it
        check=lambda: getattr(ls.lstm_bwd_acc, count) == before + 5,
        **extra, **bwd_bound(U, P, rows, TT, lens, dtype_name, acc=True))


def phase_kernels_train_small() -> dict:
    """The training kernels at odd sizes (K4 train mode at the SMALL
    shapes; K1, K2 and K3 at U=13, P=9 with 1, 3, 33 and 64 rows and at
    U=200, P=40: units that do not divide the grid; K1 also without its
    saved streams, and at G's width, U=760, P=257, where its weights only
    partly fit in shared memory), f32, a zero-length row, absolute 1e-5
    scaled as above; the redesigned kernels (K4, K2, K1, K3) also checked
    for bit-equal relaunches. K3 takes any row count (here always its
    row-group walk)."""
    import torch
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    from rsrgan_tpu_torch.ops.wavefront import (lstm_wavefront_fwd_reference,
                                                lstm_wavefront_fwd_train)
    f32, tol, T_, lens = torch.float32, 1e-5, 17, [17, 11, 0]
    errs, ok = {}, True

    def check(tag, names, got, want):
        nonlocal ok
        e, _, good = compare_streams(names, got, want, "float32", tol)
        errs[tag] = max(e.values())
        ok = ok and good

    def deterministic(tag, fn):
        nonlocal ok
        errs[tag + "_same_bits"] = same_bits(fn)
        ok = ok and errs[tag + "_same_bits"]

    for L_, residual, U_, P_, B_ in SMALL:
        args = kernel_inputs(8, L_, U_, P_, B_, T_, (lens * 22)[:B_], f32,
                             "cuda")
        tag = f"wavefront_train_L{L_}_residual_{residual}_U{U_}_B{B_}"
        run = lambda: lstm_wavefront_fwd_train(*args,  # noqa: E731
                                               residual=residual)
        check(tag, ("taps", "c_hist", "h_hist", "acts"), run(),
              lstm_wavefront_fwd_reference(*args, residual=residual,
                                           save_acts=True))
        deterministic(tag, run)
    rng = np.random.default_rng(9)
    for rows, U_, P_ in ((1, 13, 9), (3, 13, 9), (33, 13, 9), (64, 13, 9),
                         (16, 200, 40)):
        row_lens = (lens * 22)[:rows]
        prm = layer_params(rng, P_, U_, P_, f32, "cuda")
        x = torch.from_numpy(
            rng.normal(size=(T_, rows, P_)).astype(np.float32)).cuda()
        lens_t = torch.tensor(row_lens, dtype=torch.int32, device="cuda")
        k1_args = (x @ prm["w_x"], lens_t, prm["w_h"], prm["proj"],
                   prm["bias"], prm["wi"], prm["wf"], prm["wo"])
        got = ls.lstm_fwd(*k1_args)
        tag = f"U{U_}_B{rows}"
        check(f"lstm_fwd_{tag}", ("out", "c_hist", "h_hist", "acts"), got,
              ls.lstm_fwd_reference(*k1_args))
        deterministic(f"lstm_fwd_{tag}", lambda: ls.lstm_fwd(*k1_args))
        check(f"lstm_fwd_no_acts_{tag}", ("out",),
              ls.lstm_fwd(*k1_args, save_acts=False)[:1],
              ls.lstm_fwd_reference(*k1_args, save_acts=False)[:1])
        dout = torch.from_numpy(
            rng.normal(size=(T_, rows, P_)).astype(np.float32)).cuda()
        common = (got[3], lens_t, dout, got[1])
        weights = k1_args[2:4] + k1_args[5:]
        check(f"lstm_bwd_{tag}", ("dxw", "m", "dh"),
              ls.lstm_bwd(*common, *weights),
              ls.lstm_bwd_reference(*common, *weights))
        deterministic(f"lstm_bwd_{tag}",
                      lambda: ls.lstm_bwd(*common, *weights))
        check(f"lstm_bwd_acc_{tag}", K3_GRADS,
              ls.lstm_bwd_acc(*common, got[2], *weights),
              ls.lstm_bwd_acc_reference(*common, got[2], *weights))
        deterministic(f"lstm_bwd_acc_{tag}",
                      lambda: ls.lstm_bwd_acc(*common, got[2], *weights))
    # K1 at G's width: the weight rows past shared memory come from L2
    prm = layer_params(rng, P, U, P, f32, "cuda")
    x = torch.from_numpy(rng.normal(size=(T_, B, P)).astype(np.float32))
    k1_args = (x.cuda() @ prm["w_x"],
               torch.tensor((lens * 6)[:B], dtype=torch.int32,
                            device="cuda"),
               prm["w_h"], prm["proj"], prm["bias"], prm["wi"], prm["wf"],
               prm["wo"])
    for save in (True, False):
        names = ("out", "c_hist", "h_hist", "acts") if save else ("out",)
        check(f"lstm_fwd_G_width_save_{save}", names,
              ls.lstm_fwd(*k1_args, save_acts=save),
              ls.lstm_fwd_reference(*k1_args, save_acts=save))
    deterministic("lstm_fwd_G_width", lambda: ls.lstm_fwd(*k1_args))
    torch.cuda.synchronize()
    out = {"phase": "kernels_train_small", "max_abs_err": errs, "tol": tol,
           "ok": ok}
    emit(out)
    return out


def rel_errs(got: dict, want: dict) -> dict:
    return {k: float((got[k] - want[k]).detach().abs().max())
            / max(float(want[k].detach().abs().max()), 1e-30) for k in want}


def phase_grad() -> dict:
    """f32 gradients at full width: the G stack at B=16 (wavefront train
    forward + K2 per layer) and B=32 (+ K3 per layer, on its resident
    route) and D at 16 rows (K1 + K2) and 32 rows (K1 + K3), each against
    the eager cell under autograd."""
    import torch
    from rsrgan_tpu_torch.models import get_discriminator
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    from rsrgan_tpu_torch.ops.lstm import lstm_cell_forward
    from rsrgan_tpu_torch.ops.wavefront_stack import lstm_stack_wavefront
    rng = np.random.default_rng(11)
    tree = generator_tree(12)

    def g_inputs(rng, rows):
        lens = torch.tensor((TRAIN_LENGTHS * (rows // B))[:rows],
                            dtype=torch.int32, device="cuda")
        x = rng.normal(size=(rows, TT, P)).astype(np.float32)
        w = torch.from_numpy(
            rng.normal(size=(rows, TT, P)).astype(np.float32)).cuda()
        return x, w, lens

    def g_grads(kernel: bool, x, w, lens) -> dict:
        params = [{k: torch.from_numpy(v).cuda().requires_grad_(True)
                   for k, v in tree[f"lstm_cell_{i + 1}"].items()}
                  for i in range(L)]
        xt = torch.from_numpy(x).cuda().requires_grad_(True)
        if kernel:
            tap = lstm_stack_wavefront(xt, lens, params, True,
                                       compute_dtype=torch.float32,
                                       save_acts=True)
        else:
            tap = xt
            for p in params:
                tap = lstm_cell_forward(tap, lens, p) + tap
        (tap * w).sum().backward()
        out = {"x": xt.grad}
        out.update({f"lstm_cell_{i + 1}/{k}": v.grad
                    for i, p in enumerate(params) for k, v in p.items()})
        return out

    g16 = g_inputs(rng, B)
    g_err = rel_errs(g_grads(True, *g16), g_grads(False, *g16))
    # B=32: every layer's backward takes K3's resident route (a count each)
    g32 = g_inputs(np.random.default_rng(14), 2 * B)
    before = ls.lstm_bwd_acc.resident_launches
    g32_kernel = g_grads(True, *g32)
    g32_launches = ls.lstm_bwd_acc.resident_launches - before
    g32_err = rel_errs(g32_kernel, g_grads(False, *g32))
    d_err = {}
    for rows in (B, 2 * B):
        torch.manual_seed(rows)
        nets = {impl: get_discriminator("lstm", compute_dtype=torch.float32,
                                        lstm_impl=impl).cuda()
                for impl in ("wavefront", "scan")}
        nets["scan"].load_state_dict(nets["wavefront"].state_dict())
        d_x = rng.normal(size=(rows, TT, DP)).astype(np.float32)
        d_w = torch.from_numpy(
            rng.normal(size=(rows, TT, 1)).astype(np.float32)).cuda()
        d_lens = torch.tensor((TRAIN_LENGTHS * 2)[:rows], dtype=torch.int32,
                              device="cuda")
        grads = {}
        for impl, net in nets.items():
            xt = torch.from_numpy(d_x).cuda().requires_grad_(True)
            (net(xt, d_lens, train=True) * d_w).sum().backward()
            grads[impl] = {"x": xt.grad, **{n: p.grad for n, p in
                                            net.named_parameters()}}
        d_err[rows] = rel_errs(grads["wavefront"], grads["scan"])
    worst = max([*g_err.values(), *g32_err.values()]
                + [e for d in d_err.values() for e in d.values()])
    out = {"phase": "grad", "dtype": "float32", "G_rel_err_max":
           max(g_err.values()), "G32_rel_err_max": max(g32_err.values()),
           "G32_k3_resident_launches": g32_launches,
           "D16_rel_err_max": max(d_err[B].values()),
           "D32_rel_err_max": max(d_err[2 * B].values()),
           "G_rel_err": g_err, "G32_rel_err": g32_err, "tol": GRAD_TOL,
           "ok": worst <= GRAD_TOL and g32_launches == L}
    emit(out)
    return out


# The prepare phase's corpus: 128 train utterances (257 -> 40) in four
# length buckets of 32, so that an epoch at B=16 has two batches per
# bucket, which the shuffle interleaves (the JAX CLI's update order then
# differs from the batcher's); 16 cv utterances in one bucket. Features
# on an LPS-like scale, so that the CMVN the phase computes does work.
CORPUS = (("train", (150, 300, 400, 550), 32), ("cv", (350,), 16))


def prepare_cli(*argv) -> tuple:
    """``python -m rsrgan_tpu_torch.cli.prepare ...`` as a process: (exit
    code, wall seconds, its output)."""
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "rsrgan_tpu_torch.cli.prepare", *argv],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=300)
    return (proc.returncode, time.monotonic() - t0,
            (proc.stdout + proc.stderr).strip())


def phase_prepare(work: str) -> dict:
    """Kaldi arks (every other matrix compressed, formats 1 and 2 by row
    count) and CMVN stats written through the port, then the data
    preparation CLI as a user runs it: cmvn, make-store (train and cv),
    split and verify-store, each a process that must exit 0; every
    stored matrix must be bit-equal to the port's own read of its ark
    with the CMVN applied. The train phase trains from these stores."""
    from rsrgan_tpu_torch.data import (ArkWriter, CmvnAccumulator, ScpReader,
                                       UtteranceStore, load_cmvn_npz,
                                       write_kaldi_cmvn)
    rng = np.random.default_rng(13)
    data_dir = os.path.join(work, "train_data")
    stores = os.path.join(data_dir, "stores")
    frames = {}
    for name, buckets, per in CORPUS:
        d = os.path.join(data_dir, name)
        os.makedirs(d)
        k = 0
        with ArkWriter(os.path.join(d, "inputs.scp")) as win, \
                ArkWriter(os.path.join(d, "labels.scp")) as wlab:
            for b, lo in enumerate(buckets):
                for i in range(per):
                    n = int(rng.integers(lo, lo + 50))
                    utt = f"{name}{b}_{i:02d}"
                    compress = k % 2 == 0
                    win.write_next_utt(
                        os.path.join(d, "inputs.ark"), utt,
                        rng.normal(2.0, 3.0, size=(n, P)).astype(np.float32),
                        compress=compress)
                    wlab.write_next_utt(
                        os.path.join(d, "labels.ark"), utt,
                        rng.normal(0.5, 1.5, size=(n, OUT)).astype(
                            np.float32), compress=compress)
                    k += 1
    # Kaldi's compute-cmvn-stats over the train features as they read back
    acc = {"inputs": CmvnAccumulator(P), "labels": CmvnAccumulator(OUT)}
    train = os.path.join(data_dir, "train")
    for kind, a in acc.items():
        for _, mat in ScpReader(os.path.join(train, f"{kind}.scp")):
            a.accumulate(mat)
        write_kaldi_cmvn(os.path.join(train, f"{kind}.cmvn"),
                         a.stats_matrix())
    runs = {"cmvn": prepare_cli(
        "cmvn", f"--inputs={train}/inputs.cmvn",
        f"--labels={train}/labels.cmvn", f"--save_dir={data_dir}")}
    lists = {}
    for name, _, _ in CORPUS:
        d = os.path.join(data_dir, name)
        runs[f"make-store {name}"] = prepare_cli(
            "make-store", f"--inputs={d}/inputs.scp",
            f"--labels={d}/labels.scp", f"--cmvn_dir={data_dir}",
            f"--output_dir={stores}", f"--name={name}")
        lists[name] = os.path.join(data_dir, f"{name}.list")
        with open(lists[name], "w") as f:
            f.write(os.path.join(stores, f"{name}.rtu") + "\n")
    # split: the whole corpus's scp pair into tr/ (128) and cv/ (16)
    whole = os.path.join(data_dir, "whole")
    os.makedirs(whole)
    for kind in ("inputs", "labels"):
        with open(os.path.join(whole, f"{kind}.scp"), "w") as f:
            for name, _, _ in CORPUS:
                with open(os.path.join(data_dir, name, f"{kind}.scp")) as g:
                    f.write(g.read())
    runs["split"] = prepare_cli("split", "--val_size=16",
                                f"--data_dir={whole}", "--seed=123")
    split_lines = {}
    for sub in ("tr", "cv"):
        with open(os.path.join(whole, sub, "inputs.scp")) as f:
            split_lines[sub] = f.read().splitlines()
    with open(os.path.join(whole, "inputs.scp")) as f:
        all_lines = f.read().splitlines()
    split_ok = (len(split_lines["cv"]) == 16
                and sorted(split_lines["tr"] + split_lines["cv"])
                == sorted(all_lines))
    runs["verify-store"] = prepare_cli(
        "verify-store", *(os.path.join(stores, f"{n}.rtu") for n, _, _ in
                          CORPUS))
    # every stored matrix against the port's read of its ark, CMVN applied
    # in float64 as make-store applies it
    cmvn_in, cmvn_lab = load_cmvn_npz(os.path.join(data_dir,
                                                   "train_cmvn.npz"))
    stored_equal = True
    for name, _, _ in CORPUS:
        store = UtteranceStore(os.path.join(stores, f"{name}.rtu"))
        d = os.path.join(data_dir, name)
        reads = (ScpReader(os.path.join(d, "inputs.scp")),
                 ScpReader(os.path.join(d, "labels.scp")))
        stored_equal = stored_equal and store.utt_ids == reads[0].utt_ids
        for i, utt in enumerate(store.utt_ids):
            for got, reader, cmvn in ((store.inputs(i), reads[0], cmvn_in),
                                      (store.labels(i), reads[1], cmvn_lab)):
                want = cmvn.apply(np.asarray(reader.read_utt(utt),
                                             np.float64)).astype(np.float32)
                stored_equal = stored_equal and np.array_equal(got, want)
        frames[name] = int(store.lengths.sum())
    out = {"phase": "prepare", "utterances": {n: p * len(b) for n, b, p in
                                              CORPUS},
           "frames": frames, "compressed_share": 0.5,
           "cli": {k: {"rc": rc, "seconds": secs, "output": text[-200:]}
                   for k, (rc, secs, text) in runs.items()},
           "make_store_train_frames_per_s_process":
               frames["train"] / runs["make-store train"][1],
           # cmvn reads two small stats files: its wall time is about
           # the interpreter's start-up, which every subcommand pays
           "startup_seconds_cmvn": runs["cmvn"][1],
           "make_store_train_frames_per_s_less_startup":
               frames["train"] / (runs["make-store train"][1]
                                  - runs["cmvn"][1]),
           "split_ok": split_ok, "stored_bit_equal": stored_equal,
           "name, power.limit": card_name_and_limit(),
           "ok": (all(rc == 0 for rc, _, _ in runs.values()) and split_ok
                  and stored_equal
                  and runs["verify-store"][2].count(", OK") == 2)}
    out["lists"] = {"train": lists["train"], "cv": lists["cv"],
                    "data_dir": data_dir}
    emit(out)
    return out


def train_step_parity(tr_list: str) -> dict:
    """One f32 train step (1 D + 2 G) on one B=16 batch of the train
    store, through the kernels and through --lstm_impl=scan, from the same
    seeded state, noise std 0. Gated: the gradients of all three steps
    and the post-step D params (SGD: the update is linear in the
    gradient); reported only: the post-step G params, which pass through
    Adam's first step (update = g / (|g| + eps), so a gradient element
    near 0 may take either sign on either side)."""
    import torch
    from rsrgan_tpu_torch.data import (SequenceBatcher, UtteranceStore,
                                       read_list_file)
    from rsrgan_tpu_torch.models import get_discriminator, get_generator
    from rsrgan_tpu_torch.training import GanTrainer, default_hparams
    store = UtteranceStore(read_list_file(tr_list))
    batch = next(iter(SequenceBatcher(store, B, seed=1)))
    inputs, labels, lens = (torch.from_numpy(a).cuda() for a in
                            (batch.inputs, batch.labels, batch.lengths))
    hp = dict(default_hparams(), disc_noise_std=0.0)
    logs, states = {}, {}
    for impl in ("wavefront", "scan"):
        gen = torch.Generator().manual_seed(21)
        g = get_generator("res_lstm_l", input_dim=P, output_dim=OUT,
                          compute_dtype=torch.float32, lstm_impl=impl,
                          generator=gen).cuda()
        d = get_discriminator("lstm", compute_dtype=torch.float32,
                              lstm_impl=impl, generator=gen).cuda()
        trainer = GanTrainer(g, d, output_dim=OUT, input_dim=P,
                             l2_scale=1e-5)
        state = trainer.init_state()
        trainer.grad_log = []
        trainer.train_step(state, inputs, labels, lens, hp)
        logs[impl], states[impl] = trainer.grad_log, state
    names = ("d_step", "g_step_1", "g_step_2")
    errs = {n: max(rel_errs(k[1], s[1]).values())
            for n, k, s in zip(names, logs["wavefront"], logs["scan"])}
    post = {net: max(rel_errs(
        dict(getattr(states["wavefront"], net).module.named_parameters()),
        dict(getattr(states["scan"], net).module.named_parameters()))
        .values()) for net in ("g", "d")}
    return {"grad_rel_err": errs, "post_step_param_rel_err": post,
            "tol": GRAD_TOL,
            "ok": (all(e <= GRAD_TOL for e in errs.values())
                   and len(errs) == 3 and post["d"] <= GRAD_TOL)}


def longest_utterances(store, rows: int) -> tuple:
    """(inputs, labels, lengths) of the store's ``rows`` longest
    utterances, padded as a SequenceBatcher pads their length bucket."""
    from rsrgan_tpu_torch.data.dataset import bucket_id, padded_length
    idx = np.argsort(-np.asarray(store.lengths), kind="stable")[:rows]
    lengths = np.asarray([store.lengths[i] for i in idx], dtype=np.int32)
    t_pad = padded_length(bucket_id(int(lengths.max())), int(lengths.max()))
    inputs = np.zeros((rows, t_pad, store.input_dim), np.float32)
    labels = np.zeros((rows, t_pad, store.output_dim), np.float32)
    for row, i in enumerate(idx):
        inputs[row, :lengths[row]] = store.inputs(i)
        labels[row, :lengths[row]] = store.labels(i)
    return inputs, labels, lengths


def reset_counts(counters: dict) -> None:
    """Every launch count of ``counters`` (name -> (wrapper, attribute))
    set to 0, or emptied where it is a count by shape."""
    for fn, attr in counters.values():
        setattr(fn, attr, type(getattr(fn, attr))())


def read_counts(counters: dict) -> dict:
    return {name: (dict(v) if isinstance(v := getattr(fn, attr), dict)
                   else v) for name, (fn, attr) in counters.items()}


def profile_train_step(tr_list: str, rows: int, counters: dict) -> dict:
    """Device time by kernel of one bf16 train step on the kernels (a
    warm-up step first), from torch.profiler; wall time from the host
    clock around the step and a synchronize; the launches of the profiled
    step (``counters``, as phase_train's, set to 0 just before it). B=16:
    the T=600 bucket's batch; B=32 (the CLI's default): the 32 longest
    utterances, padded to the longest's bucket."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from rsrgan_tpu_torch.data import (SequenceBatcher, UtteranceStore,
                                       read_list_file)
    from rsrgan_tpu_torch.models import get_discriminator, get_generator
    from rsrgan_tpu_torch.training import GanTrainer
    store = UtteranceStore(read_list_file(tr_list))
    if rows == B:
        batch = max(SequenceBatcher(store, B, seed=1),
                    key=lambda b: b.inputs.shape[1])   # the T=600 bucket
        arrays = (batch.inputs, batch.labels, batch.lengths)
    else:
        arrays = longest_utterances(store, rows)
    args = tuple(torch.from_numpy(a).cuda() for a in arrays)
    gen = torch.Generator().manual_seed(31)
    trainer = GanTrainer(
        get_generator("res_lstm_l", input_dim=P, output_dim=OUT,
                      compute_dtype=torch.bfloat16, generator=gen).cuda(),
        get_discriminator("lstm", compute_dtype=torch.bfloat16,
                          lstm_impl="wavefront", generator=gen).cuda(),
        output_dim=OUT, input_dim=P, l2_scale=1e-5)
    state = trainer.init_state()
    hp = {"g_lr": 3e-4, "d_lr": 1e-3, "mse_lambda": 1.0,
          "disc_noise_std": 0.05, "d_real": 1.0, "d_fake": 0.0}
    noise = torch.Generator(device="cuda").manual_seed(32)
    trainer.train_step(state, *args, hp, noise)
    torch.cuda.synchronize()
    reset_counts(counters)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        m = trainer.train_step(state, *args, hp, noise)
        float(m["g_loss"])
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    launches = read_counts(counters)
    # kernel rows only: an op row (an autograd node, aten::mm) also
    # carries the device time of the kernels launched inside it
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            key = e.key[:100]
            by_kernel[key] = by_kernel.get(key, 0.0) + us / 1e3
    device_ms = sum(by_kernel.values())
    # lstm_bwd_resident_kernel<W, acc>: K2 (acc=false), and K3's walk in
    # acc mode; the profiled steps run bf16
    ours = {name: sum(v for k, v in by_kernel.items() if name in k)
            for name in ("wavefront_resident_kernel",
                         K2_BF16_KERNEL, K3_WALK_BF16_KERNEL,
                         "lstm_fwd_rowgroup_kernel",
                         "lstm_bwd_rowgroup_kernel", "lstm_wgrad_kernel",
                         "lstm_bwd_kernel")}
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8])
    return {"T": int(args[0].shape[1]), "B": rows,
            "true_frames": int(args[2].sum()), "launches": launches,
            "wall_ms": wall_ms,
            "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms if wall_ms else None,
            "hand_kernels_ms": ours,
            "other_kernels_ms": device_ms - sum(ours.values()),
            "top_kernels_ms": top}


def step_peak_bytes(tr_list: str, rows: int) -> int:
    """Device bytes one bf16 train step at ``rows`` (the store's longest
    utterances, T=600) allocates at its peak, the model and its optimizer
    state included: what the device feed's budget must leave free."""
    import gc

    import torch
    from rsrgan_tpu_torch.data import UtteranceStore, read_list_file
    from rsrgan_tpu_torch.models import get_discriminator, get_generator
    from rsrgan_tpu_torch.training import GanTrainer, default_hparams
    store = UtteranceStore(read_list_file(tr_list))
    arrays = longest_utterances(store, rows)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator().manual_seed(41)
    trainer = GanTrainer(
        get_generator("res_lstm_l", input_dim=P, output_dim=OUT,
                      compute_dtype=torch.bfloat16, generator=gen).cuda(),
        get_discriminator("lstm", input_dim=OUT,
                          compute_dtype=torch.bfloat16,
                          lstm_impl="wavefront", generator=gen).cuda(),
        output_dim=OUT, input_dim=P, l2_scale=1e-5)
    state = trainer.init_state()
    trainer.train_step(state, *(torch.from_numpy(a).cuda() for a in arrays),
                       default_hparams())
    torch.cuda.synchronize()
    return int(torch.cuda.max_memory_allocated() - base)


def cli_epoch(train_cli, counters, flags) -> tuple:
    """One CLI training epoch with every launch count set to 0 just
    before it; (its last train and eval metrics rows, the counts, wall
    seconds)."""
    import torch
    reset_counts(counters)
    t0 = time.monotonic()
    rc = train_cli.main(flags)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    launches = read_counts(counters)
    if rc != 0:
        raise RuntimeError(f"training {flags[-3:]} returned {rc}")
    save_dir = next(f.split("=", 1)[1] for f in flags
                    if f.startswith("--save_dir="))
    rows = []
    for split in ("train", "eval"):
        with open(os.path.join(save_dir, f"metrics_{split}.jsonl")) as f:
            rows.append(json.loads(f.readlines()[-1]))
    return rows[0], rows[1], launches, secs


def on_kernel_routes(launches: dict) -> bool:
    """The flagship step's routes at B=16: K4 train mode, K1, K2 and K3's
    row-group walk, none of it on csrc/lstm_bwd.cu."""
    return (all(launches[k] > 0 for k in ("wavefront_fwd_train", "lstm_fwd",
                                           "lstm_bwd", "lstm_bwd_acc"))
            and launches["lstm_bwd_acc_streaming"] == 0)


def speed(row) -> dict:
    """Train frames/s and ms per iteration of a CLI epoch's last row."""
    return {"train_frames_per_s": row["train_frames_per_sec"],
            "ms_per_iteration": 1e3 * row["train_secs"] / row["train_steps"],
            "steps": row["train_steps"]}


def finite_losses(row, cv_row) -> bool:
    return all(np.isfinite(v) for r in (row, cv_row) for k, v in r.items()
               if k.endswith("loss"))


def dropout_epoch(train_cli, counters, flags, main_row, main_launches):
    """--keep_prob=0.8 with res_lstm_l, on the same batches as the main
    path: G leaves the wavefront for the per-layer kernels, K1 at G width
    forward (4 layers x 3 G forwards an iteration: the D step's fake and
    each G step draw their own masks) and K2 backward at B=16, no K4 in
    train mode. K1 at G width is counted where the wrapper launches it
    (``lstm_fwd.launches_by_units`` at U=760); D's and the cv pass's K1
    launches are the main path's."""
    row, cv_row, launches, secs = cli_epoch(
        train_cli, counters, flags("dropout", "--keep_prob=0.8"))
    steps = row["train_steps"]
    k1_g = launches["lstm_fwd_by_units"].get(U, 0)
    out = {"launches": launches, "k1_g_width_launches": k1_g,
           "k1_g_width_per_iteration": k1_g / steps, "seconds": secs,
           "speed": speed(row), "flagship_speed": speed(main_row),
           "losses": {k: v for k, v in row.items() if k.endswith("loss")}}
    out["ok"] = (finite_losses(row, cv_row)
                 and steps == main_row["train_steps"]
                 and k1_g == L * 3 * steps
                 and launches["lstm_fwd"] == main_launches["lstm_fwd"] + k1_g
                 and launches["wavefront_fwd_train"] == 0
                 and launches["lstm_bwd"] == main_launches["lstm_bwd"]
                 and launches["lstm_bwd_acc_streaming"] == 0)
    emit({"phase": "train_dropout", **out,
          "name, power.limit": card_name_and_limit()})
    return out


def lstm_epoch(train_cli, counters, flags, work, data_dir, cv_list,
               main_row, main_launches):
    """--g_type=lstm: K4 in train mode at L=3, U=760, P=280, residual
    off (two launches an iteration: the G forward the D step shares with
    the first G step, and the second G step's), K2 backward for its 3
    layers in each of the 2 G steps where res_lstm_l has 4, D's K1, K2
    and K3 launches as the main path's; then --decode from its
    checkpoint on K4's decode mode (launches counted apart)."""
    import torch
    row, cv_row, launches, secs = cli_epoch(
        train_cli, counters, flags("lstm", "--g_type=lstm"))
    steps = row["train_steps"]
    k2_want = main_launches["lstm_bwd"] - (L - 3) * 2 * steps
    reset_counts(counters)
    save_dir = os.path.join(work, "lstm")
    rc = train_cli.main(["--decode", "--trainer=gan_rnn", "--g_type=lstm",
                         "--decode_batch_size=16", f"--input_dim={P}",
                         f"--output_dim={OUT}", f"--data_dir={data_dir}",
                         f"--test_list_file={cv_list}",
                         f"--save_dir={save_dir}"])
    torch.cuda.synchronize()
    decode_launches = counters["wavefront_fwd"][0].launches
    ark = read_ark(os.path.join(save_dir, "test", "feats.scp"))
    out = {"launches": launches, "decode_launches": decode_launches,
           "lstm_bwd_expected": k2_want, "seconds": secs,
           "speed": speed(row), "decoded": len(ark)}
    out["ok"] = (finite_losses(row, cv_row)
                 and steps == main_row["train_steps"]
                 and launches["wavefront_fwd_train"] == 2 * steps
                 and launches["lstm_bwd"] == k2_want
                 and launches["lstm_fwd"] == main_launches["lstm_fwd"]
                 and launches["lstm_fwd_by_units"].get(U, 0) == 0
                 and launches["lstm_bwd_acc"] == main_launches["lstm_bwd_acc"]
                 and launches["lstm_bwd_acc_resident"] == 0
                 and launches["lstm_bwd_acc_streaming"] == 0 and rc == 0
                 and decode_launches > 0 and len(ark) == 16
                 and all(m.shape[1] == OUT and np.isfinite(m).all()
                         for m in ark.values()))
    emit({"phase": "train_lstm", **out})
    return out


def snapshot_epochs(train_cli, counters, flags, work):
    """Two epochs with --checkpoint_every_secs=1 and the default
    --tensorboard: each split's events file holds a version record and
    one record per metrics_*.jsonl line, steps the iterations, CRCs
    valid; the periodic snapshot exists, and load_newest_state reads it
    back (made the newest file, as after a crash) into a fresh state."""
    import torch
    from rsrgan_tpu_torch.training import (load_newest_state,
                                           periodic_snapshot_path)
    from rsrgan_tpu_torch.training.tensorboard import read_scalar_events
    argv = flags("snapshots", "--checkpoint_every_secs=1",
                 "--min_epoches=2", "--max_epoches=2")
    row, cv_row, launches, secs = cli_epoch(train_cli, counters, argv)
    save_dir = os.path.join(work, "snapshots")
    events_ok, records = True, {}
    for split in ("train", "eval"):
        with open(os.path.join(save_dir, f"metrics_{split}.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        names = os.listdir(os.path.join(save_dir, split))
        events = (read_scalar_events(os.path.join(save_dir, split, names[0]))
                  if len(names) == 1 else [])
        records[split] = len(events)
        events_ok = (events_ok and len(events) == 1 + len(rows) == 3
                     and [e["step"] for e in events[1:]]
                     == [r["iteration"] for r in rows] == [1, 2]
                     and all(e["scalars"][k] == np.float32(r[k])
                             for e, r in zip(events[1:], rows)
                             for k in r if k != "iteration"))
    snap = periodic_snapshot_path(save_dir, "GAN_RNN")
    source, step = None, None
    if os.path.isfile(snap):
        os.utime(snap, (time.time() + 5,) * 2)
        trainer = train_cli.build_trainer(
            train_cli.build_parser().parse_args(argv), torch.device("cuda"),
            torch.bfloat16)
        state = trainer.init_state()
        _, source = load_newest_state(save_dir, "GAN_RNN", state)
        step = state.step
    out = {"seconds": secs, "event_records": records, "events_ok": events_ok,
           "snapshot": os.path.isfile(snap), "restored_from": source,
           "restored_step": step}
    out["ok"] = (finite_losses(row, cv_row) and events_ok
                 and source == "periodic" and step is not None and step >= 1)
    emit({"phase": "train_snapshots", **out})
    return out


def phase_train(work: str, prepared: dict) -> dict:
    """The flagship LSGAN epoch through the CLI, from the prepare phase's
    stores and CMVN: host-fed and device-fed (the main path, bit-equal to
    the host-fed one), graph-fed and conditioned; with dropout
    (--keep_prob=0.8), with --g_type=lstm (and its decode), with periodic
    snapshots and TensorBoard files; decode from the main path's
    checkpoint; the f32 parity; profiled steps; the B=64 step's peak
    memory."""
    import torch
    from rsrgan_tpu_torch.cli import train as train_cli
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    from rsrgan_tpu_torch.ops import wavefront as wf
    from rsrgan_tpu_torch.training import latest_checkpoint

    tr_list, cv_list = prepared["train"], prepared["cv"]
    data_dir = prepared["data_dir"]
    # name -> (wrapper, its count); lstm_bwd_acc counts its three routes
    # apart: the row-group walk, the resident walk, csrc/lstm_bwd.cu
    counters = {"wavefront_fwd_train": (wf.lstm_wavefront_fwd_train,
                                        "launches"),
                "lstm_fwd": (ls.lstm_fwd, "launches"),
                "lstm_fwd_by_units": (ls.lstm_fwd, "launches_by_units"),
                "lstm_bwd": (ls.lstm_bwd, "launches"),
                "lstm_bwd_acc": (ls.lstm_bwd_acc, "launches"),
                "lstm_bwd_acc_resident": (ls.lstm_bwd_acc,
                                          "resident_launches"),
                "lstm_bwd_acc_streaming": (ls.lstm_bwd_acc,
                                           "streaming_launches"),
                "wavefront_fwd": (wf.lstm_wavefront_fwd, "launches")}

    def flags(tag, *extra):
        return ["--trainer=gan_rnn", "--g_type=res_lstm_l",
                "--batch_size=16", "--min_epoches=1", "--max_epoches=1",
                f"--input_dim={P}", f"--output_dim={OUT}",
                f"--data_dir={data_dir}", f"--tr_list_file={tr_list}",
                f"--cv_list_file={cv_list}", "--seed=5", *extra,
                f"--save_dir={os.path.join(work, tag)}"]

    def losses_of(row, cv_row):
        return {k: v for k, v in {**row, **{"cv_" + k: v for k, v in
                                            cv_row.items()}}.items()
                if k.endswith("loss")}

    # the two feeds in turns (host, device, device, host): the first run
    # also pays the kernels' first launches. The second is the main
    # path: the default flags, which on a card feed from the resident
    # tables (--device_feed=auto).
    runs = {}
    for tag in ("host", "train_exp", "device_2", "host_2"):
        extra = ("--device_feed=off",) if tag.startswith("host") else ()
        runs[tag] = cli_epoch(train_cli, counters, flags(tag, *extra))
    row, cv_row, launches, secs = runs["train_exp"]
    save_dir = os.path.join(work, "train_exp")
    losses = losses_of(row, cv_row)
    ckpt = latest_checkpoint(save_dir, "GAN_RNN")
    with open(ckpt, "rb") as f:
        main_bytes = f.read()
    feeds_equal = True
    for tag, (t_row, t_cv, _, _) in runs.items():
        other = latest_checkpoint(os.path.join(work, tag), "GAN_RNN")
        with open(other, "rb") as f:
            feeds_equal = (feeds_equal and f.read() == main_bytes
                           and losses_of(t_row, t_cv) == losses)

    feed_speeds = {tag: speed(r[0]) for tag, r in runs.items()}
    emit({"phase": "train_feeds", "B": B, "order": list(runs),
          "speed": feed_speeds, "bit_equal": feeds_equal,
          "name, power.limit": card_name_and_limit()})

    variants = {}
    for tag, extra in (("graph_fed", "--same_batch=false"),
                       ("d_conditioned", "--d_conditioned=true")):
        v_row, v_cv, v_launches, _ = cli_epoch(train_cli, counters,
                                               flags(tag, extra))
        v_losses = losses_of(v_row, v_cv)
        variants[tag] = {"losses": v_losses, "launches": v_launches,
                         "steps": v_row["train_steps"],
                         "ok": (on_kernel_routes(v_launches)
                                and all(np.isfinite(x)
                                        for x in v_losses.values()))}

    dropout = dropout_epoch(train_cli, counters, flags, row, launches)
    lstm = lstm_epoch(train_cli, counters, flags, work, data_dir, cv_list,
                      row, launches)
    snapshots = snapshot_epochs(train_cli, counters, flags, work)

    rc = train_cli.main(["--decode", "--trainer=gan_rnn",
                         "--g_type=res_lstm_l", "--decode_batch_size=16",
                         f"--input_dim={P}", f"--output_dim={OUT}",
                         f"--data_dir={data_dir}",
                         f"--test_list_file={cv_list}",
                         f"--save_dir={save_dir}"])
    torch.cuda.synchronize()
    ark = read_ark(os.path.join(save_dir, "test", "feats.scp"))
    decode_ok = (rc == 0 and len(ark) == 16
                 and all(m.shape[1] == OUT and np.isfinite(m).all()
                         for m in ark.values()))
    parity = train_step_parity(tr_list)
    profile = profile_train_step(tr_list, B, counters)
    # the profiled step's D-step backward on K3's row-group kernels, and
    # none of it on csrc/lstm_bwd.cu (B=16: no G layer reaches K3)
    hand = profile["hand_kernels_ms"]
    k3_rowgroup = (hand["lstm_bwd_rowgroup_kernel"] > 0
                   and hand["lstm_wgrad_kernel"] > 0
                   and hand["lstm_bwd_kernel"] == 0)
    # B=32, the CLI's default: every G layer's backward (4 layers x 2 G
    # steps) on K3's resident route, none on csrc/lstm_bwd.cu
    profile32 = profile_train_step(tr_list, 2 * B, counters)
    hand32, runs32 = profile32["hand_kernels_ms"], profile32["launches"]
    k3_resident = (runs32["lstm_bwd_acc_resident"] == 2 * L
                   and runs32["lstm_bwd_acc_streaming"] == 0
                   and hand32[K3_WALK_BF16_KERNEL] > 0
                   and hand32["lstm_bwd_kernel"] == 0)
    peak64 = step_peak_bytes(tr_list, 4 * B)
    out = {"phase": "train", "seconds": secs, "launches": launches,
           "steps": row["train_steps"], "train_secs": row["train_secs"],
           "train_frames_per_s": row["train_frames_per_sec"],
           "ms_per_iteration": 1e3 * row["train_secs"] / row["train_steps"],
           "feeds": feed_speeds, "feeds_bit_equal": feeds_equal,
           "losses": losses, "checkpoint": os.path.basename(ckpt or ""),
           "variants": variants, "dropout": dropout, "lstm": lstm,
           "snapshots": snapshots,
           "decode_ok": decode_ok, "parity_f32": parity,
           "profile_bf16_step": profile, "k3_rowgroup_in_step": k3_rowgroup,
           "profile_bf16_step_b32": profile32,
           "k3_resident_in_b32_step": k3_resident,
           "step_peak_bytes_b64_t600": peak64,
           "feed_reserve_bytes": train_cli.FEED_RESERVE_BYTES,
           "ok": (on_kernel_routes(launches) and feeds_equal
                  and all(v["ok"] for v in variants.values())
                  and dropout["ok"] and lstm["ok"] and snapshots["ok"]
                  and k3_rowgroup and k3_resident
                  and all(np.isfinite(v) for v in losses.values())
                  and ckpt is not None and decode_ok and parity["ok"]
                  and peak64 < train_cli.FEED_RESERVE_BYTES)}
    emit(out)
    return out


# The feed phase's corpus: about 2 GB of f32 tables (257 + 40 columns),
# utterances of 150-600 frames; the reference's training set (~100 h) is
# ~36 M frames, which the upload rate is extrapolated to.
FEED_FRAMES = 1_700_000
REFERENCE_FRAMES = 36_000_000
# Rotation: a slice of the corpus cut into at least 3 shards by the
# budget, two passes with prefetch; each residency's gathers queue behind
# a device sleep, so an upload that did not wait for them would overwrite
# rows they still have to read.
ROTATION_UTTS = 1200
ROTATION_SLEEP_CYCLES = 200_000_000


def write_feed_corpus(data_dir: str, seed: int) -> tuple:
    """A seeded store of about FEED_FRAMES frames, plus a 16-utterance cv
    store; their list files."""
    from rsrgan_tpu_torch.data import StoreWriter
    rng = np.random.default_rng(seed)
    lists, frames = {}, 0
    for name in ("feed_tr", "feed_cv"):
        path = os.path.join(data_dir, f"{name}.rtu")
        with StoreWriter(path) as w:
            i = 0
            while (frames < FEED_FRAMES if name == "feed_tr" else i < 16):
                n = int(rng.integers(150, 601))
                w.add(f"{name}{i:05d}",
                      rng.standard_normal((n, P), dtype=np.float32),
                      rng.standard_normal((n, OUT), dtype=np.float32))
                frames += n if name == "feed_tr" else 0
                i += 1
        lists[name] = os.path.join(data_dir, f"{name}.list")
        with open(lists[name], "w") as f:
            f.write(path + "\n")
    return lists["feed_tr"], lists["feed_cv"]


def host_batch_ms(batcher, indices, device, reps: int) -> tuple:
    """The host feed's cost of one batch: SequenceBatcher._make_batch and
    the pageable copies of its three arrays, to a synchronise (ms, the
    last batch)."""
    import torch
    times = []
    for _ in range(reps):
        t0 = time.monotonic()
        batch = batcher._make_batch(indices)
        on_dev = [torch.from_numpy(a).to(device)
                  for a in (batch.inputs, batch.labels, batch.lengths)]
        torch.cuda.synchronize()
        times.append((time.monotonic() - t0) * 1e3)
    return float(np.median(times)), on_dev


def rotation_check(store, cv_store, device) -> dict:
    """The CLI's rotating feed on ROTATION_UTTS utterances: a budget in
    RSRGAN_FEED_HBM_BUDGET that cuts them into >= 3 shards, decided by
    decide_device_feed as the CLI decides it, prefetch on, block 1, two
    passes; every gathered batch of every residency against the host
    batch of that shard's StoreView batcher, bit for bit."""
    import torch
    from rsrgan_tpu_torch.cli import train as train_cli
    from rsrgan_tpu_torch.data import SequenceBatcher, StoreView
    from rsrgan_tpu_torch.data.device_feed import (RotatingDeviceFeed,
                                                   table_bytes)
    from rsrgan_tpu_torch.ops.gather import assemble_sequence_batch
    view = StoreView(store, np.arange(ROTATION_UTTS))
    cv_bytes = table_bytes(cv_store, 4)
    # two buffers of a quarter of the slice each: four or five shards
    budget = cv_bytes + table_bytes(view, 4) // 2
    args = train_cli.build_parser().parse_args(
        ["--device_feed=on", "--device_feed_dtype=float32",
         "--feed_prefetch=true"])
    old = os.environ.get("RSRGAN_FEED_HBM_BUDGET")
    os.environ["RSRGAN_FEED_HBM_BUDGET"] = str(budget)
    try:
        plan = train_cli.decide_device_feed(args, view, cv_store, device)
    finally:
        if old is None:
            del os.environ["RSRGAN_FEED_HBM_BUDGET"]
        else:
            os.environ["RSRGAN_FEED_HBM_BUDGET"] = old
    feed = RotatingDeviceFeed(view, plan.dtype, plan.budget - cv_bytes,
                              device, seed=5, prefetch=True)
    def make_batcher(shard):
        # the CLI's rule: ragged batches where a shard has no full one
        b = SequenceBatcher(shard, B, seed=5)
        return (b if b.num_batches() else
                SequenceBatcher(shard, B, seed=5, drop_remainder=False))

    batchers = [make_batcher(StoreView(view, s)) for s in feed.shards]
    visits = feed.schedule(2, 1, seed=5)
    gathered = []
    t0 = time.monotonic()
    for r, (k, _) in enumerate(visits):
        feed.ensure_resident(k)
        if r + 1 < len(visits):
            feed.start_prefetch(visits[r + 1][0])
        torch.cuda._sleep(ROTATION_SLEEP_CYCLES)
        for indices in batchers[k].iter_index_batches():
            st, le = feed.plan(indices)
            x, y = assemble_sequence_batch(
                feed.inputs_tbl, feed.labels_tbl,
                torch.from_numpy(st).to(device),
                torch.from_numpy(le).to(device),
                train_cli.plan_key(le, batchers[k].num_buckets)[0], 0, 0)
            gathered.append((k, indices, x, y))
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    mismatched = 0
    for k, indices, x, y in gathered:
        host = batchers[k]._make_batch(indices)
        mismatched += int(not (
            np.array_equal(x.cpu().numpy(), host.inputs)
            and np.array_equal(y.cpu().numpy(), host.labels)))
    return {"shards": feed.num_shards, "residencies": len(visits),
            "rotate": plan.rotate, "budget_bytes": budget,
            "batches": len(gathered), "mismatched": mismatched,
            "uploads": feed.uploads, "upload_secs": feed.upload_secs,
            "seconds": secs,
            "ok": (plan.rotate and feed.num_shards >= 3 and mismatched == 0
                   and len({k for k, *_ in gathered}) == feed.num_shards)}


def phase_feed(work: str) -> dict:
    """The device feed at the scale of a real corpus: upload rates of f32
    and bf16 tables (and the reference corpus's upload, extrapolated), the
    gather of one batch at B=16 and 32, T_pad=600, against the host
    batch, and the rotating feed bit-equal to the host batches."""
    import torch
    from rsrgan_tpu_torch.cli import train as train_cli
    from rsrgan_tpu_torch.data import (SequenceBatcher, UtteranceStore,
                                       read_list_file)
    from rsrgan_tpu_torch.data.device_feed import DeviceFeed, table_bytes
    from rsrgan_tpu_torch.ops.gather import assemble_sequence_batch
    device = torch.device("cuda")
    data_dir = os.path.join(work, "feed_data")
    os.makedirs(data_dir)
    t0 = time.monotonic()
    tr_list, cv_list = write_feed_corpus(data_dir, 17)
    store = UtteranceStore(read_list_file(tr_list))
    cv_store = UtteranceStore(read_list_file(cv_list))
    write_secs = time.monotonic() - t0
    frames = int(store.lengths.sum())
    host_bytes = table_bytes(store, 4)   # what crosses the link, f32 rows

    uploads = {}
    feed = None
    for dtype_name in ("bfloat16", "float32"):
        secs = []
        for _ in range(2):
            feed = None
            torch.cuda.empty_cache()
            t1 = time.monotonic()
            feed = DeviceFeed(store, getattr(torch, dtype_name), device)
            secs.append(time.monotonic() - t1)
        uploads[dtype_name] = {
            "seconds": secs, "table_bytes": feed.num_bytes,
            "host_gb_per_s": [host_bytes / s / 1e9 for s in secs],
            "extrapolated_reference_upload_s": (
                REFERENCE_FRAMES / frames * min(secs))}
    # feed holds the f32 tables now
    batcher = SequenceBatcher(store, B, seed=0)
    # lengths 551-599 pad to 600 (600 itself opens the next bucket)
    long_ix = [int(i) for i in np.flatnonzero(
        (store.lengths > 550) & (store.lengths < 600))]
    gather, equal = {}, len(long_ix) >= 2 * B
    for rows in (B, 2 * B):
        indices = long_ix[:rows]
        st, le = feed.plan(indices)
        st_d, le_d = (torch.from_numpy(a).to(device) for a in (st, le))
        run = lambda: assemble_sequence_batch(  # noqa: E731
            feed.inputs_tbl, feed.labels_tbl, st_d, le_d, 600, 0, 0)
        x, y = run()
        host_ms, (hx, hy, _) = host_batch_ms(batcher, indices, device, 5)
        equal = equal and torch.equal(x, hx) and torch.equal(y, hy)
        gather[rows] = {"gather_us": 1e3 * cuda_time_ms(run, 50),
                        "host_batch_ms": host_ms, "T_pad": 600,
                        "bytes_out": (x.numel() + y.numel()) * 4}
    feed = None
    torch.cuda.empty_cache()
    rotation = rotation_check(store, cv_store, device)
    secs = time.monotonic() - t0
    shutil.rmtree(data_dir)
    out = {"phase": "feed", "frames": frames, "utterances": len(store),
           "f32_table_bytes": host_bytes, "corpus_write_secs": write_secs,
           "upload": uploads, "gather": gather, "gather_equals_host": equal,
           "rotation": rotation, "seconds": secs,
           "default_budget_bytes": train_cli.default_feed_budget(device),
           "name, power.limit": card_name_and_limit(),
           "ok": equal and rotation["ok"]}
    emit(out)
    return out


def read_ark(scp_path: str) -> dict:
    from rsrgan_tpu_torch.data import ScpReader
    return dict(iter(ScpReader(scp_path)))


def phase_decode(work: str) -> dict:

    import torch
    from rsrgan_tpu_torch.cli import train as train_cli
    from rsrgan_tpu_torch.data import StoreWriter
    from rsrgan_tpu_torch.ops.wavefront import lstm_wavefront_fwd
    from rsrgan_tpu_torch.training import save_checkpoint

    rng = np.random.default_rng(3)
    data_dir = os.path.join(work, "data")
    os.makedirs(data_dir)
    lengths = rng.integers(150, 601, size=32)
    with StoreWriter(os.path.join(data_dir, "test.rtu")) as store:
        for i, n in enumerate(lengths):
            store.add(f"utt{i:04d}",
                      rng.normal(size=(int(n), P)).astype(np.float32))
    test_list = os.path.join(data_dir, "test.list")
    with open(test_list, "w") as f:
        f.write(os.path.join(data_dir, "test.rtu") + "\n")
    np.savez(os.path.join(data_dir, "train_cmvn.npz"),
             mean_inputs=rng.normal(size=P), stddev_inputs=np.ones(P),
             mean_labels=rng.normal(size=OUT),
             stddev_labels=rng.uniform(0.5, 2.0, size=OUT))
    tree = generator_tree(4)
    ckpt_dir = os.path.join(work, "ckpt")
    save_checkpoint(ckpt_dir, "GAN_RNN",
                    {"g": {"params": tree, "ema": tree},
                     "step": np.zeros((), np.int32)}, 1,
                    meta={"trainer": "gan_rnn", "g_type": "res_lstm_l",
                          "input_dim": P, "output_dim": OUT,
                          "left_context": 0, "right_context": 0})

    def decode(tag, *flags):
        save_dir = os.path.join(work, tag)
        shutil.copytree(ckpt_dir, save_dir)
        t0 = time.monotonic()
        rc = train_cli.main(["--decode", "--trainer=gan_rnn",
                             "--g_type=res_lstm_l", "--decode_batch_size=16",
                             f"--input_dim={P}", f"--output_dim={OUT}",
                             f"--data_dir={data_dir}",
                             f"--test_list_file={test_list}",
                             f"--save_dir={save_dir}", *flags])
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        if rc != 0:
            raise RuntimeError(f"decode {tag} returned {rc}")
        return read_ark(os.path.join(save_dir, "test", "feats.scp")), secs

    f32_kernel, _ = decode("f32_kernel", "--bf16=false")
    f32_scan, scan_secs = decode("f32_scan", "--bf16=false",
                                 "--lstm_impl=scan")
    lstm_wavefront_fwd.launches = 0
    main_ark, main_secs = decode("main")  # default flags: bf16, kernel
    launches = lstm_wavefront_fwd.launches

    frames = int(lengths.sum())
    shapes_ok = all(main_ark[f"utt{i:04d}"].shape == (int(n), OUT)
                    for i, n in enumerate(lengths))
    finite = all(np.isfinite(m).all() for m in main_ark.values())
    diff_f32 = max(float(np.abs(f32_kernel[u] - f32_scan[u]).max())
                   for u in f32_scan)
    diff_bf16 = max(float(np.abs(main_ark[u] - f32_scan[u]).max())
                    for u in f32_scan)
    out = {"phase": "decode", "utterances": len(main_ark), "frames": frames,
           "main_seconds": main_secs, "frames_per_s": frames / main_secs,
           "scan_f32_seconds": scan_secs, "launches": launches,
           "shapes_ok": shapes_ok, "finite": finite,
           "f32_kernel_vs_scan_max_abs": diff_f32, "tol": DECODE_TOL_F32,
           "bf16_kernel_vs_f32_scan_max_abs": diff_bf16,
           "ok": (launches > 0 and shapes_ok and finite
                  and diff_f32 <= DECODE_TOL_F32)}
    emit(out)
    return out


def card_name_and_limit() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, check=True)
    return proc.stdout.strip().splitlines()[0]


PHASES = ("build", "kernel", "kernels_train", "grad", "prepare", "train",
          "feed", "decode")


def kernel_entry(name, source, replaces, launches, launches_per, result,
                 bound_keys):
    extra = {k: result[k] for k in ("grid", "design", "streaming_ms",
                                    "us_per_step", "walk_ms", "reduction_ms",
                                    "walk_bound_ms", "reduction_bound_ms")
             if k in result}
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "launches_per": launches_per,
            "max_abs_err": (max(result["max_abs_err"].values())
                            if isinstance(result["max_abs_err"], dict)
                            else result["max_abs_err"]),
            "ms": result["ms"], "plain_ms": result["plain_ms"],
            "bound_ms": bound_keys["bound_ms"],
            "bound_by": bound_keys["bound_by"],
            # no single PyTorch call computes these functions: the cell
            # has peepholes and a projection, which torch.nn.LSTM and
            # cuDNN do not (ROADMAP.md)
            "library_ms": None, **extra}


def kernels_line(results: dict) -> dict:
    """One entry per kernel: launches from the main-path runs (train and
    decode phases; ``launches_per`` names the run), error and times from
    the bf16 kernel phases at the main path's shapes, bounds from those
    phases' inputs."""
    dec = results["kernel"]["bfloat16"]
    entries = [kernel_entry(
        "wavefront_fwd (decode, save_acts=False)", RESIDENT, REPLACES,
        results["decode"]["launches"], "decode run (32 utterances)", dec,
        wavefront_bound(L, U, P, B, T, LENGTHS, "bfloat16", train=False))]
    if "kernels_train" in results:
        epoch = results["train"]["launches"]
        dropout, lstm = results["train"]["dropout"], results["train"]["lstm"]
        # K3 at G width runs at the CLI's default batch, not at B=16: its
        # launches are the profiled B=32 step's
        step32 = results["train"]["profile_bf16_step_b32"]["launches"]
        by_name = {}
        for r in results["kernels_train"]["bfloat16"]:
            by_name.setdefault((r["kernel"], r.get("net"), r.get("B")), r)
        for key, label, source, replaces in (
                (("wavefront_fwd_train", None, B),
                 "wavefront_fwd (train, save_acts=True)", RESIDENT,
                 REPLACES),
                (("lstm_fwd", "D", B), "lstm_fwd (K1, D forward, B=16)",
                 RESIDENT, "rsrgan_tpu/ops/pallas_lstm.py:74"),
                (("lstm_fwd", "D", 2 * B),
                 "lstm_fwd (K1, D forward, 32 rows)", RESIDENT,
                 "rsrgan_tpu/ops/pallas_lstm.py:74"),
                (("lstm_bwd", "G", B), "lstm_bwd (K2, G layer, B=16)",
                 RESIDENT, "rsrgan_tpu/ops/pallas_lstm.py:196"),
                (("lstm_bwd", "D", B), "lstm_bwd (K2, D layer, B=16)",
                 RESIDENT, "rsrgan_tpu/ops/pallas_lstm.py:196"),
                (("lstm_bwd_acc", "D", 2 * B),
                 "lstm_bwd_acc (K3, D step, 32 rows: the row-group walk "
                 "lstm_bwd_rowgroup_kernel, then its reduction "
                 "lstm_wgrad_kernel)", RESIDENT,
                 "rsrgan_tpu/ops/pallas_lstm.py:364"),
                (("lstm_bwd_acc", "G", 2 * B),
                 "lstm_bwd_acc (K3, G layer, B=32: the resident walk "
                 "lstm_bwd_resident_kernel in acc mode, then its reduction "
                 "lstm_wgrad_kernel)", RESIDENT,
                 "rsrgan_tpu/ops/pallas_lstm.py:364"),
                (("lstm_fwd", "G", B),
                 "lstm_fwd (K1, G layer at U=760, P=257, B=16: res_lstm_l "
                 "with --keep_prob < 1)", RESIDENT,
                 "rsrgan_tpu/ops/pallas_lstm.py:74"),
                (("wavefront_fwd_train", "G_lstm", B),
                 "wavefront_fwd (train, save_acts=True; --g_type=lstm: L=3, "
                 "P=280, residual off)", RESIDENT, REPLACES)):
            r = by_name[key]
            if r.get("route") == "resident":
                runs = (step32["lstm_bwd_acc_resident"],
                        "one profiled train step at B=32")
            elif key == ("lstm_fwd", "G", B):
                runs = (dropout["k1_g_width_launches"],
                        "dropout epoch at B=16 (--keep_prob=0.8, device "
                        "feed, 8 iterations), K1 launches at U=760")
            elif key[1] == "G_lstm":
                runs = (lstm["launches"]["wavefront_fwd_train"],
                        "--g_type=lstm epoch at B=16 (device feed, 8 "
                        "iterations)")
            else:
                runs = (epoch[key[0]],
                        "train epoch at B=16, device feed (8 iterations, "
                        "cv pass)")
            entries.append(kernel_entry(label, source, replaces, *runs, r,
                                        r))
    return {"kernels": entries}


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES))
    phases = parser.parse_args(argv).phases.split(",")
    if not os.path.isdir(os.path.join(HERE, "rsrgan_tpu_torch")):
        return fail("rsrgan_tpu_torch/ is not beside chip_smoke.py")
    sys.path.insert(0, HERE)
    try:
        import torch
    except ImportError as e:
        return fail(f"torch is not importable ({e})")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)

    card = card_name_and_limit()
    emit({"phase": "card", "name, power.limit": card})
    results, oks = {}, []
    phase_build()
    if "kernel" in phases:
        results["kernel"] = {d: phase_kernel(d)
                             for d in ("float32", "bfloat16")}
        small = phase_kernel_small()
        oks += [r["ok"] for r in results["kernel"].values()] + [small["ok"]]
    if "kernels_train" in phases:
        results["kernels_train"] = {d: phase_kernels_train(d)
                                    for d in ("float32", "bfloat16")}
        small = phase_kernels_train_small()
        oks += [r["ok"] for rs in results["kernels_train"].values()
                for r in rs] + [small["ok"]]
    if "grad" in phases:
        oks.append(phase_grad()["ok"])
    with tempfile.TemporaryDirectory() as work:
        # the train phase trains from the prepare phase's stores
        if "prepare" in phases or "train" in phases:
            prepared = phase_prepare(work)
            oks.append(prepared["ok"])
        if "train" in phases:
            results["train"] = phase_train(work, prepared["lists"])
            oks.append(results["train"]["ok"])
        if "feed" in phases:
            oks.append(phase_feed(work)["ok"])
        if "decode" in phases:
            results["decode"] = phase_decode(work)
            oks.append(results["decode"]["ok"])
    if not all(oks):
        return fail("a phase failed (see the lines with \"ok\": false)")
    if set(phases) != set(PHASES):
        return fail(f"only phases {phases} ran; no result")

    emit(kernels_line(results))
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
