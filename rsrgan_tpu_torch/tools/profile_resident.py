"""Where a step of the resident kernels goes, section by section, on the card.

    python3 -m rsrgan_tpu_torch.tools.profile_resident

Builds ``csrc/resident.cu`` with ``-DRESIDENT_PROFILE`` (its section
timers: globaltimer nanoseconds per section, in block 0 and in the last
block, each section closed by a block barrier, which slows a step by a few
per cent) and runs, at chip_smoke.py's shapes in bf16 (one case also
in f32) with every row at full length: K4 decode at B = 1, 16 and 64 (T=512), K4 train (B=16,
T=500), K2 at G width (U=760, P=257) and at D width (U=256, P=40), B=16,
T=500, K1 (the row-group kernel) at D width with 16 and 32 rows,
T=500, in training mode, K1 at G width (U=760, P=257) with 16 and 32
rows on its resident route (K4's grid at L = 1: K4's sections), T=500, in
training mode, in bf16 and f32, and K3 (the row-group walk, timed with its
reduction) at D width with 32 and 64 rows, T=500, and (K2's resident walk
in acc mode, timed with its reduction) at G width, B=32. Prints the card's
``name, power.limit`` and one
JSON line per case: the kernel's time (CUDA events, 3 launches, without
the timers' cost removed), microseconds per step, and each section's
microseconds per step in both blocks. Needs a CUDA device and nvcc; exits
non-zero without them.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

K2_SECTIONS = ("stage", "dm_mma", "cell", "dh_mma", "barrier_1", "phase_b",
               "barrier_2")
K4_SECTIONS = ("stage", "gate_mma", "cell", "proj_mma", "barrier_1",
               "phase_b", "barrier_2")
K1_SECTIONS = ("gate_mma_cell", "streams_proj_mma", "sum_store")
K3_SECTIONS = ("dm_mma_cell", "streams_dh_mma", "sum_store")


def build():
    """Build the timed library and make the wrappers launch it."""
    from rsrgan_tpu_torch.ops import _build
    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, "libresident_profile.so")
    proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-DRESIDENT_PROFILE",
                           "-o", path,
                           os.path.join(_build.CSRC, "resident.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    lib = ctypes.CDLL(path)
    lib.resident_sections.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.resident_sections.restype = ctypes.c_int
    _build._LIBS["resident"] = lib
    return lib


def glorot(rng, shape):
    limit = np.sqrt(6.0 / (shape[0] + shape[1]))
    return rng.uniform(-limit, limit, size=shape).astype(np.float32)


def stack_args(rng, L, U, P, B, T, cdt):
    """Seeded arguments of the wavefront kernel, every row at length T."""
    import torch
    from rsrgan_tpu_torch.ops.wavefront_stack import _prep
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    params = [{"kernel": t(glorot(rng, (2 * P, 4 * U))),
               "bias": t(rng.normal(0, 0.1, 4 * U).astype(np.float32)),
               "proj_kernel": t(glorot(rng, (U, P))),
               "w_i_diag": t(glorot(rng, (1, U))),
               "w_f_diag": t(glorot(rng, (1, U))),
               "w_o_diag": t(glorot(rng, (1, U)))} for _ in range(L)]
    x = t(rng.normal(size=(T, B, P)).astype(np.float32))
    wx, wh, bias, proj, wi, wf, wo = _prep(params, P, 1.0)
    wx, wh, proj = (a.to(cdt).contiguous() for a in (wx, wh, proj))
    xw1 = torch.matmul(x, wx[0].float()).to(cdt)
    lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
    return (xw1, lens, x, wx[1:].contiguous(), wh, proj, bias.contiguous(),
            wi.contiguous(), wf.contiguous(), wo.contiguous())


def measure(lib, name, fn, steps, sections, first):
    import torch
    buf = (ctypes.c_ulonglong * 32)()
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(3):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 3
    lib.resident_sections(buf, 1)
    fn()
    torch.cuda.synchronize()
    if lib.resident_sections(buf, 1):
        raise RuntimeError("cannot read the section timers")
    ns = np.array(buf[:], dtype=np.float64).reshape(2, 16)
    per_step = ns[:, first:first + len(sections)] / steps / 1e3
    out = {"case": name, "ms": ms, "us_per_step": ms * 1e3 / steps,
           "block_0_us": dict(zip(sections, per_step[0].round(3))),
           "last_block_us": dict(zip(sections, per_step[1].round(3)))}
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_resident: no CUDA device", file=sys.stderr)
        return 1
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    from rsrgan_tpu_torch.ops import wavefront as wf
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    lib = build()
    rng = np.random.default_rng(0)
    cdt = torch.bfloat16
    L, U, P = 4, 760, 257
    for B in (1, 16, 64):
        args = stack_args(rng, L, U, P, B, 512, cdt)
        measure(lib, f"K4 decode B={B} T=512",
                lambda: wf.lstm_wavefront_fwd(*args, residual=True),
                512 + L - 1, K4_SECTIONS, 8)
    args = stack_args(rng, L, U, P, 16, 500, cdt)
    measure(lib, "K4 train B=16 T=500",
            lambda: wf.lstm_wavefront_fwd_train(*args, residual=True),
            500 + L - 1, K4_SECTIONS, 8)
    for U_, P_ in ((U, P), (256, 40)):
        largs = stack_args(rng, 1, U_, P_, 16, 500, cdt)
        _, c_s, _, acts = wf.lstm_wavefront_fwd_train(*largs, residual=False)
        dout = torch.from_numpy(
            rng.normal(size=(500, 16, P_)).astype(np.float32)).cuda()
        _, lens, _, _, wh, proj, _, wi, wf_, wo = largs
        bwd = (acts[0], lens, dout, c_s[0], wh[0], proj[0], wi[0], wf_[0],
               wo[0])
        measure(lib, f"K2 U={U_} P={P_} B=16 T=500",
                lambda: ls.lstm_bwd(*bwd), 500, K2_SECTIONS, 0)
    # K3 at G width, the CLI's default B=32: K2's sections (the time
    # includes the reduction after the walk)
    largs = stack_args(rng, 1, U, P, 32, 500, cdt)
    _, c_s, h_s, acts = wf.lstm_wavefront_fwd_train(*largs, residual=False)
    dout = torch.from_numpy(
        rng.normal(size=(500, 32, P)).astype(np.float32)).cuda()
    _, lens, _, _, wh, proj, _, wi, wf_, wo = largs
    bwd = (acts[0], lens, dout, c_s[0], h_s[0], wh[0], proj[0], wi[0],
           wf_[0], wo[0])
    measure(lib, f"K3 U={U} P={P} B=32 T=500",
            lambda: ls.lstm_bwd_acc(*bwd), 500, K2_SECTIONS, 0)
    for B in (16, 32, 64):
        largs = stack_args(rng, 1, 256, 40, B, 500, cdt)
        fwd = (largs[0], largs[1], largs[4][0], largs[5][0], largs[6][0],
               largs[7][0], largs[8][0], largs[9][0])
        if B <= 32:
            measure(lib, f"K1 U=256 P=40 B={B} T=500",
                    lambda: ls.lstm_fwd(*fwd), 500, K1_SECTIONS, 0)
        if B >= ls.ACC_BWD_MIN_BATCH:
            _, c_h, h_h, acts = ls.lstm_fwd(*fwd)
            dout = torch.from_numpy(
                rng.normal(size=(500, B, 40)).astype(np.float32)).cuda()
            bwd = (acts, fwd[1], dout, c_h, h_h, fwd[2], fwd[3], *fwd[5:])
            # the time includes the reduction after the walk; the
            # sections are the walk's
            measure(lib, f"K3 U=256 P=40 B={B} T=500",
                    lambda: ls.lstm_bwd_acc(*bwd), 500, K3_SECTIONS, 0)
    # K1 at G width, as dropout and res_lstm_i run it: the resident route
    # (K4's kernel at L = 1, so K4's sections), bf16 and f32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dt in (cdt, torch.float32):
        for B in (16, 32):
            largs = stack_args(rng, 1, U, P, B, 500, dt)
            fwd = (largs[0], largs[1], largs[4][0], largs[5][0],
                   largs[6][0], largs[7][0], largs[8][0], largs[9][0])
            assert ls.fwd_route(B, U, P, dt, sms) == "resident"
            measure(lib, f"K1 U={U} P={P} B={B} T=500 {dt} (resident "
                    f"route, {wf.resident_plan(B, 1, U, P, dt, sms).nbl} "
                    "blocks)", lambda: ls.lstm_fwd(*fwd), 500, K4_SECTIONS, 8)
    return 0


if __name__ == "__main__":
    sys.exit(main())
