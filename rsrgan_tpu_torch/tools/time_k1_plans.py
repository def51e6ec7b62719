"""K1 at G's width on K4's resident grid (L = 1), timed by grid size.

    python3 -m rsrgan_tpu_torch.tools.time_k1_plans [--T 500]

At U=760, P=257 (res_lstm_l's layers with dropout, res_lstm_i's), every
row at full length, times one layer's training forward (the saved
streams) on ``wavefront.resident_plan(B, 1, ...)`` at several blocks per
layer (``nbl``: fewer blocks own more units each, so the partial h has
fewer terms to write and to sum in phase B, while each block still
stages all of h and computes more gate columns), in bf16 and f32 at B =
16 and 32; beside them the row-group kernel and the streaming kernel
(csrc/wavefront_fwd.cu) on the same inputs. Each case: one warm-up
launch, then two rounds of 3 launches (CUDA events), and its largest
difference from the plain twin over the four streams. Prints the card's
``name, power.limit``, then one JSON line per (dtype, B) with the grid
the default plan takes. These readings set ``SINGLE_LAYER_UNITS`` in
ops/wavefront.py, the units a block of that plan. Needs a CUDA device and nvcc; exits non-zero without
them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np

U, P = 760, 257
NBL = (132, 95, 64, 48, 38, 33, 24)


def k1_args(rng, B, T, cdt):
    """Seeded K1 inputs on the card (Glorot weights), every row at T."""
    import torch
    t = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()  # noqa: E731
    lim = np.sqrt(6.0 / (P + 4 * U))
    return (t(rng.normal(size=(T, B, 4 * U))).to(cdt),
            torch.full((B,), T, dtype=torch.int32, device="cuda"),
            t(rng.uniform(-lim, lim, (P, 4 * U))).to(cdt),
            t(rng.uniform(-lim, lim, (U, P))).to(cdt),
            t(rng.normal(0, 0.1, 4 * U)),
            *(t(rng.uniform(-0.1, 0.1, U)) for _ in range(3)))


def time_ms(fn, reps=3):
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--T", type=int, default=500)
    T = parser.parse_args(argv).T
    import torch
    if not torch.cuda.is_available():
        print("time_k1_plans: no CUDA device", file=sys.stderr)
        return 1
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    from rsrgan_tpu_torch.ops import resident
    from rsrgan_tpu_torch.ops import wavefront as wf
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    sms = resident.sm_count(torch.device("cuda"))
    rng = np.random.default_rng(0)
    for name in ("bfloat16", "float32"):
        cdt = getattr(torch, name)
        for B in (16, 32):
            args = k1_args(rng, B, T, cdt)
            want = ls.lstm_fwd_reference(*args)
            P_, G = args[2].shape
            stack = (args[2].new_empty((0, P_, G)), args[2][None],
                     args[3][None], args[4][None], args[5][None],
                     args[6][None], args[7][None])
            cases = {"rowgroup": lambda: ls._launch_fwd_rowgroup(
                         *args, save_acts=True),
                     "streaming": lambda: wf._launch(
                         args[0], args[1], args[0].new_zeros(
                             (T, B, P), dtype=torch.float32),
                         *stack, residual=False, save_acts=True)}
            for nbl in NBL:
                plan = wf.resident_plan(B, 1, U, P, cdt, sms, nbl=nbl)
                cases[f"nbl{plan.nbl}"] = (
                    lambda plan=plan: wf._launch_resident(
                        args[0], args[1], None, *stack, residual=False,
                        save_acts=True, plan=plan))
            times, errs = {c: [] for c in cases}, {}
            for c, fn in cases.items():
                got = fn()
                if c != "rowgroup":  # [L=1, T, B, *] streams
                    got = tuple(s[0] for s in got)
                errs[c] = max(float((g.float() - w.float()).abs().max())
                              for g, w in zip(got, want))
            torch.cuda.synchronize()
            for _ in range(2):
                for c, fn in cases.items():
                    times[c].append(time_ms(fn))
            print(json.dumps({
                "dtype": name, "B": B, "T": T, "U": U, "P": P,
                "default_nbl": wf.resident_plan(B, 1, U, P, cdt, sms).nbl,
                "ms": times, "max_abs_err": errs}), flush=True)
            del args, want
    return 0


if __name__ == "__main__":
    sys.exit(main())
