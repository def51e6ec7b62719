"""K3 at G's width on both of its G-width routes, timed side by side.

    python3 -m rsrgan_tpu_torch.tools.time_k3_routes [--T 500]

At U=760, P=257 (res_lstm_l's layers), every row at full length, times
K2's resident walk in acc mode with its reduction
(``_launch_bwd_resident_acc``) and csrc/lstm_bwd.cu (``_launch_bwd``,
``acc=1``) on the same seeded inputs, f32 at B = 32..128 and bf16 at B =
32..256, wherever the resident plan fits. Each route: one warm-up launch,
then two rounds of 3 launches (CUDA events), the routes alternating. Prints
the card's ``name, power.limit``, then one JSON line per (dtype, B) with
both routes' times and the route ``bwd_acc_route`` names. These readings
set ``RESIDENT_F32_MAX_ROWS`` in ops/lstm_seq.py. Needs a CUDA device and
nvcc; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np

U, P = 760, 257
BATCHES = {"float32": (32, 40, 48, 56, 64, 96, 128),
           "bfloat16": (32, 64, 128, 256)}


def k3_args(rng, B, T, cdt):
    """Seeded K3 inputs on the card, every row at length T."""
    import torch
    t = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()  # noqa: E731
    lim = np.sqrt(6.0 / (P + 4 * U))
    return (t(rng.uniform(0, 1, (T, B, 4 * U))).to(cdt),
            torch.full((B,), T, dtype=torch.int32, device="cuda"),
            t(rng.normal(size=(T, B, P))), t(rng.normal(size=(T, B, U))),
            t(rng.normal(size=(T, B, P))),
            t(rng.uniform(-lim, lim, (P, 4 * U))).to(cdt),
            t(rng.uniform(-lim, lim, (U, P))).to(cdt),
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
        print("time_k3_routes: no CUDA device", file=sys.stderr)
        return 1
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    from rsrgan_tpu_torch.ops import resident
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    sms = resident.sm_count(torch.device("cuda"))
    rng = np.random.default_rng(0)
    for name, batches in BATCHES.items():
        cdt = getattr(torch, name)
        for B in batches:
            args = k3_args(rng, B, T, cdt)
            routes = {"streaming": lambda: ls._launch_bwd(*args, acc=True)}
            try:
                ls.resident_plan(B, U, P, cdt, sms, acc=True)
                routes["resident"] = lambda: ls._launch_bwd_resident_acc(
                    *args)
            except ValueError:
                pass
            times = {r: [] for r in routes}
            for fn in routes.values():
                fn()
            torch.cuda.synchronize()
            for _ in range(2):
                for r, fn in routes.items():
                    times[r].append(time_ms(fn))
            print(json.dumps({"dtype": name, "B": B, "T": T, "U": U, "P": P,
                              "route": ls.bwd_acc_route(B, U, P, cdt, sms),
                              **{f"{r}_ms": v for r, v in times.items()}}),
                  flush=True)
            del args
    return 0


if __name__ == "__main__":
    sys.exit(main())
