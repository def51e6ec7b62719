"""K4's outputs and times at fixed seeded inputs, to hold two checkouts of
``csrc/resident.cu`` against each other on the card.

    python3 rsrgan_tpu_torch/tools/k4_bits.py --root DIR --save OUT.pt
    python3 rsrgan_tpu_torch/tools/k4_bits.py --root DIR --compare OUT.pt

Imports ``rsrgan_tpu_torch`` from the checkout at ``--root`` (default:
the one holding this file), so run it as a file, not with ``-m``. At
res_lstm_l's stack (L=4, U=760, P=257, residual) and --g_type=lstm's
(L=3, P=280, residual off), B=16, T=500, ragged rows, in f32 and bf16,
it runs the wavefront kernel's training forward (four streams) and its
decode forward (the top tap). ``--save`` writes every output to a file;
``--compare`` reads a file another checkout saved and says, per case,
whether every output is bit-equal to it. Both print the card's ``name,
power.limit`` and one JSON line per case with its ms (CUDA events, 5
launches after one warm-up). Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

B, T, U = 16, 500, 760
LENGTHS = [500, 497, 301, 150, 384, 411, 256, 199,
           420, 128, 333, 480, 275, 64, 448, 1]
STACKS = {"res_lstm_l": (4, 257, True), "lstm": (3, 280, False)}


def stack_args(seed, L, P, cdt):
    """Seeded wavefront arguments on the card (Glorot weights)."""
    import torch
    from rsrgan_tpu_torch.ops.wavefront_stack import _prep
    rng = np.random.default_rng(seed)

    def glorot(shape):
        lim = np.sqrt(6.0 / (shape[0] + shape[1]))
        return torch.from_numpy(
            rng.uniform(-lim, lim, shape).astype(np.float32)).cuda()

    params = [{"kernel": glorot((2 * P, 4 * U)),
               "bias": torch.from_numpy(
                   rng.normal(0, 0.1, 4 * U).astype(np.float32)).cuda(),
               "proj_kernel": glorot((U, P)), "w_i_diag": glorot((1, U)),
               "w_f_diag": glorot((1, U)), "w_o_diag": glorot((1, U))}
              for _ in range(L)]
    x = torch.from_numpy(
        rng.normal(size=(T, B, P)).astype(np.float32)).cuda()
    wx, wh, bias, proj, wi, wf, wo = _prep(params, P, 1.0)
    wx, wh, proj = (a.to(cdt).contiguous() for a in (wx, wh, proj))
    return (torch.matmul(x, wx[0].float()).to(cdt),
            torch.tensor(LENGTHS, dtype=torch.int32, device="cuda"), x,
            wx[1:].contiguous(), wh, proj, bias.contiguous(),
            wi.contiguous(), wf.contiguous(), wo.contiguous())


def time_ms(fn, reps=5):
    import torch
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--save")
    group.add_argument("--compare")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("k4_bits: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from rsrgan_tpu_torch.ops import wavefront as wf
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    outputs = {}
    want = torch.load(args.compare) if args.compare else None
    same = True
    for name, (L, P, residual) in STACKS.items():
        for dtype in ("float32", "bfloat16"):
            a = stack_args(L + P, L, P, getattr(torch, dtype))
            for mode, fn in (("train", wf.lstm_wavefront_fwd_train),
                             ("decode", wf.lstm_wavefront_fwd)):
                case = f"{name} {dtype} {mode}"
                run = lambda: fn(*a, residual=residual)  # noqa: E731
                got = run()
                got = [t.cpu() for t in (got if mode == "train" else (got,))]
                line = {"case": case, "module": wf.__file__,
                        "ms": time_ms(run)}
                if want is None:
                    outputs[case] = got
                else:
                    line["bit_equal"] = all(
                        torch.equal(g, w) for g, w in zip(got, want[case]))
                    same = same and line["bit_equal"]
                print(json.dumps(line), flush=True)
    if args.save:
        torch.save(outputs, args.save)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
