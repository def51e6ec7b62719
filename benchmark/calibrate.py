"""The readings that the limits of ``correct`` are set from: for each
seed, the numbers that the program's output reads against the plain
reference; for the control seeds, the numbers that the reference put in
the program's place in the precision below the configuration's (float8
e4m3 products) reads; for the fault seeds of a training cell, those that
the reference on half of each batch (the mean taken over the rest)
reads. One process, one seed after another, at the cell's own size; no
window. One JSON line a seed.

    python3 -m benchmark.calibrate --workload gan_b8 --seeds 1-12 \\
        --control 1-4 --fault 1-3
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time


def seeds(text: str):
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def readings(ctx, control: bool, fault: bool) -> dict:
    """One seed's readings (``Session`` of the cell's driver)."""
    from benchmark import harness
    s = harness.driver(ctx.cell.workload["driver"]).Session(ctx)
    s.warm()
    s.free()
    ref = s.reference()
    out = {"program": s.numbers(None, ref), "detail": s.detail(ref)}
    if control:
        out["control"] = s.numbers(s.reference("fp8"), ref)
    if fault:
        out.update({name: s.numbers(make(), ref)
                    for name, make in s.faults().items()})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, required=True)
    p.add_argument("--control", type=seeds, default=[])
    p.add_argument("--fault", type=seeds, default=[])
    args = p.parse_args(argv)
    import torch

    from benchmark import harness
    from benchmark.trace import Tracer
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.cell(args.workload)
    for seed in sorted(set(args.seeds) | set(args.control)
                       | set(args.fault)):
        t0 = time.monotonic()
        ctx = harness.Ctx(cell=cell, seed=seed, seconds=0.0,
                          tracer=Tracer(False, device), device=device, t0=t0)
        line = {"workload": cell.name, "seed": seed,
                **readings(ctx, seed in args.control, seed in args.fault),
                "seconds": time.monotonic() - t0}
        print(json.dumps(line), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
