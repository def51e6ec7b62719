"""Run one cell of BENCHMARK.json and print its result as the last line
of standard output.

    python3 -m benchmark.run --workload gan_b8 --seed 123 --seconds 30 \\
        --trace 0

Set-up (imports, the card, the program's kernels, weights and inputs
made from ``--seed``, the checked first iterations, every shape warmed)
is timed from the process's start to the window's. The window then runs
``--seconds`` of the cell's traffic; with ``--trace 1`` it runs at
most ``TRACE_SECONDS``, the same work runs again under the profiler, and
the per-layer metrics are reported (those of time against the host
clock from the untraced window, since the profiler slows the host).
After the window the program's outputs are compared with the plain
reference (``check.py``), each number beside its limit as the last
lines of standard error and under ``checks`` in the result.

Exits 2, printing no result, where there is no card or too few, and 3
where a module of JAX or of the JAX package was loaded.
"""

import time

T0 = time.monotonic()  # noqa: E402  (set-up is timed from here)

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

TRACE_SECONDS = 10.0


def parse(argv=None):
    p = argparse.ArgumentParser(prog="benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_line() -> str:
    """The card's name and power limit (the limit bounds its speed), and
    its SM clock, the most it may take, its temperature and its draw."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
         "clocks.max.sm,temperature.gpu,power.draw", "--format=csv,noheader",
         "--id=0"], capture_output=True, text=True)
    return "card: " + (proc.stdout.strip() or "nvidia-smi gave nothing")


def window_lines(run: dict) -> list:
    """What the window held: its seconds and work, for training the
    median and mean iteration; what the host gave it (``harness.
    host_share``, and the probe's ms after it); in a traced run, how far
    the profiler stretched the same work."""
    text = (f"window: {run['window_s']:.3f} s, {run['attempted']} "
            f"attempted, {run['frames']} frames")
    if run.get("iter_ms"):
        ms = sorted(run["iter_ms"])
        text += (f", iteration median {ms[len(ms) // 2]:.2f} ms, mean "
                 f"{sum(ms) / len(ms):.2f} ms")
    host = ", ".join(f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in run["host"].items())
    lines = [text, f"host: {host}, probe_ms {run['probe_ms']:.6g}"]
    traced = run.get("traced")
    if traced:
        work = traced.get("iterations", traced.get("passes"))
        lines.append(
            f"traced: {traced['window_s']:.3f} s for {work} of the "
            f"window's units, which it ran in {traced['paced_s']:.3f} s: "
            f"stretched {traced['window_s'] / traced['paced_s']:.4f}x; "
            f"device busy {run['trace']['busy_s']:.3f} s")
    return lines


def execute(man: dict, cell, seed: int, seconds: float, trace: bool,
            device, t0: float):
    """The run after the look for a card: ``(exit code, result line or
    None, lines for standard error)``."""
    import torch

    from benchmark import harness
    from benchmark.trace import Tracer

    if trace:
        seconds = min(seconds, TRACE_SECONDS)
    ctx = harness.Ctx(cell=cell, seed=seed, seconds=seconds,
                      tracer=Tracer(trace, device), device=device, t0=t0)
    run = harness.driver(cell.workload["driver"]).run(ctx)
    loaded = harness.forbidden_loaded()
    if loaded:
        return 3, None, [f"benchmark: forbidden modules loaded: {loaded}"]
    metrics = harness.read_metrics(man, cell.name, trace, run)
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(cell.entry["chips"]),
           "memory_peak_bytes": int(run["memory_peak_bytes"])}
    if trace:
        dev["busy_s"] = run["trace"]["busy_s"]
        dev["window_s"] = run["trace"]["window_s"]
    lines = ([card_line()] if cuda else []) + window_lines(run)
    return 0, harness.result(run, metrics, dev), \
        lines + harness.check_lines(run["checks"])


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from benchmark import harness

    man = harness.manifest()
    cell = harness.cell(args.workload, man)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    rc, line, lines = execute(man, cell, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0), T0)
    for text in lines:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    if line is not None:
        print(json.dumps(line), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
