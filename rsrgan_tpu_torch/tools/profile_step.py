"""Profile the flagship training step with torch.profiler and print the
device-time breakdown and the host side, from the trace's Chrome JSON.

The counterpart of the repo's ``tools/profile_step.py``: STEPS=10
``GanTrainer.train_step`` calls (1 D + 2 G, res_lstm_l G and LSTM-D on
the wavefront, bf16, built as ``bench.py`` builds it) at ``[B] [T]``
(default 16, 500), lengths drawn in [0.8T, T], after one warm-up step;
first timed without the profiler, then under it (CPU and CUDA activity,
``with_stack=True``), each step inside a ``profile_step#i`` range and
ended by a sync. The report, of the profiled steps:

- per kernel name (device rows: kernels, copies, sets), total ms and
  calls, largest first;
- the per-step category rollup: each hand kernel of ``csrc/*.cu`` by
  name, cuBLAS products, copies/slices, reductions (loss/clip/EMA),
  other elementwise/glue;
- the host side: wall ms per step with and without the profiler, the
  device's busy ms and share, CUDA launch calls and device rows per
  step, the longest idle gaps of the device (with the ``rsrgan_tpu_torch``
  function each thread was in at each gap's middle), and host ms per
  step by the ``rsrgan_tpu_torch`` module and function on the profiler's
  Python stack (each instant to the innermost such frame; frames of
  threads other than the main one, autograd's, marked so), with the
  launch calls and the runtime calls that wait for the device (copies
  from pageable memory, synchronizes) summed apart, and the self time of
  the program's spans (``rsrgan_tpu_torch/spans.py``, in the trace as
  ``record_function`` ranges) of the kernels' host side (``launch.pack``
  the weight packing, ``launch.plan`` the plans, ``launch.upload`` the
  blocking uploads, ``launch.call`` the launch setup), of the optimizer
  (``opt.*``) and of the feed (``feed.*``), and beside them the share of
  the launches' device constants (unit index, bounds, rows) the profiled
  steps reused (``launch.setup_hit`` against ``launch.setup_miss``, from
  the program's counters; after the warm-up step every launch reuses
  its shape's). ``with_stack`` slows the
  host's Python (more so in Python-heavy code), so the profiled wall
  time is longer than the unprofiled one printed beside it.

    python3 -m rsrgan_tpu_torch.tools.profile_step [B] [T]
        [--out=TRACE.json] [--device=cuda|cpu]
    python3 -m rsrgan_tpu_torch.tools.profile_step --trace PATH [STEPS]
        (re-reads a saved Chrome trace, no device)

The trace is kept (``--out``, default ``rsrgan_profile/profile_step.json``
under the temporary directory, as the JAX tool keeps its own). Prints
the card's ``name, power.limit`` first (not with ``--trace``), the JAX
tool's text lines, then one JSON line ``{"metric": "profile_step",
...}`` with the numbers.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

# the kernels of csrc/resident.cu, csrc/wavefront_fwd.cu, csrc/lstm_bwd.cu
# and csrc/optim.cu
HAND_KERNELS = ("wavefront_resident_kernel", "lstm_fwd_rowgroup_kernel",
                "lstm_bwd_resident_kernel", "lstm_bwd_rowgroup_kernel",
                "lstm_wgrad_kernel", "wavefront_fwd_kernel",
                "lstm_bwd_kernel", "sumsq_kernel", "update_kernel")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CALLS = re.compile(r"^(cudaLaunch|cuLaunch)")
# runtime calls that return only when the device (or a copy from pageable
# memory behind the queued work) is done: the host waiting
WAIT_CALLS = re.compile(r"^(cudaMemcpy|cuMemcpy|cudaStreamSynchronize|"
                        r"cudaDeviceSynchronize|cudaEventSynchronize)")
OTHER_THREAD = " [other thread]"
STEPS = 10
STEP_RANGE = "profile_step#"
# "rsrgan_tpu_torch/ops/lstm_seq.py(341): lstm_fwd", whatever prefix the
# profiler keeps of the path
PORT_FRAME = re.compile(r"rsrgan_tpu_torch/([\w/]+\.py)\(\d+\): (.+)$")
COPY_OPS = ("aten::copy_", "aten::to", "aten::_to_copy", "aten::clone",
            "aten::contiguous")
TOP_KERNELS = 60
TOP_GAPS = 10
TOP_FUNCTIONS = 25


def categorize(name: str, cat: str) -> str:
    """A device row's category in the per-step rollup."""
    if cat != "kernel":
        return "copies/slices"
    for k in HAND_KERNELS:
        if re.search(rf"\b{k}\b", name):
            return f"hand kernel {k}"
    low = name.lower()
    if any(s in low for s in ("gemm", "gemv", "cutlass", "xmma", "cublas",
                              "nvjet", "splitkreduce")):
        return "cuBLAS products"
    if any(s in low for s in ("copy", "cat", "index", "slice", "gather",
                              "scatter", "fill", "transpose", "flip")):
        return "copies/slices"
    if "reduce" in low:
        return "reductions (loss/clip/EMA)"
    return "other elementwise/glue"


def merge(intervals) -> List[List[float]]:
    """Sorted, merged [start, end] intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def thread_frames(events, w0: float, w1: float, key) -> Dict[int, list]:
    """Per thread, the events that ``key`` names (it returns a name or
    None) cut to the window [w0, w1], as ``nest`` gives them."""
    by_tid = collections.defaultdict(list)
    for e in events:
        k = key(e)
        s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if k is not None and t > s:
            by_tid[e["tid"]].append([s, t, k, t - s])
    return nest(by_tid)


def port_key(e: dict) -> Optional[str]:
    """``module.py:function`` of an ``rsrgan_tpu_torch`` Python frame."""
    m = (PORT_FRAME.search(e["name"])
         if e.get("cat") == "python_function" else None)
    return f"{m.group(1)}:{m.group(2)}" if m else None


def span_key(e: dict) -> Optional[str]:
    """The name of one of the program's spans (a ``record_function``
    range that is not a step's own)."""
    if (e.get("cat") == "user_annotation"
            and not e["name"].startswith(STEP_RANGE)):
        return e["name"]
    return None


def nest(by_tid: Dict[int, list]) -> Dict[int, list]:
    """Each thread's [start, end, key, exclusive µs] frames sorted by
    start (outer before inner at a tie); each frame's exclusive time is
    its duration less that of the frames directly inside it."""
    for frames in by_tid.values():
        frames.sort(key=lambda f: (f[0], -f[1]))
        stack: list = []
        for f in frames:
            while stack and stack[-1][1] <= f[0]:
                stack.pop()
            if stack:
                stack[-1][3] -= f[1] - f[0]
            stack.append(f)
    return by_tid


def innermost(frames, t: float) -> Optional[str]:
    """The innermost frame of a thread's sorted ``frames`` that holds
    instant ``t``."""
    best = None
    for f in frames:
        if f[0] > t:
            break
        if f[1] >= t:
            best = f[2]
    return best


def analyse(events: List[dict], steps: int) -> dict:
    """The report's numbers from a trace's complete ("X") events."""
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"].startswith(STEP_RANGE)]
    host = [e for e in events if e.get("cat") not in DEVICE_CATS]
    span = ranges or host
    w0 = min(e["ts"] for e in span)
    w1 = max(e["ts"] + e["dur"] for e in span)
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    per_name = collections.Counter()
    calls = collections.Counter()
    cats = collections.Counter()
    for e in device:
        per_name[e["name"]] += e["dur"]
        calls[e["name"]] += 1
        cats[categorize(e["name"], e["cat"])] += e["dur"]
    busy = merge((max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                 for e in device)
    busy_us = sum(e - s for s, e in busy)
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    gaps = [(edges[i], edges[i + 1] - edges[i])
            for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: -g[1])

    frames = thread_frames(host, w0, w1, port_key)
    main_tid = (ranges[0]["tid"] if ranges
                else max(frames, key=lambda t: len(frames[t]))
                if frames else None)
    # the main thread first; the others (autograd's device threads) keep
    # their frames apart: the main thread waits inside backward() while
    # they run it
    tids = [main_tid] + [t for t in frames if t != main_tid]
    by_function = collections.Counter()
    for tid in tids:
        for f in frames.get(tid, []):
            by_function[f[2] + ("" if tid == main_tid else OTHER_THREAD)] \
                += f[3]

    def host_at(t: float) -> List[str]:
        return [k + ("" if tid == main_tid else OTHER_THREAD)
                for tid in tids if (k := innermost(frames.get(tid, []), t))]

    own = collections.Counter()   # the spans' self µs over the threads
    for tid_frames in thread_frames(host, w0, w1, span_key).values():
        for f in tid_frames:
            own[f[2]] += f[3]

    def self_ms(prefix: str) -> float:
        return per_step(sum(us for name, us in own.items()
                            if name.startswith(prefix)))

    launches = [e for e in host if LAUNCH_CALLS.match(e["name"])
                and w0 <= e["ts"] < w1]
    waits = [e for e in host if WAIT_CALLS.match(e["name"])
             and w0 <= e["ts"] < w1]
    ops = sorted((e for e in host if e.get("cat") == "cpu_op"
                  and w0 <= e["ts"] < w1), key=lambda e: (e["tid"], e["ts"],
                                                          -e["dur"]))
    top_ops, end, tid = [], -1.0, None
    for e in ops:   # the ops no other op holds
        if e["tid"] != tid:
            tid, end = e["tid"], -1.0
        if e["ts"] >= end:
            top_ops.append(e)
            end = e["ts"] + e["dur"]
    per_step = lambda us: us / 1e3 / steps  # noqa: E731
    wall = per_step(w1 - w0)
    return {
        "steps": steps,
        "step_ranges": len(ranges),
        "kernels": [{"name": n, "ms": per_name[n] / 1e3, "calls": calls[n]}
                    for n, _ in per_name.most_common()],
        "rollup_ms_per_step": {c: per_step(us)
                               for c, us in cats.most_common()},
        "device_rows_ms_per_step": per_step(sum(cats.values())),
        "wall_ms_per_step": wall,
        "device_busy_ms_per_step": per_step(busy_us),
        "device_busy_share": per_step(busy_us) / wall if wall else None,
        "launch_calls_per_step": len(launches) / steps,
        "device_rows_per_step": len(device) / steps,
        "idle_gaps": [{"at_ms": (s - w0) / 1e3, "ms": d / 1e3,
                       "host_in": host_at(s + d / 2)}
                      for s, d in gaps[:TOP_GAPS]],
        "idle_ms_per_step": per_step(sum(d for _, d in gaps)),
        "host_ms_per_step_by_function": {
            k: per_step(us) for k, us in by_function.most_common()
            if us > 0},
        "host_split_ms_per_step": {
            "launch calls": per_step(sum(e["dur"] for e in launches)),
            "waits for the device (cudaMemcpy*, *Synchronize)": per_step(
                sum(e["dur"] for e in waits)),
            "weight packing (launch.pack)": self_ms("launch.pack"),
            "plans (launch.plan)": self_ms("launch.plan"),
            "uploads (launch.upload)": self_ms("launch.upload"),
            "launch setup (launch.call)": self_ms("launch.call"),
            "optimizer (opt.*)": self_ms("opt."),
            "feed (feed.*)": self_ms("feed."),
            "top-level aten ops": per_step(sum(e["dur"] for e in top_ops)),
            "copies (top-level aten::copy_/to/clone/contiguous)": per_step(
                sum(e["dur"] for e in top_ops if e["name"] in COPY_OPS)),
        },
    }


def load_events(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def report(trace_path: str, steps: int, extra: Optional[dict] = None
           ) -> dict:
    """Print the breakdown of a saved Chrome trace and its JSON line;
    return the JSON line's dict."""
    out = analyse(load_events(trace_path), steps)
    out.update(extra or {})
    print("=== plane: device (kernels, copies, sets) ===")
    total = sum(k["ms"] for k in out["kernels"])
    print(f"-- line 'device rows': {total:.3f} ms total")
    for k in out["kernels"][:TOP_KERNELS]:
        print(f"   {k['ms']:9.3f} ms  x{k['calls']:5d}  {k['name'][:90]}")
    print(f"-- per-step category rollup ({steps} steps, "
          f"{out['device_rows_ms_per_step']:.2f} ms/step inside ops):")
    rows = out["device_rows_ms_per_step"] or 1.0
    for cat, ms in out["rollup_ms_per_step"].items():
        print(f"   {ms:8.3f} ms/step ({100 * ms / rows:4.1f}%)  {cat}")
    print(f"-- host side: wall {out['wall_ms_per_step']:.2f} ms/step "
          f"(without the profiler: "
          f"{out.get('unprofiled_wall_ms_per_step', float('nan')):.2f}), "
          f"device busy {out['device_busy_ms_per_step']:.2f} ms/step "
          f"({100 * (out['device_busy_share'] or 0):.1f}%), "
          f"{out['launch_calls_per_step']:.1f} launch calls and "
          f"{out['device_rows_per_step']:.1f} device rows a step")
    for g in out["idle_gaps"]:
        print(f"   idle {g['ms']:8.3f} ms at {g['at_ms']:9.3f} ms  "
              f"host in {', '.join(g['host_in'])}")
    print("-- host ms/step by rsrgan_tpu_torch function (innermost frame):")
    for k, ms in list(out["host_ms_per_step_by_function"].items()
                      )[:TOP_FUNCTIONS]:
        print(f"   {ms:8.3f} ms/step  {k}")
    for k, ms in out["host_split_ms_per_step"].items():
        print(f"   {ms:8.3f} ms/step  {k}")
        if k.endswith("(launch.call)") and out.get("launch_setup_hit_share"
                                                   ) is not None:
            print(f"   {out['launch_setup_hit_share']:8.4f} share of the "
                  f"launches' device constants reused (launch.setup_hit: "
                  f"{out['launch_setup_hits']} hits, "
                  f"{out['launch_setup_misses']} misses)")
    line = {"metric": "profile_step", "trace": trace_path,
            **{k: v for k, v in out.items() if k != "kernels"},
            "kernels": out["kernels"][:TOP_KERNELS]}
    print(json.dumps(line), flush=True)
    return line


def profile(B: int, T: int, steps: int, device, trace_path: str) -> dict:
    """Warm up, time ``steps`` steps, profile ``steps`` more into
    ``trace_path``; the unprofiled wall ms per step."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    from rsrgan_tpu_torch import spans
    from rsrgan_tpu_torch.tools import card
    from rsrgan_tpu_torch.tools.kernel_bench import (D_SIZES, G_SIZES,
                                                     HPARAMS,
                                                     flagship_trainer,
                                                     make_params)
    rng = np.random.default_rng(0)
    trainer = flagship_trainer(make_params(rng, **G_SIZES),
                               make_params(rng, **D_SIZES), device)
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    x = to(rng.normal(size=(B, T, 257)).astype(np.float32))
    y = to(rng.normal(size=(B, T, 40)).astype(np.float32))
    lengths = to(rng.integers(int(0.8 * T), T + 1, (B,)).astype(np.int32))
    state = trainer.init_state()
    noise = torch.Generator(device=device).manual_seed(1)

    def step():
        m = trainer.train_step(state, x, y, lengths, HPARAMS, noise)
        float(m["g_loss"])

    step()   # warm-up: the kernels' libraries, cuBLAS handles
    card.sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    unprofiled = (time.perf_counter() - t0) * 1e3 / steps
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    spans.clear()
    with torch.profiler.profile(activities=activities,
                                with_stack=True) as prof:
        for i in range(steps):
            with record_function(f"{STEP_RANGE}{i}"):
                step()
    prof.export_chrome_trace(trace_path)
    counts = spans.read()
    spans.clear()
    hits, misses = (counts.total(f"launch.setup_{k}") for k in ("hit", "miss"))
    return {"B": B, "T": T, "true_frames": int(lengths.sum()),
            "unprofiled_wall_ms_per_step": unprofiled,
            "launch_setup_hits": hits, "launch_setup_misses": misses,
            "launch_setup_hit_share": (hits / (hits + misses)
                                       if hits + misses else None)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rsrgan_tpu_torch.tools.profile_step",
                                description=__doc__.splitlines()[0])
    p.add_argument("sizes", nargs="*", type=int,
                   help="B T (default 16 500); with --trace: STEPS")
    p.add_argument("--trace", default=None,
                   help="re-read this Chrome trace; no device run")
    p.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "rsrgan_profile", "profile_step.json"),
                   help="where the trace is written")
    from rsrgan_tpu_torch.tools import card
    card.add_device_flag(p)
    args = p.parse_args(argv)
    if args.trace:
        report(args.trace, steps=args.sizes[0] if args.sizes else STEPS)
        return 0
    from rsrgan_tpu_torch.device import resolve_device
    device = resolve_device(args.device)
    print(card.card_line(device), flush=True)
    B, T = (list(args.sizes) + [16, 500][len(args.sizes):])[:2]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    report(args.out, STEPS, profile(B, T, STEPS, device, args.out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
