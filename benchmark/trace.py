"""The traced run: torch.profiler over the window (CPU and CUDA
activity, no stacks), the harness's spans as ``record_function`` ranges,
and the reduction of the trace to what the per-layer readers read.

Spans are named ``bench.<call>`` after the call into the program they
enclose; ``bench.window`` encloses the whole traced window and ends after
its closing sync. Events are read as ``(kind, name, start_us, dur_us)``
with ``kind`` one of ``kernel``, ``memcpy``, ``memset`` (the device's
rows), ``runtime`` (CUDA runtime and driver calls) and ``span``.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
from collections import Counter
from typing import Dict, List, Optional, Tuple

Event = Tuple[str, str, float, float]

WINDOW = "bench.window"
DEVICE_KINDS = ("kernel", "memcpy", "memset")
KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy",
         "gpu_memset": "memset", "cuda_runtime": "runtime",
         "cuda_driver": "runtime", "user_annotation": "span"}
LAUNCH = re.compile(r"^(cudaLaunch|cuLaunch)")
# the kernels of the program's csrc/*.cu
HAND_KERNELS = ("wavefront_resident_kernel", "lstm_fwd_rowgroup_kernel",
                "lstm_bwd_resident_kernel", "lstm_bwd_rowgroup_kernel",
                "lstm_wgrad_kernel", "wavefront_fwd_kernel",
                "lstm_bwd_kernel")
_HAND = re.compile(r"\b(" + "|".join(HAND_KERNELS) + r")\b")
TOP = 10


def is_hand_kernel(name: str) -> bool:
    return bool(_HAND.search(name))


class Tracer:
    """Spans for the harness's calls; a no-op unless ``active``."""

    def __init__(self, active: bool, device):
        self.active = active
        self.device = device
        self.prof = None

    def span(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    def start(self) -> None:
        if not self.active:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts, record_shapes=False,
                            with_stack=False, profile_memory=False)
        self.prof.__enter__()

    def stop(self) -> Optional[List[Event]]:
        if self.prof is None:
            return None
        self.prof.__exit__(None, None, None)
        events = read_events(self.prof)
        self.prof = None
        return events


def read_events(prof) -> List[Event]:
    """The profiler's events as ``Event`` tuples (µs), from its Chrome
    trace, written to a temporary file and removed (torch 2.11's Kineto
    events do not say their kind)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return [(KINDS[e["cat"]], e["name"], float(e["ts"]), float(e["dur"]))
            for e in events if e.get("ph") == "X" and e.get("cat") in KINDS]


def merge(intervals) -> List[List[float]]:
    """Sorted, merged [start, end] intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def analyse(events: List[Event]) -> dict:
    """The traced window's numbers: its length and the device's busy time
    (the union of its rows), device time by kernel name, launch calls,
    and the longest idle gaps, each named by the innermost harness span
    open at its middle. Times in seconds."""
    windows = [e for e in events if e[0] == "span" and e[1] == WINDOW]
    if len(windows) != 1:
        raise ValueError(f"{len(windows)} '{WINDOW}' spans in the trace")
    w0, w1 = windows[0][2], windows[0][2] + windows[0][3]
    device = [(max(s, w0), min(s + d, w1), name) for kind, name, s, d
              in events if kind in DEVICE_KINDS and s < w1 and s + d > w0]
    by_name: Counter = Counter()
    for s, e, name in device:
        by_name[name] += (e - s) / 1e6
    busy = merge((s, e) for s, e, _ in device)
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)
    spans = sorted((s, s + d, name) for kind, name, s, d in events
                   if kind == "span" and name != WINDOW)
    starts = [s for s, _, _ in spans]

    def open_span(t: float) -> str:
        inner, width = "outside any span", float("inf")
        for s, e, name in spans[:bisect.bisect_right(starts, t)]:
            if e >= t and e - s < width:
                inner, width = name, e - s
        return inner

    launches = sum(1 for kind, name, s, _ in events
                   if kind == "runtime" and w0 <= s <= w1
                   and LAUNCH.match(name))
    return {"window_s": (w1 - w0) / 1e6,
            "busy_s": sum(e - s for s, e in busy) / 1e6,
            "device_s_by_name": dict(by_name),
            "launches": launches,
            "gaps": [[open_span(t + g / 2), g / 1e6]
                     for g, t in gaps[:TOP]]}


def device_seconds(trace: dict, pattern: str) -> float:
    """Device seconds in the traced window of the rows whose name matches
    ``pattern``."""
    rx = re.compile(pattern)
    return sum(s for name, s in trace["device_s_by_name"].items()
               if rx.search(name))


def breakdown(trace: dict) -> Dict[str, list]:
    """The device rows that took most time and the longest idle gaps by
    the harness span open there."""
    ops = sorted(trace["device_s_by_name"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n, s] for n, s in ops[:TOP]],
            "idle_gaps": [list(g) for g in trace["gaps"][:TOP]]}
