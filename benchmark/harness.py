"""What every run shares: the manifest and a cell's files found by name,
the run's context, the metrics that apply to a cell, the check that no
module of JAX or of the JAX package is loaded, and the result line.

A cell ``<cell>`` of ``BENCHMARK.json`` names its configuration (whose
``file`` the manifest gives) and its traffic mix
(``benchmark/traffic/<traffic>.json``, whose ``generator`` names the
module that reads it, ``benchmark/traffic/<generator>.py``);
``benchmark/workloads/<cell>.json`` names the driver
(``benchmark/drivers/<driver>.py``) and the limits of the numbers that
decide ``correct``. A metric ``<name>`` is read by
``benchmark/metrics/<name>.py``'s ``read(run)``, which returns a number,
or None where the run has nothing for it to read.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that may not be loaded in a run: JAX and the
# JAX package the port was made from (compared whole: the port's own name
# begins with the latter's)
FORBIDDEN = ("jax", "jaxlib", "flax", "rsrgan_tpu")


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for ``stream`` of the run's ``seed``."""
    return int(np.random.SeedSequence([seed, stream]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict       # the manifest's workloads entry
    workload: dict    # workloads/<cell>.json
    config: dict      # the configuration's file
    mix: dict         # traffic/<traffic>.json


def cell(name: str, man: Optional[dict] = None, root: str = ROOT) -> Cell:
    """The cell ``name`` with its files, found by name."""
    man = manifest(root) if man is None else man
    entries = {w["name"]: w for w in man["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    configs = {c["name"]: c for c in man["configs"]}
    bench = os.path.join(root, "benchmark")
    return Cell(name=name, entry=entry,
                workload=read_json(os.path.join(bench, "workloads",
                                                f"{name}.json")),
                config=read_json(os.path.join(
                    root, configs[entry["config"]]["file"])),
                mix=read_json(os.path.join(bench, "traffic",
                                           f"{entry['traffic']}.json")))


@dataclasses.dataclass
class Ctx:
    """One run: the cell, ``--seed``, ``--seconds``, the tracer
    (``trace.Tracer``), the device, and the monotonic time the process
    started at (set-up runs from there to the window)."""
    cell: Cell
    seed: int
    seconds: float
    tracer: Any
    device: Any
    t0: float

    def span(self, name: str):
        return self.tracer.span(name)


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def reference(name: str):
    return importlib.import_module(f"benchmark.reference.{name}")


def generator(mix: dict):
    """The traffic generator that reads ``mix``:
    ``benchmark/traffic/<mix["generator"]>.py``."""
    return importlib.import_module(f"benchmark.traffic.{mix['generator']}")


def _thread_ticks() -> Dict[str, int]:
    """Each thread of the process (``name/tid``) and the clock ticks it
    has spent on a CPU (``/proc/self/task/*/stat``: user and system)."""
    out = {}
    try:
        tids = os.listdir("/proc/self/task")
    except OSError:
        return out
    for tid in tids:
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                text = f.read()
        except OSError:
            continue
        name = text[text.index("(") + 1:text.rindex(")")]
        fields = text[text.rindex(")") + 2:].split()
        out[f"{name}/{tid}"] = int(fields[11]) + int(fields[12])
    return out


def host_counters() -> dict:
    """What the host has given so far: the host clock, the CPU seconds
    of the process and of its main thread, and each thread's ticks."""
    return {"t": time.monotonic(), "process_s": time.process_time(),
            "main_s": time.thread_time(), "threads": _thread_ticks()}


def host_probe_ms(n: int = 1_000_000) -> float:
    """The host clock's ms of a fixed pure-Python loop: the speed of one
    of the host's cores for the interpreter's work."""
    t, x = time.perf_counter(), 0
    for i in range(n):
        x += i & 7
    return (time.perf_counter() - t) * 1e3


def host_share(before: dict, after: dict, work: int) -> dict:
    """The host over a window from two ``host_counters``: the main
    thread's CPU seconds as a share of the wall and in ms per unit of
    ``work`` (an iteration, a pass: the same work in every run of a
    cell), the whole process's CPU seconds over the wall (the cores it
    kept busy) and the three threads that took most CPU."""
    wall = after["t"] - before["t"]
    main = after["main_s"] - before["main_s"]
    tick = os.sysconf("SC_CLK_TCK")
    used = sorted(((n - before["threads"].get(k, 0)) / tick, k)
                  for k, n in after["threads"].items())[::-1]
    return {"wall_s": wall, "main_cpu_pct": 100.0 * main / wall,
            "main_cpu_ms_per_unit": 1e3 * main / max(1, work),
            "process_cores": (after["process_s"] - before["process_s"])
            / wall,
            "top_threads": " ".join(f"{k}={s:.2f}s" for s, k in used[:3])}


def metric_reader(name: str, root: str = ROOT):
    """``benchmark/metrics/<name>.py``'s ``read``."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_for(man: dict, cell_name: str, trace: bool) -> List[dict]:
    """The manifest's end-to-end metrics (per-layer with ``trace``) that
    a cell reports: those whose ``workloads`` list it, or that have
    none."""
    return [m for m in man["per_layer" if trace else "end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def read_metrics(man: dict, cell_name: str, trace: bool, run: dict,
                 root: str = ROOT) -> Dict[str, dict]:
    out = {}
    for m in metrics_for(man, cell_name, trace):
        value = metric_reader(m["name"], root)(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_loaded() -> List[str]:
    """The forbidden top-level names that ``sys.modules`` holds."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def check_lines(checks: List[dict]) -> List[str]:
    return [f"check {c['name']} = {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['ok'] else 'FAILED'}" for c in checks]


def result(run: dict, metrics: Dict[str, dict], device: dict) -> dict:
    """The result line, its compared numbers last."""
    out = {"correct": bool(run["checks"]) and all(
        c["ok"] for c in run["checks"]),
        "attempted": int(run["attempted"]), "failed": int(run["failed"]),
        "metrics": metrics, "device": device}
    if run.get("breakdown"):
        out["breakdown"] = run["breakdown"]
    # a number that is not finite (a row that never came) is written null
    out["checks"] = {c["name"]: {"value": c["value"] if math.isfinite(
        c["value"]) else None, "limit": c["limit"]} for c in run["checks"]}
    return out
