"""Cells cut to run in seconds on the CPU, for the benchmark's tests."""

import copy
import time

import torch

from benchmark import harness
from benchmark.trace import Tracer


def tiny_cell(name: str, f32: bool = False, widths: bool = False,
              **limits) -> harness.Cell:
    """Cell ``name`` cut to run in seconds on the CPU: 8-wide inputs,
    4-wide targets (G's projection follows its input), 48 utterances of
    20-40 frames in batches of 2. The CLI's cell sizes stay (760 and
    256). ``f32``: the program in f32 (``--bf16=False``); ``widths``: the
    configuration's own widths, with the short corpus."""
    c = harness.cell(name)
    cfg = copy.deepcopy(c.config)
    cfg["cli"] = [f for f in cfg["cli"] if not f.startswith("--bf16")]
    cfg["cli"] += [f"--bf16={not f32}"]
    if not widths:
        cfg["generator"].update(input_dim=8, output_dim=4, num_proj=8)
        if "discriminator" in cfg:
            cfg["discriminator"]["input_dim"] = 4
        cfg["cli"] = [f for f in cfg["cli"] if not f.startswith(
            ("--input_dim", "--output_dim"))]
        cfg["cli"] += ["--input_dim=8", "--output_dim=4"]
    mix = dict(c.mix, utterances=48, min_frames=20, max_frames=40,
               batch_size=2)
    if "check_sample" in mix:
        mix["check_sample"] = 6
    workload = dict(c.workload, limits={**c.workload["limits"], **limits})
    return harness.Cell(name, c.entry, workload, cfg, mix)


def tiny_ctx(cell: harness.Cell, seed: int = 2 ** 31 + 7,
             seconds: float = 0.5, trace: bool = False) -> harness.Ctx:
    device = torch.device("cpu")
    return harness.Ctx(cell=cell, seed=seed, seconds=seconds,
                       tracer=Tracer(trace, device), device=device,
                       t0=time.monotonic())
