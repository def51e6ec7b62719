"""What the measurement tools (``io_bench``, ``kernel_bench``,
``profile_step``, ``serve_bench``) share: the run's device from
``--device`` (default ``cuda``; the CPU only when asked for), the card's
``name, power.limit`` line that each prints first, and a device sync."""

from __future__ import annotations

import argparse
import subprocess


def add_device_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; a missing card raises")


def card_line(device) -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``'s
    line for the run's card (its first line, or the line of ``device``'s
    index); on the CPU a line that says so."""
    if device.type != "cuda":
        return "cpu, no card (--device=cpu)"
    lines = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True).stdout.strip().splitlines()
    return lines[min(device.index or 0, len(lines) - 1)]


def sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the
    CPU)."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)
