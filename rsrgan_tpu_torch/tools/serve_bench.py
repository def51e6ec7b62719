"""Streaming-serving latency benchmark: per-chunk step latency
percentiles.

The counterpart of the repo's ``tools/serve_bench.py``: an online
dereverberation front-end has a latency budget (a chunk of C frames
covers C * 10 ms of audio, so the p99 step latency must stay under it
to hold realtime). This tool times ``serving.StreamingEnhancer.step``
(the step ``cli/serve.py`` and the ``StreamPool`` run) on res_lstm_l at
full width, a seeded bf16 generator's parameters, over ``num_chunks``
chunks of a seeded device-resident input, and prints the card's
``name, power.limit``, then one JSON line per (lanes, chunk_frames): 1,
8, 32, 64 lanes by 10 and 50 frames.

    python3 -m rsrgan_tpu_torch.tools.serve_bench [num_chunks]
        [--device=cuda|cpu]

Each synced step is timed on the host clock to its
``torch.cuda.synchronize()`` (p50/p95/p99); ``pipelined_mean`` is
``num_chunks`` steps with one sync at the end. The streaming step is the
eager cell (every product one step's shape, so chunk sizes give the same
bits): it launches no hand kernel, only PyTorch's own, one set a frame
and layer (ROADMAP S9).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from rsrgan_tpu_torch.tools import card

IN_DIM, OUT_DIM = 257, 40
FRAME_MS = 10.0
LANES = (1, 8, 32, 64)
CHUNK_FRAMES = (10, 50)


def bench(enhancer, lanes: int, chunk_frames: int, num_chunks: int) -> dict:
    """The JAX tool's ``bench`` on the port's ``StreamingEnhancer``."""
    rng = np.random.default_rng(0)
    device = enhancer.device
    chunk = torch.from_numpy(rng.normal(
        size=(lanes, chunk_frames, IN_DIM)).astype(np.float32)).to(device)
    state = enhancer.init_state(batch=lanes)
    # warm-up: the first dispatch
    y, state = enhancer.step(chunk, state)
    card.sync(device)

    lat_ms = []
    for _ in range(num_chunks):
        t0 = time.perf_counter()
        y, state = enhancer.step(chunk, state)
        card.sync(device)
        lat_ms.append((time.perf_counter() - t0) * 1e3)

    # pipelined aggregate: queue all chunks, sync once at the end
    t0 = time.perf_counter()
    for _ in range(num_chunks):
        y, state = enhancer.step(chunk, state)
    card.sync(device)
    pipelined_ms = (time.perf_counter() - t0) * 1e3 / num_chunks

    lat = np.asarray(lat_ms)
    budget_ms = chunk_frames * FRAME_MS
    return {
        "metric": "stream_step_latency_ms",
        "lanes": lanes,
        "chunk_frames": chunk_frames,
        "chunk_audio_ms": budget_ms,
        "p50": round(float(np.percentile(lat, 50)), 3),
        "p95": round(float(np.percentile(lat, 95)), 3),
        "p99": round(float(np.percentile(lat, 99)), 3),
        "pipelined_mean": round(pipelined_ms, 3),
        "realtime_p99": bool(np.percentile(lat, 99) < budget_ms),
        "frames_per_sec_synced": round(
            lanes * chunk_frames / (lat.mean() * 1e-3)),
    }


def flagship_enhancer(device):
    """res_lstm_l at full width, a seeded bf16 generator's parameters."""
    from rsrgan_tpu_torch.models import get_generator
    from rsrgan_tpu_torch.models.bridge import module_tree
    from rsrgan_tpu_torch.serving import StreamingEnhancer
    gen = get_generator("res_lstm_l", input_dim=IN_DIM, output_dim=OUT_DIM,
                        compute_dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0))
    return StreamingEnhancer(module_tree(gen), variant="res_lstm_l",
                             device=device)


def main(argv=None) -> int:
    from rsrgan_tpu_torch.device import resolve_device
    p = argparse.ArgumentParser(prog="rsrgan_tpu_torch.tools.serve_bench",
                                description=__doc__.splitlines()[0])
    p.add_argument("num_chunks", nargs="?", type=int, default=100)
    card.add_device_flag(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    print(card.card_line(device), flush=True)
    enhancer = flagship_enhancer(device)
    for lanes in LANES:
        for chunk_frames in CHUNK_FRAMES:
            print(json.dumps(bench(enhancer, lanes, chunk_frames,
                                   args.num_chunks)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
