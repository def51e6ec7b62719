"""Data-pipeline throughput bench of the port's host side (numpy).

The counterpart of the repo's ``tools/io_bench.py`` on the port's
``data/`` codecs: the same corpus (seed 0, lengths in [0.6 F, F]), the
same stages and the same JSON line, frames/s of every stage of the host
pipeline:

  ark-plain     sequential float-ark decode (ScpReader)
  ark-bcm-np    compressed-ark decode (the numpy codec; the port has no
                native one, so there is no ark-bcm-c++ stage)
  store-build   scp -> .rtu store conversion
  store-scan    raw utterance reads from the mmap store
  batcher-0ctx  SequenceBatcher epoch at B=16, no splice (the flagship's)
  batcher       SequenceBatcher epoch (bucketed, padded, spliced x5)
  prefetch      ThreadedPrefetcher-wrapped batcher (overlap check)

    python3 -m rsrgan_tpu_torch.tools.io_bench [num_utts] [frames_per_utt]
        [--device=cuda|cpu]

Every stage runs on the host; ``--device`` (default ``cuda``) names the
machine's card, whose ``name, power.limit`` is printed first, and
``--device=cpu`` runs it where there is none.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from rsrgan_tpu_torch.data import (ArkWriter, ScpReader, SequenceBatcher,
                                   ThreadedPrefetcher, UtteranceStore,
                                   build_store_from_scp)
from rsrgan_tpu_torch.tools import card


def run(num_utts: int, frames: int) -> dict:
    """Every stage over a seeded corpus of ``num_utts`` utterances of
    0.6-1 x ``frames`` frames; prints a line a stage and returns
    {stage: frames/s}."""
    in_dim, out_dim = 257, 40
    rng = np.random.default_rng(0)
    results = {}

    def report(name, total_frames, dt, extra=""):
        rate = total_frames / dt
        results[name] = round(rate, 1)
        print(f"{name:12s} {dt:7.3f} s  {rate:12,.0f} frames/s  {extra}",
              flush=True)

    with tempfile.TemporaryDirectory() as d:
        lengths = rng.integers(int(0.6 * frames), frames + 1, num_utts)
        total = int(lengths.sum())
        mats_in = [rng.normal(size=(n, in_dim)).astype(np.float32) * 3
                   for n in lengths]
        mats_out = [rng.normal(size=(n, out_dim)).astype(np.float32)
                    for n in lengths]
        for name, mats, compress in (("in", mats_in, False),
                                     ("in_bcm", mats_in, True),
                                     ("out", mats_out, False)):
            with ArkWriter(os.path.join(d, f"{name}.scp"),
                           compress=compress) as w:
                for i, m in enumerate(mats):
                    w.write_next_utt(os.path.join(d, f"{name}.ark"),
                                     f"utt{i:05d}", m)

        for name, scp in (("ark-plain", "in.scp"),
                          ("ark-bcm-np", "in_bcm.scp")):
            t0 = time.perf_counter()
            for _ in ScpReader(os.path.join(d, scp)):
                pass
            report(name, total, time.perf_counter() - t0)

        store_path = os.path.join(d, "bench.rtu")
        t0 = time.perf_counter()
        build_store_from_scp(os.path.join(d, "in.scp"), store_path,
                             labels_scp=os.path.join(d, "out.scp"))
        report("store-build", total, time.perf_counter() - t0)

        store = UtteranceStore([store_path])
        t0 = time.perf_counter()
        for i in range(len(store)):
            store.inputs(i)
            store.labels(i)
        report("store-scan", total, time.perf_counter() - t0)

        flagship = SequenceBatcher(store, batch_size=16)
        t0 = time.perf_counter()
        got = sum(int(b.lengths.sum()) for b in flagship)
        report("batcher-0ctx", got, time.perf_counter() - t0,
               "(flagship: no splice)")

        batcher = SequenceBatcher(store, batch_size=16, left_context=2,
                                  right_context=2)
        t0 = time.perf_counter()
        got = sum(int(b.lengths.sum()) for b in batcher)
        report("batcher", got, time.perf_counter() - t0,
               "(spliced x5, bucketed+padded)")

        t0 = time.perf_counter()
        got = sum(int(b.lengths.sum())
                  for b in ThreadedPrefetcher(iter(batcher), capacity=8))
        report("prefetch", got, time.perf_counter() - t0)
    return results


def main(argv=None) -> int:
    from rsrgan_tpu_torch.device import resolve_device
    p = argparse.ArgumentParser(prog="rsrgan_tpu_torch.tools.io_bench",
                                description=__doc__.splitlines()[0])
    p.add_argument("num_utts", nargs="?", type=int, default=200)
    p.add_argument("frames_per_utt", nargs="?", type=int, default=400)
    card.add_device_flag(p)
    args = p.parse_args(argv)
    print(card.card_line(resolve_device(args.device)), flush=True)
    results = run(args.num_utts, args.frames_per_utt)
    print(json.dumps({"metric": "io_bench_frames_per_sec", **results}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
