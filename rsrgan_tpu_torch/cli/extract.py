"""Feature extraction CLI of the port (``rsrgan_tpu/cli/extract.py``):
Kaldi's ``compute-spectrogram-feats`` (257-dim LPS),
``compute-mfcc-feats --config=mfcc_hires.conf`` (40-dim MFCC) and
``compute-cmvn-stats``, computed on the card:

    python -m rsrgan_tpu_torch.cli.extract --wav_scp wav.scp \\
        --feat_type spectrogram --output_dir feats --name inputs \\
        [--accumulate_cmvn] [--device cuda]

Writes ``<name>.ark`` / ``<name>.scp`` and optionally ``<name>.cmvn``
(Kaldi binary stats), in corpus order, for the prepare and train CLIs or
Kaldi itself. The JAX CLI's flags, plus ``--device`` (default ``cuda``;
without a card it raises unless ``--device=cpu`` is given).

Waves are bucketed by their padded length (``FRAME_PAD`` frames); each
bucket of ``--batch_size`` waves is one ``[rows, samples]`` pass on the
device, cut back to each wave's frame count. Dither comes from one
``torch.Generator`` on the device per utterance, seeded
``--dither_seed`` + its index, so ``--batch_size=1`` and any other batch
give the same bits on one device. The JAX package draws it from
``jax.random``, which torch cannot reproduce: the two agree at
``--dither=0``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from rsrgan_tpu_torch.cli import resolve_device, set_precision
from rsrgan_tpu_torch.data.cmvn import CmvnAccumulator, write_kaldi_cmvn
from rsrgan_tpu_torch.data.kaldi_ark import ArkWriter
from rsrgan_tpu_torch.features.frontend import (FrameOptions,
                                                SpectrogramOptions,
                                                compute_spectrogram,
                                                num_frames,
                                                seeded_generators)
from rsrgan_tpu_torch.features.mfcc import MfccOptions, compute_mfcc
from rsrgan_tpu_torch.sim.wavio import read_wav

FRAME_PAD = 200  # waves padded to multiples of 2 s of frames: the buckets


def padded_samples(n_frames: int, opts: FrameOptions) -> int:
    """Samples of a wave padded to the next FRAME_PAD multiple of frames.

    The zero padding reaches only frames past ``n_frames`` under
    snip_edges=True, the extraction's default, which this CLI never
    changes; with reflection (snip_edges=False) it would change the last
    frames, so bucketing requires snip_edges."""
    if not opts.snip_edges:
        raise ValueError("bucketing pads with zeros: snip_edges only")
    pad_frames = -(-n_frames // FRAME_PAD) * FRAME_PAD
    return opts.window_size + opts.window_shift * (pad_frames - 1)


class BatchedExtractor:
    """Stacks waves of one padded length into ``[rows, samples]`` and
    extracts each stack in one pass on ``device`` once it holds ``batch``
    waves (``flush_all`` for the rest). Results come back as (ticket,
    feats) pairs as their bucket completes; the caller reorders."""

    def __init__(self, feat_type: str, frame_opts: FrameOptions,
                 use_dither: bool, batch: int, device: torch.device):
        self.feat_type = feat_type
        self.frame_opts = frame_opts
        self.use_dither = use_dither
        self.batch = batch
        self.device = device
        self.dim = 257 if feat_type == "spectrogram" else 40
        self.frames = 0           # true frames extracted
        self.device_secs = 0.0    # wall time of the passes
        self._bufs = {}  # padded_samples -> [(ticket, wave, n_frames, seed)]

    def _compute(self, stack: torch.Tensor, seeds) -> torch.Tensor:
        gens = (seeded_generators(seeds, self.device)
                if self.use_dither else None)
        if self.feat_type == "spectrogram":
            return compute_spectrogram(
                stack, SpectrogramOptions(self.frame_opts), gens)
        return compute_mfcc(stack, MfccOptions(frame_opts=self.frame_opts),
                            gens)

    def add(self, ticket: int, wave: np.ndarray, seed: int):
        """Queue one wave; returns [(ticket, feats)] completed by this add."""
        n_frames = num_frames(len(wave), self.frame_opts)
        if n_frames == 0:
            return [(ticket, np.zeros((0, self.dim), np.float32))]
        n_pad = padded_samples(n_frames, self.frame_opts)
        padded = np.zeros(n_pad, np.float32)
        # samples past the last kept frame's span feed no frame
        n_copy = min(len(wave), n_pad)
        padded[:n_copy] = wave[:n_copy]
        buf = self._bufs.setdefault(n_pad, [])
        buf.append((ticket, padded, n_frames, seed))
        if len(buf) == self.batch:
            return self._flush(n_pad)
        return []

    def _flush(self, key):
        entries = self._bufs.pop(key, [])
        if not entries:
            return []
        t0 = time.monotonic()
        stack = torch.from_numpy(np.stack([e[1] for e in entries]))
        out = self._compute(stack.to(self.device),
                            [e[3] for e in entries]).cpu().numpy()
        self.device_secs += time.monotonic() - t0
        self.frames += sum(e[2] for e in entries)
        return [(t, out[i, :nf].copy())
                for i, (t, _, nf, _) in enumerate(entries)]

    def flush_all(self):
        done = []
        for key in sorted(self._bufs):
            done.extend(self._flush(key))
        return done

    def pending_count(self) -> int:
        return sum(len(b) for b in self._bufs.values())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rsrgan_tpu_torch.cli.extract")
    p.add_argument("--wav_scp", required=True)
    p.add_argument("--feat_type", choices=["spectrogram", "mfcc"],
                   required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--name", required=True)
    p.add_argument("--dither", type=float, default=1.0)
    p.add_argument("--dither_seed", type=int, default=0,
                   help="deterministic dither stream")
    p.add_argument("--accumulate_cmvn", action="store_true")
    p.add_argument("--compress", action="store_true",
                   help="write Kaldi CompressedMatrix arks "
                        "(copy-feats --compress=true equivalent)")
    p.add_argument("--text", action="store_true",
                   help="write a Kaldi TEXT archive (ark,t: equivalent)")
    p.add_argument("--batch_size", type=int, default=16,
                   help="utterances per pass on the device (1: one at a "
                        "time)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the extraction (cpu: the plain "
                        "PyTorch path on the host)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    set_precision()   # the MFCC products are a float32 contract
    device = resolve_device(args.device)
    t_start = time.monotonic()

    frame_opts = FrameOptions(dither=args.dither)
    os.makedirs(args.output_dir, exist_ok=True)
    scp_path = os.path.join(args.output_dir, args.name + ".scp")
    ark_path = os.path.join(args.output_dir, args.name + ".ark")
    writer = ArkWriter(scp_path, compress=args.compress, text=args.text)
    acc = None

    with open(args.wav_scp) as f:
        entries = [line.strip().split(None, 1) for line in f if line.strip()]

    # Buckets complete out of order; the ark/scp/CMVN must land in corpus
    # order so the three extraction passes' scp files stay line-aligned
    # for `prepare split`'s zip.
    pending = {}
    next_write = 0

    def drain():
        nonlocal next_write, acc
        while next_write in pending:
            feats = pending.pop(next_write)
            if acc is None and args.accumulate_cmvn:
                acc = CmvnAccumulator(feats.shape[1])
            if acc is not None:
                acc.accumulate(feats)
            writer.write_next_utt(ark_path, entries[next_write][0], feats)
            next_write += 1

    extractor = BatchedExtractor(args.feat_type, frame_opts,
                                 args.dither > 0, max(1, args.batch_size),
                                 device)
    for idx, (utt_id, wav_path) in enumerate(entries):
        wave, rate = read_wav(wav_path)
        if rate != frame_opts.samp_freq:
            print(f"WARNING: {utt_id} rate {rate} != "
                  f"{frame_opts.samp_freq:g}", file=sys.stderr)
        for t, feats in extractor.add(idx, wave, args.dither_seed + idx):
            pending[t] = feats
        # a rare-length bucket can stall the in-order writer while
        # completed batches pile up; bound the buffer
        if len(pending) + extractor.pending_count() > 512:
            for t, feats in extractor.flush_all():
                pending[t] = feats
        drain()
    for t, feats in extractor.flush_all():
        pending[t] = feats
    drain()
    if next_write != len(entries):
        raise RuntimeError(f"wrote {next_write} of {len(entries)} "
                           "utterances")
    writer.close()
    if acc is not None:
        cmvn_path = os.path.join(args.output_dir, args.name + ".cmvn")
        write_kaldi_cmvn(cmvn_path, acc.stats_matrix())
        print(f"CMVN stats -> {cmvn_path}")
    secs = time.monotonic() - t_start
    print(f"Wrote {len(entries)} x {args.feat_type} -> {ark_path}")
    print(f"Extracted {extractor.frames} frames on {device}: "
          f"{extractor.frames / max(secs, 1e-9):.0f} frames/s "
          f"({secs:.2f} s), "
          f"{extractor.frames / max(extractor.device_secs, 1e-9):.0f} "
          f"frames/s in the passes ({extractor.device_secs:.2f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
