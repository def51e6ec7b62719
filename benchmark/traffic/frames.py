"""A generator of the benchmark's traffic: a corpus of spliced frames,
held on the host as the frame trainers' ``FrameBatcher`` holds it. The
drivers load it by the name a mix gives under ``generator``
(``harness.generator``).

A mix file (``traffic/<mix>.json``) gives its parameters:

* ``utterances``, ``min_frames``, ``max_frames``, ``lengths_seed``: the
  utterances' lengths, drawn as ``corpus.lengths`` draws them;
* ``order_seed``: the seed of the batcher's permutations (``--seed`` in
  the CLI), so every run draws its batches at the same positions;
* ``batch_size``: the frames of a training batch.

``--seed`` draws the values: features, CMVN-normalised, N(0, 1), made on
the device as ``corpus.tables`` makes them and moved to the host
(``tables``); ``spliced`` then puts each frame beside its context, the
edge frames repeated at an utterance's ends, into one ``[frames,
(left + 1 + right) * dim]`` f32 table: the table ``FrameBatcher`` builds
from a store, utterance by utterance, built here in vectorised row
blocks on the host's cores.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np

from benchmark.traffic import corpus

BLOCK_ROWS = 1 << 16   # rows a thread splices at a time

lengths = corpus.lengths
starts = corpus.starts


def tables(lens: np.ndarray, dims: Tuple[int, ...], seed: int,
           device) -> Tuple[np.ndarray, ...]:
    """One ``[sum(lens), dim]`` f32 host table per width of ``dims``,
    drawn on ``device`` from ``seed`` (``corpus.tables``, less its zero
    row)."""
    out = []
    for table in corpus.tables(lens, dims, seed, device):
        out.append(table[:-1].cpu().numpy())
        del table
    return tuple(out)


def spliced(feats: np.ndarray, lens: np.ndarray, left: int, right: int,
            threads: int = 0) -> np.ndarray:
    """``feats [frames, D]`` (utterances of ``lens`` end to end) with each
    frame beside its ``left`` and ``right`` context, edge-clamped within
    its utterance: ``[frames, D * (left + 1 + right)]`` f32."""
    total, dim = feats.shape
    first = np.repeat(starts(lens), lens.astype(np.int64))
    last = first + np.repeat(lens.astype(np.int64), lens.astype(np.int64)) - 1
    out = np.empty((total, dim * (left + 1 + right)), np.float32)

    def block(r0: int) -> None:
        r1 = min(r0 + BLOCK_ROWS, total)
        t = np.arange(r0, r1, dtype=np.int64)
        for j in range(-left, right + 1):
            src = np.clip(t + j, first[r0:r1], last[r0:r1])
            col = (j + left) * dim
            out[r0:r1, col:col + dim] = feats[src]

    with ThreadPoolExecutor(threads or min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(block, range(0, total, BLOCK_ROWS)))
    return out
