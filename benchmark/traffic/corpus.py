"""A generator of the benchmark's traffic: a corpus of utterances. The
drivers load it by the name a mix gives under ``generator``
(``harness.generator``).

A mix file (``traffic/<mix>.json``) gives its parameters:

* ``utterances``, ``min_frames``, ``max_frames``: the lengths are drawn
  uniform in ``[min_frames, max_frames]`` from ``lengths_seed``, so every
  run's corpus holds the same lengths in the same order;
* ``order_seed``: the seed of the batcher's shuffle (a training mix), so
  every run's window trains on the same sequence of batch shapes;
* ``batch_size``: the rows of a training or decode batch.

``--seed`` draws the values: features, CMVN-normalised, N(0, 1), made on
the device in a few large calls (the inputs' table first, then the
targets'), and the weights and noise (``weights.py``, the drivers). The
work of a window is then the same for every seed: the sizes, not the
values, set the kernels' time. A table is ``[frames + 1, dim]`` f32 with
its last row zero, the layout of the port's ``DeviceFeed``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from benchmark.harness import stream_seed

CHUNK_ROWS = 1 << 22  # rows drawn per call (4 M rows: 4.3 GB at 257 f32)


def lengths(mix: dict) -> np.ndarray:
    """The corpus' utterance lengths, int32."""
    rng = np.random.default_rng(mix["lengths_seed"])
    return rng.integers(mix["min_frames"], mix["max_frames"] + 1,
                        mix["utterances"]).astype(np.int32)


def starts(lens: np.ndarray) -> np.ndarray:
    """Each utterance's first row in the tables (int64)."""
    out = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1].astype(np.int64), out=out[1:])
    return out


def tables(lens: np.ndarray, dims: Tuple[int, ...], seed: int,
           device) -> Tuple[torch.Tensor, ...]:
    """One ``[sum(lens) + 1, dim]`` f32 table per width of ``dims``, made
    on ``device`` from ``seed``; the last row of each is zero."""
    total = int(lens.astype(np.int64).sum())
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, 1))
    out = []
    for dim in dims:
        table = torch.empty((total + 1, dim), dtype=torch.float32,
                            device=device)
        for row in range(0, total, CHUNK_ROWS):
            table[row:min(row + CHUNK_ROWS, total)].normal_(generator=gen)
        table[total].zero_()
        out.append(table)
    return tuple(out)


def rows(table: torch.Tensor, first: np.ndarray, lens: np.ndarray,
         t_pad: int) -> torch.Tensor:
    """``[len(lens), t_pad, dim]`` f32 on the table's device: each
    utterance's rows, zero past its length (the benchmark's own slicing,
    for the reference)."""
    out = torch.zeros((len(lens), t_pad, table.shape[1]),
                      dtype=torch.float32, device=table.device)
    for b, (s, n) in enumerate(zip(first, lens)):
        out[b, :n] = table[int(s):int(s) + int(n)]
    return out
