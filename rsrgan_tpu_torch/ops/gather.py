"""Sequence batches assembled on the device from resident feature tables
(counterpart of ``rsrgan_tpu/ops/gather.py``).

A corpus lies on the device as one flat ``[N + 1, D]`` table per stream
(``data/device_feed.py``; the last row is all zero), and a batch is built
from ``[B]`` int32 index plans, one gather per splice offset. The result
is the host batcher's batch (``SequenceBatcher._make_batch``) bit for
bit:

* frames past each row's true length come from the zero row;
* splice context is edge-clamped within the utterance
  (``splice_frames_np``: clip(t + off, 0, len - 1));
* labels are never spliced;
* the output is float32 whatever the table's dtype (a bfloat16 table
  quantizes the values, not the conventions).

The JAX package computes this outside any Pallas kernel, and so does the
port: ``index_select`` on a flattened ``[B * t_pad]`` index.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _row_indices(starts: torch.Tensor, lengths: torch.Tensor, t_pad: int,
                 offsets, zero_row: int):
    """Flat ``[B * t_pad]`` table rows of each splice offset: row b, frame
    t reads ``starts[b] + clip(t + off, 0, lengths[b] - 1)``, and the zero
    row past ``lengths[b]``."""
    t = torch.arange(t_pad, device=starts.device, dtype=torch.int64)[None, :]
    len_col = lengths.to(torch.int64)[:, None]
    start_col = starts.to(torch.int64)[:, None]
    valid = t < len_col
    return [torch.where(valid, start_col + torch.minimum(
        torch.clamp(t + off, min=0), len_col - 1), zero_row).reshape(-1)
        for off in offsets]


def _gather(table: torch.Tensor, rows, b: int, t_pad: int) -> torch.Tensor:
    cols = [table.index_select(0, idx).reshape(b, t_pad, table.shape[1])
            for idx in rows]
    out = cols[0] if len(cols) == 1 else torch.cat(cols, dim=-1)
    return out.float()


def gather_sequences(table: torch.Tensor, starts: torch.Tensor,
                     lengths: torch.Tensor, t_pad: int, left: int = 0,
                     right: int = 0) -> torch.Tensor:
    """``table [N+1, D]`` (row N all zero) -> ``[B, t_pad,
    D * (left + 1 + right)]`` float32.

    ``starts``/``lengths`` are ``[B]`` int32 on the table's device: row b
    is frames ``table[starts[b] : starts[b] + lengths[b]]``, spliced with
    edge-clamped context and zero-padded to ``t_pad``."""
    rows = _row_indices(starts, lengths, t_pad, range(-left, right + 1),
                        table.shape[0] - 1)
    return _gather(table, rows, starts.shape[0], t_pad)


def assemble_sequence_batch(inputs_tbl: torch.Tensor,
                            labels_tbl: Optional[torch.Tensor],
                            starts: torch.Tensor, lengths: torch.Tensor,
                            t_pad: int, left: int, right: int
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(spliced inputs, labels) of one batch plan; labels never spliced.
    The tables hold the same frames (same row count), so the labels
    gather reuses the inputs' offset-0 rows."""
    rows = _row_indices(starts, lengths, t_pad, range(-left, right + 1),
                        inputs_tbl.shape[0] - 1)
    x = _gather(inputs_tbl, rows, starts.shape[0], t_pad)
    y = (_gather(labels_tbl, rows[left:left + 1], starts.shape[0], t_pad)
         if labels_tbl is not None else None)
    return x, y
