"""The corpus resident in device memory (counterpart of
``rsrgan_tpu/data/device_feed.py``): ``DeviceFeed``, ``RotatingDeviceFeed``
and ``table_bytes``.

The host feed copies every batch from pageable numpy arrays inside the
step loop. ``DeviceFeed`` uploads the store's frame tables once, and the
training loop then builds each batch on the device from ``[B]`` int32
index plans (``ops/gather.py``), so a step moves a few hundred bytes from
the host. ``RotatingDeviceFeed`` serves a corpus whose tables exceed the
device budget: seeded utterance shards that each fit, made resident in
turn, optionally uploaded on a side stream while the card trains on the
shard before.

Tables are ``[N + 1, D]`` at the features' own widths (the last row is all
zero), in float32 or bfloat16. Rows travel in float32 chunks through a
pinned staging buffer and are written in place (``copy_`` into the table's
rows), so a table's upload peaks at the table plus one chunk; a bfloat16
table casts each chunk on the device, which rounds to nearest even exactly
as a host-side float32 -> bfloat16 cast does.

In a ``--num_gpu`` world every rank holds the whole tables on its own
card (the budget is per card), as JAX replicates them over its mesh, and
gathers its row block of each global plan (the CLI's ``rank_plans``, the
counterpart of JAX's ``place_plans``). A rotating feed is seeded alike on
every rank, so each visits the same shards in the same order.
Multi-process runs use the host feed, as in JAX.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

_DEFAULT_CHUNK_BYTES = 1 << 26  # 64 MB of float32 rows per host->device copy


def table_bytes(store, itemsize: int = 4) -> int:
    """Device bytes of a store's resident tables at ``itemsize``."""
    total = int(store.lengths.sum()) + 1  # +1: the zero row
    dims = store.input_dim + (store.output_dim if store.has_labels else 0)
    return total * dims * itemsize


def _record(stream: Optional[torch.cuda.Stream], device: torch.device):
    """An event recorded on ``stream`` (the current stream when None), or
    None on the CPU."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(stream if stream is not None
                 else torch.cuda.current_stream(device))
    return event


class _Stager:
    """Two pinned float32 host buffers of ``rows`` x ``dim`` that take turns
    (the host fills one while the other's copy is in flight), and on the
    card a float32 device chunk that a bfloat16 table is cast from."""

    def __init__(self, rows: int, dim: int, device: torch.device):
        pinned = device.type == "cuda"
        self.rows = rows
        self.device = device
        self.host = [torch.empty((rows, dim), dtype=torch.float32,
                                 pin_memory=pinned)
                     for _ in range(2 if pinned else 1)]
        self.copied = [None] * len(self.host)
        self.slot = 0
        self.dev: Optional[torch.Tensor] = None

    def buffer(self) -> np.ndarray:
        """The current slot as numpy, once its last copy has left it."""
        if self.copied[self.slot] is not None:
            self.copied[self.slot].synchronize()
        return self.host[self.slot].numpy()

    def ship(self, table: torch.Tensor, row: int, n: int) -> None:
        """Copy the current slot's first ``n`` rows into ``table[row:row
        + n]`` on the current stream, then move to the other slot."""
        src = self.host[self.slot][:n]
        dst = table[row:row + n]
        if table.dtype == torch.float32 or self.device.type != "cuda":
            dst.copy_(src, non_blocking=True)
        else:
            if self.dev is None:
                self.dev = torch.empty((self.rows, table.shape[1]),
                                       dtype=torch.float32,
                                       device=self.device)
            self.dev[:n].copy_(src, non_blocking=True)
            dst.copy_(self.dev[:n])
        self.copied[self.slot] = _record(None, self.device)
        self.slot = (self.slot + 1) % len(self.host)


def _fill_table(table: torch.Tensor, row_fn, indices, total_rows: int,
                chunk_bytes: int) -> None:
    """Write the rows of utterances ``indices`` (``row_fn(i)`` -> [n, D])
    into ``table[0:total_rows]`` in order, chunk by chunk, on the current
    stream. Rows past ``total_rows`` are left as they are: a shorter shard
    reusing a longer shard's buffer leaves stale rows there, which no plan
    indexes (plans reach ``[0, total_rows)`` and the zero row)."""
    dim = table.shape[1]
    rows = max(1, min(chunk_bytes // (dim * 4), total_rows))
    stager = _Stager(rows, dim, table.device)
    written, fill = 0, 0
    buf = stager.buffer()

    def ship() -> None:
        nonlocal written, fill, buf
        if written + fill > total_rows:
            # the store's index promised fewer rows: never write past them
            # (the zero row that padding gathers from may follow)
            raise ValueError(
                f"store desync: more than the {total_rows} rows the store "
                "index promised")
        stager.ship(table, written, fill)
        written += fill
        fill = 0
        buf = stager.buffer()

    for i in indices:
        m = np.asarray(row_fn(int(i)))
        if m.shape[1] != dim:
            raise ValueError(f"utterance {int(i)} has {m.shape[1]} columns, "
                             f"the table {dim}")
        off = 0
        while off < m.shape[0]:
            n = min(m.shape[0] - off, rows - fill)
            buf[fill:fill + n] = m[off:off + n]
            fill += n
            off += n
            if fill == rows:
                ship()
    if fill:
        ship()
    if written != total_rows:
        raise ValueError(
            f"store desync: uploaded {written} rows but the store index "
            f"promised {total_rows}")


def _make_table(rows: int, dim: int, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """A zeroed ``[rows + 1, dim]`` table: the last row stays zero."""
    return torch.zeros((rows + 1, dim), dtype=dtype, device=device)


def _on_stream(stream: Optional[torch.cuda.Stream]):
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


class DeviceFeed:
    """The whole store's tables on ``device`` plus host-side index plans.

    ``inputs_tbl`` is ``[total + 1, input_dim]``, ``labels_tbl``
    ``[total + 1, output_dim]`` or None for a store without labels; row
    ``total`` is zero. ``plan(indices)`` gives the (starts, lengths) int32
    numpy arrays of one batch.
    """

    def __init__(self, store, dtype: torch.dtype = torch.float32,
                 device="cuda", chunk_bytes: int = _DEFAULT_CHUNK_BYTES):
        device = torch.device(device)
        lens = store.lengths.astype(np.int64)
        total = int(lens.sum())
        if total + 1 > np.iinfo(np.int32).max:
            raise ValueError(
                f"store has {total} frames — beyond int32 gather indices; "
                "shard the corpus across several training runs")
        starts = np.zeros(len(lens), np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        self.starts = starts.astype(np.int32)
        self.lengths = lens.astype(np.int32)
        self.dtype = dtype
        self.in_dim = int(store.input_dim)
        self.out_dim: Optional[int] = None
        self.labels_tbl: Optional[torch.Tensor] = None
        order = np.arange(len(store))
        self.inputs_tbl = _make_table(total, self.in_dim, dtype, device)
        _fill_table(self.inputs_tbl, store.inputs, order, total, chunk_bytes)
        if store.has_labels:
            self.out_dim = int(store.output_dim)
            self.labels_tbl = _make_table(total, self.out_dim, dtype, device)
            _fill_table(self.labels_tbl, store.labels, order, total,
                        chunk_bytes)
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()

    @property
    def num_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.inputs_tbl, self.labels_tbl)
                   if t is not None)

    def plan(self, indices) -> Tuple[np.ndarray, np.ndarray]:
        ix = np.asarray(indices, np.int64)
        return self.starts[ix], self.lengths[ix]


class RotatingDeviceFeed:
    """Resident shards for a corpus beyond the device budget.

    The corpus is cut (seeded permutation) into utterance shards whose
    tables fit ``budget_bytes``; training visits them in residencies
    (``schedule``) and refills the same table buffers at each rotation, so
    every shard shares one table shape (the largest shard's rows + 1).
    With ``prefetch=True`` two buffer sets take turns: a daemon thread
    uploads the next shard on its own CUDA stream while the card trains on
    the current one (each shard then fits half the budget).

    Ordering on the card: an upload waits for an event recorded on the
    compute stream when its buffer last stopped being the active one (the
    steps that read it may still be queued), and the compute stream waits
    for the upload's event before it reads a freshly filled buffer.
    ``upload_secs`` times each upload to its end (the upload stream is
    synchronised, not the device).
    """

    def __init__(self, store, dtype: torch.dtype, budget_bytes: int,
                 device="cuda", chunk_bytes: int = _DEFAULT_CHUNK_BYTES,
                 seed: int = 777, prefetch: bool = False):
        if not store.has_labels:
            raise ValueError("RotatingDeviceFeed is a training feed; "
                             "test stores decode via infer_batches")
        self.store = store
        self.dtype = dtype
        self.device = torch.device(device)
        self.chunk_bytes = chunk_bytes
        self.in_dim = int(store.input_dim)
        self.out_dim = int(store.output_dim)
        lens = store.lengths.astype(np.int64)
        itemsize = torch.empty((), dtype=dtype).element_size()
        bpf = (self.in_dim + self.out_dim) * itemsize
        n_buffers = 2 if prefetch else 1
        cap_rows = int(budget_bytes) // (bpf * n_buffers) - 1
        if cap_rows < int(lens.max()):
            raise ValueError(
                f"device budget {budget_bytes / 1e9:.1f} GB fits only "
                f"{cap_rows} frames per shard buffer — less than the "
                f"longest utterance ({int(lens.max())})")
        perm = np.random.default_rng(seed).permutation(len(lens))
        shards, cur, cur_rows = [], [], 0
        for i in perm:
            if cur_rows + lens[i] > cap_rows:
                shards.append(np.asarray(cur, np.int64))
                cur, cur_rows = [], 0
            cur.append(int(i))
            cur_rows += int(lens[i])
        if cur:
            shards.append(np.asarray(cur, np.int64))
        self.shards: List[np.ndarray] = shards
        self._shard_rows = [int(lens[s].sum()) for s in shards]
        self.max_rows = max(self._shard_rows)
        # local plans per shard, aligned with each shard's utterance order
        self._local = []
        for s in shards:
            sl = lens[s]
            st = np.zeros(len(sl), np.int64)
            np.cumsum(sl[:-1], out=st[1:])
            self._local.append((st.astype(np.int32), sl.astype(np.int32)))
        self._bufs = [[_make_table(self.max_rows, d, dtype, self.device)
                       for d in (self.in_dim, self.out_dim)]
                      for _ in range(n_buffers)]
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._filled = [None] * n_buffers    # upload done (upload stream)
        # last use queued on the compute stream: for now the zero fill
        self._released = [_record(None, self.device)] * n_buffers
        self._active_buf = 0
        self._active_shard: Optional[int] = None
        self._thread: Optional[threading.Thread] = None
        self._thread_target: Optional[int] = None
        self._thread_error: Optional[BaseException] = None
        self.upload_secs = 0.0
        self.uploads = 0
        self.starts: Optional[np.ndarray] = None
        self.lengths: Optional[np.ndarray] = None
        self.inputs_tbl: Optional[torch.Tensor] = None
        self.labels_tbl: Optional[torch.Tensor] = None

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    def _fill(self, buf_i: int, k: int) -> None:
        t0 = time.monotonic()
        rows, ix = self._shard_rows[k], self.shards[k]
        with _on_stream(self._stream):
            if self._released[buf_i] is not None:
                self._stream.wait_event(self._released[buf_i])
            inputs_tbl, labels_tbl = self._bufs[buf_i]
            _fill_table(inputs_tbl, self.store.inputs, ix, rows,
                        self.chunk_bytes)
            _fill_table(labels_tbl, self.store.labels, ix, rows,
                        self.chunk_bytes)
            self._filled[buf_i] = _record(self._stream, self.device)
        if self._stream is not None:
            self._stream.synchronize()
        self.upload_secs += time.monotonic() - t0
        self.uploads += 1

    def _fill_in_thread(self, buf_i: int, k: int) -> None:
        try:
            self._fill(buf_i, k)
        except BaseException as e:  # raised again by ensure_resident
            self._thread_error = e

    def _activate(self, buf_i: int, k: int) -> None:
        self._active_buf, self._active_shard = buf_i, k
        self.inputs_tbl, self.labels_tbl = self._bufs[buf_i]
        self.starts, self.lengths = self._local[k]
        if self._filled[buf_i] is not None:
            torch.cuda.current_stream(self.device).wait_event(
                self._filled[buf_i])

    def ensure_resident(self, k: int) -> None:
        """Make shard ``k`` the active table set (blocking). Call it from
        the thread, and on the stream, that runs the steps."""
        if self._active_shard == k:
            return
        if self._active_shard is not None:
            # every step that reads the active buffer is queued by now
            self._released[self._active_buf] = _record(None, self.device)
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            if self._thread_error is not None:
                error, self._thread_error = self._thread_error, None
                raise RuntimeError("shard prefetch failed") from error
            if self._thread_target == k:
                self._activate(1 - self._active_buf, k)
                return
        dst = (self._active_buf if len(self._bufs) == 1
               else 1 - self._active_buf)
        self._fill(dst, k)
        self._activate(dst, k)

    def start_prefetch(self, k: int) -> None:
        """Begin uploading shard ``k`` into the inactive buffer set on a
        daemon thread (no-op without prefetch buffers, when ``k`` is
        already resident, or while a prefetch is in flight)."""
        if (len(self._bufs) == 1 or k == self._active_shard
                or self._thread is not None):
            return
        self._thread_target = k
        self._thread = threading.Thread(
            target=self._fill_in_thread, args=(1 - self._active_buf, k),
            daemon=True)
        self._thread.start()

    def schedule(self, epochs: int, block: int, seed: int = 0):
        """Residency plan [(shard, passes)]: every shard gets exactly
        ``epochs`` passes, in residencies of up to ``block`` consecutive
        passes, cycling shards in per-cycle shuffled order."""
        rng = np.random.default_rng(seed)
        remaining = np.full(self.num_shards, int(epochs), np.int64)
        visits = []
        while remaining.any():
            for k in rng.permutation(self.num_shards):
                if remaining[k] <= 0:
                    continue
                p = int(min(block, remaining[k]))
                visits.append((int(k), p))
                remaining[k] -= p
        return visits

    @property
    def num_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for buf in self._bufs for t in buf)

    def plan(self, view_indices) -> Tuple[np.ndarray, np.ndarray]:
        """(starts, lengths) local to the ACTIVE shard; ``view_indices``
        are positions within the shard (what a SequenceBatcher over
        ``StoreView(store, feed.shards[k])`` yields)."""
        ix = np.asarray(view_indices, np.int64)
        return self.starts[ix], self.lengths[ix]
