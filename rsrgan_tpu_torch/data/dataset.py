"""Sequence and frame batches (numpy copy of ``rsrgan_tpu/data/dataset.py``:
``bucket_id``, ``padded_length``, ``SequenceBatch``, ``SequenceBatcher``,
``FrameBatcher``, ``infer_batches``, ``ThreadedPrefetcher`` and the
host-sharded views ``HostShardedSequenceBatches`` and
``HostShardedFrameBatches``, which give each process of a multi-process
run its row block of every full global batch). With the same seed a
batcher gives the same batches as the JAX package's, in the same
order."""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from rsrgan_tpu_torch.data.splice import splice_frames_np
from rsrgan_tpu_torch.data.store import UtteranceStore


def _span(name: str):
    """``spans.span(name)``, imported at the call: data preparation runs
    without torch, which ``spans`` loads."""
    from rsrgan_tpu_torch import spans
    return spans.span(name)


BUCKET_START = 200
BUCKET_WIDTH = 50
NUM_BUCKETS = 20


def bucket_id(length: int, num_buckets: int = NUM_BUCKETS) -> int:
    """Bucket key (length - 200) // 50, capped; negatives allowed."""
    return min(num_buckets, (length - BUCKET_START) // BUCKET_WIDTH)


def padded_length(bucket: int, max_len: int,
                  num_buckets: int = NUM_BUCKETS) -> int:
    """Static padded length of a bucket: its upper edge; the overflow
    bucket pads max_len up to a multiple of 128."""
    if bucket >= num_buckets:
        return -(-max_len // 128) * 128
    return BUCKET_START + BUCKET_WIDTH * (bucket + 1)


@dataclass
class SequenceBatch:
    utt_ids: List[str]
    inputs: np.ndarray   # [B, T_pad, D * (left+1+right)] float32
    labels: Optional[np.ndarray]  # [B, T_pad, out] float32 or None
    lengths: np.ndarray  # [B] int32 (true lengths before padding)


def infer_batches(store: UtteranceStore, left_context: int = 0,
                  right_context: int = 0,
                  pad_to_multiple: int = 128) -> Iterator[SequenceBatch]:
    """Batch-1 inference iterator. Pads T to a multiple of
    ``pad_to_multiple``, as the JAX decode does; the true length rides
    along for unpadding before the ark write."""
    for i in range(len(store)):
        feats = splice_frames_np(np.asarray(store.inputs(i)),
                                 left_context, right_context)
        t = feats.shape[0]
        t_pad = -(-t // pad_to_multiple) * pad_to_multiple
        padded = np.zeros((1, t_pad, feats.shape[1]), dtype=np.float32)
        padded[0, :t] = feats
        yield SequenceBatch([store.utt_ids[i]], padded, None,
                            np.array([t], dtype=np.int32))


class SequenceBatcher:
    """Length-bucketed padded utterance batches.

    One epoch: shuffle the utterances (numpy ``default_rng(seed)``), put
    them into buckets in that order, emit a batch whenever a bucket holds
    ``batch_size``; partial buckets are dropped when ``drop_remainder``.
    Each batch pads to its bucket's edge.
    """

    def __init__(self, store: UtteranceStore, batch_size: int,
                 left_context: int = 0, right_context: int = 0,
                 num_buckets: int = NUM_BUCKETS, shuffle: bool = True,
                 drop_remainder: bool = True, seed: int = 777):
        self.store = store
        self.batch_size = batch_size
        self.left_context = left_context
        self.right_context = right_context
        self.num_buckets = num_buckets
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self._rng = np.random.default_rng(seed)
        self._lengths = store.lengths

    @property
    def lengths(self) -> np.ndarray:
        """The store's utterance lengths, indexed as the plans index."""
        return self._lengths

    def num_batches(self) -> int:
        """Number of batches per epoch, from the index."""
        counts: Dict[int, int] = {}
        for length in self._lengths:
            b = bucket_id(int(length), self.num_buckets)
            counts[b] = counts.get(b, 0) + 1
        if self.drop_remainder:
            return sum(c // self.batch_size for c in counts.values())
        return sum(-(-c // self.batch_size) for c in counts.values())

    def plan_t_pad(self, indices: Sequence[int]) -> int:
        """The padded length of the batch of ``indices``: its longest
        utterance's bucket edge."""
        mx = max(int(self._lengths[i]) for i in indices)
        return padded_length(bucket_id(mx, self.num_buckets), mx,
                             self.num_buckets)

    def _make_batch(self, indices: Sequence[int],
                    t_pad: Optional[int] = None) -> SequenceBatch:
        """The batch of ``indices``, padded to ``t_pad`` (default: their
        own ``plan_t_pad``; a row block of a global batch takes the global
        batch's)."""
        lengths = np.array([self._lengths[i] for i in indices],
                           dtype=np.int32)
        if t_pad is None:
            t_pad = self.plan_t_pad(indices)
        splice = self.left_context + 1 + self.right_context
        inputs = np.zeros((len(indices), t_pad,
                           self.store.input_dim * splice), dtype=np.float32)
        labels = (np.zeros((len(indices), t_pad, self.store.output_dim),
                           dtype=np.float32)
                  if self.store.has_labels else None)
        utt_ids = []
        for row, i in enumerate(indices):
            utt_ids.append(self.store.utt_ids[i])
            feats = self.store.inputs(i)
            t_i = feats.shape[0]
            inputs[row, :t_i] = splice_frames_np(
                np.asarray(feats), self.left_context, self.right_context)
            if labels is not None:
                lab = self.store.labels(i)
                if lab.shape[0] != t_i:
                    raise ValueError(
                        f"utt {self.store.utt_ids[i]}: inputs have {t_i} "
                        f"frames but labels have {lab.shape[0]}")
                labels[row, :t_i] = lab
        return SequenceBatch(utt_ids, inputs, labels, lengths)

    def iter_index_batches(self) -> Iterator[List[int]]:
        """The epoch's batch plan (utterance-index lists)."""
        order = np.arange(len(self.store))
        if self.shuffle:
            self._rng.shuffle(order)
        pending: Dict[int, List[int]] = {}
        for i in order:
            b = bucket_id(int(self._lengths[i]), self.num_buckets)
            pending.setdefault(b, []).append(int(i))
            if len(pending[b]) == self.batch_size:
                yield pending.pop(b)
        if not self.drop_remainder:
            yield from pending.values()

    def __iter__(self) -> Iterator[SequenceBatch]:
        for indices in self.iter_index_batches():
            yield self._make_batch(indices)


class FrameBatcher:
    """Shuffled frame batches for the frame models (DNN, R-CED, CNN).

    Every utterance is spliced once into one flat frame table (inputs
    ``[N, splice * D]``, labels ``[N, out]``, f32); each epoch draws a
    fresh permutation of its rows from ``default_rng(seed)`` and cuts it
    into ``batch_size`` rows; ``drop_remainder`` drops the last partial
    batch. Batches are ``(inputs, labels)`` (labels None for a store
    without them). The splice of the table and the gather of each batch
    are ``feed.frames`` spans (``spans``)."""

    def __init__(self, store: UtteranceStore, batch_size: int,
                 left_context: int = 0, right_context: int = 0,
                 shuffle: bool = True, drop_remainder: bool = True,
                 seed: int = 777):
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self._rng = np.random.default_rng(seed)
        with _span("feed.frames"):
            ins, labs = [], []
            for i in range(len(store)):
                ins.append(splice_frames_np(np.asarray(store.inputs(i)),
                                            left_context, right_context))
                if store.has_labels:
                    labs.append(np.asarray(store.labels(i)))
            self.inputs = np.concatenate(ins, axis=0).astype(np.float32)
            self.labels = (np.concatenate(labs, axis=0).astype(np.float32)
                           if labs else None)

    @property
    def num_frames(self) -> int:
        return self.inputs.shape[0]

    def num_batches(self) -> int:
        if self.drop_remainder:
            return self.num_frames // self.batch_size
        return -(-self.num_frames // self.batch_size)

    def iter_index_batches(self) -> Iterator[np.ndarray]:
        """The epoch's batch plan as frame-index arrays."""
        order = np.arange(self.num_frames)
        if self.shuffle:
            self._rng.shuffle(order)
        stop = (self.num_frames - self.num_frames % self.batch_size
                if self.drop_remainder else self.num_frames)
        for start in range(0, stop, self.batch_size):
            yield order[start:start + self.batch_size]

    def _make_batch(self, sel: np.ndarray):
        with _span("feed.frames"):
            return (self.inputs[sel],
                    self.labels[sel] if self.labels is not None else None)

    def __iter__(self):
        for sel in self.iter_index_batches():
            yield self._make_batch(sel)


class HostShardedSequenceBatches:
    """One process's view of a global ``SequenceBatcher`` plan.

    Every process builds the same batcher (same store list and seed) and
    wraps it with its (process_index, process_count); each then builds
    only its contiguous row block of every FULL global batch, padded to
    the global batch's length, so shapes and batch counts are the same
    on every process and the blocks in process order are the global
    batch. Ragged global batches are skipped, on every process alike.
    """

    def __init__(self, batcher: SequenceBatcher, process_index: int,
                 process_count: int):
        if batcher.batch_size % process_count:
            raise ValueError(
                f"global batch {batcher.batch_size} not divisible by "
                f"{process_count} processes")
        self.batcher = batcher
        self.rows = batcher.batch_size // process_count
        self.process_index = process_index
        if self.num_batches() == 0:
            raise ValueError(
                "multi-host run would yield ZERO full global batches "
                f"(batch {batcher.batch_size} over {process_count} "
                "processes; ragged batches cannot be row-sharded) — "
                "reduce --batch_size or use a larger corpus")

    def num_batches(self) -> int:
        """The full global batches of an epoch (ragged ones are skipped)."""
        counts: Dict[int, int] = {}
        for length in self.batcher.lengths:
            k = bucket_id(int(length), self.batcher.num_buckets)
            counts[k] = counts.get(k, 0) + 1
        return sum(c // self.batcher.batch_size for c in counts.values())

    def iter_plans(self) -> Iterator[Tuple[List[int], int]]:
        """(this process's indices, the global batch's padded length) of
        every full global batch of an epoch."""
        b = self.batcher
        lo = self.process_index * self.rows
        for indices in b.iter_index_batches():
            if len(indices) != b.batch_size:
                continue   # ragged: every process skips it
            yield indices[lo:lo + self.rows], b.plan_t_pad(indices)

    def __iter__(self) -> Iterator[SequenceBatch]:
        for indices, t_pad in self.iter_plans():
            yield self.batcher._make_batch(indices, t_pad=t_pad)


class HostShardedFrameBatches:
    """One process's view of a global ``FrameBatcher`` plan (the frame
    twin of ``HostShardedSequenceBatches``): its row block of every full
    global batch."""

    def __init__(self, batcher: FrameBatcher, process_index: int,
                 process_count: int):
        if batcher.batch_size % process_count:
            raise ValueError(
                f"global batch {batcher.batch_size} not divisible by "
                f"{process_count} processes")
        self.batcher = batcher
        self.rows = batcher.batch_size // process_count
        self.process_index = process_index
        if self.num_batches() == 0:
            raise ValueError(
                "multi-host run would yield ZERO full global batches — "
                "reduce --batch_size or use a larger corpus")

    def num_batches(self) -> int:
        """The full global batches of an epoch (the ragged tail is
        skipped)."""
        return self.batcher.num_frames // self.batcher.batch_size

    def iter_index_batches(self) -> Iterator[np.ndarray]:
        """This process's frame indices of every full global batch."""
        lo = self.process_index * self.rows
        for sel in self.batcher.iter_index_batches():
            if len(sel) == self.batcher.batch_size:
                yield sel[lo:lo + self.rows]

    def __iter__(self):
        for sel in self.iter_index_batches():
            yield self.batcher._make_batch(sel)


class ThreadedPrefetcher:
    """A producer thread filling a bounded queue from ``iterator``, the
    reference's feeder pattern. An error raised by the producer is raised
    to the consumer when it reaches that point of the stream, chained to
    the original."""

    _DONE = object()

    def __init__(self, iterator, capacity: int = 32):
        self._queue: "queue.Queue" = queue.Queue(capacity)
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, args=(iterator,), daemon=True)
        self._thread.start()

    def _run(self, iterator) -> None:
        try:
            for item in iterator:
                self._queue.put(item)
        except BaseException as e:  # surfaced to the consumer, not dropped
            self._error = e
        finally:
            self._queue.put(self._DONE)

    def __iter__(self):
        while True:
            item = self._queue.get()
            if item is self._DONE:
                if self._error is not None:
                    raise RuntimeError(
                        "prefetch producer failed") from self._error
                return
            yield item
