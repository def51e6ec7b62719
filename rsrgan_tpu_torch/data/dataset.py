"""Sequence and frame batches (numpy copy of ``rsrgan_tpu/data/dataset.py``:
``bucket_id``, ``padded_length``, ``SequenceBatch``, ``SequenceBatcher``,
``FrameBatcher``, ``infer_batches`` and ``ThreadedPrefetcher``). With the
same seed a batcher gives the same batches as the JAX package's, in the
same order. The host-sharded views are not ported (ROADMAP.md, Queue 1,
'Parallel')."""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

from rsrgan_tpu_torch.data.splice import splice_frames_np
from rsrgan_tpu_torch.data.store import UtteranceStore


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

    def _make_batch(self, indices: List[int]) -> SequenceBatch:
        lengths = np.array([self._lengths[i] for i in indices],
                           dtype=np.int32)
        bucket = bucket_id(int(lengths.max()), self.num_buckets)
        t_pad = padded_length(bucket, int(lengths.max()), self.num_buckets)
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
    without them)."""

    def __init__(self, store: UtteranceStore, batch_size: int,
                 left_context: int = 0, right_context: int = 0,
                 shuffle: bool = True, drop_remainder: bool = True,
                 seed: int = 777):
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self._rng = np.random.default_rng(seed)
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
        return (self.inputs[sel],
                self.labels[sel] if self.labels is not None else None)

    def __iter__(self):
        for sel in self.iter_index_batches():
            yield self._make_batch(sel)


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
