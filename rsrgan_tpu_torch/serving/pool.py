"""Batched multi-stream wav->wav serving: one batched step, N streams
(counterpart of ``rsrgan_tpu/serving/pool.py``).

The single-stream ``StreamingWavEnhancer`` is latency-bound: a [1, chunk,
257] step pays the per-step launch latency for one row. Serving many
concurrent streams, the pool packs up to ``capacity`` independent streams
into one fixed-shape [capacity, chunk_frames, bins] step — device
throughput then scales with occupancy while each stream's result stays
what it would be alone, up to the last bits of the products (the batch
differs).

Exactness under uneven progress: streams attach and detach and buffer at
different rates, so a batched step may carry a full chunk for one lane
and 3 frames (or none) for another. Per-lane valid lengths go to the
masked ``StreamingEnhancer.step``: a lane's recurrent state freezes after
its length, so partial chunks compose like dedicated per-stream chunks.

After each step the outputs come back to the host (one copy) for the
per-lane WOLA resynthesis, which is host numpy.

Usage::

    pool = StreamPool(params, in_cmvn, lab_cmvn, capacity=8)
    sid = pool.open()
    out = pool.feed(sid, samples)     # newly finalized enhanced samples
    ...
    tail = pool.close(sid)            # flush + free the lane
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np

from rsrgan_tpu_torch.data.cmvn import Cmvn
from rsrgan_tpu_torch.features.frontend import FrameOptions
from rsrgan_tpu_torch.serving.streaming import StreamingEnhancer
from rsrgan_tpu_torch.serving.wav_stream import WavChain, WavStreamState


class StreamPool:
    """Fixed-capacity pool of concurrent wav->wav enhancement streams
    sharing one batched, masked generator step.

    Thread-safe: open/feed/poll/close serialize on an internal lock, so
    one calling thread per stream needs no external coordination. Each
    stream's output does not depend on how its frames interleave with
    other lanes' batched steps (the masked step's exact continuation), so
    thread scheduling cannot change results — only which step carries
    them.
    """

    def __init__(self, params, inputs_cmvn: Cmvn, labels_cmvn: Cmvn,
                 variant: str = "res_lstm_l",
                 frame_opts: FrameOptions = FrameOptions(dither=0.0),
                 raw_energy: bool = True, chunk_frames: int = 50,
                 capacity: int = 8, device="cuda"):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.chain = WavChain(params, inputs_cmvn, labels_cmvn,
                              variant=variant, frame_opts=frame_opts,
                              raw_energy=raw_energy)
        self.chunk_frames = int(chunk_frames)
        self.capacity = int(capacity)
        self.enhancer = StreamingEnhancer(params, variant=variant,
                                          device=device)
        self._state = self.enhancer.init_state(batch=self.capacity)
        self._slots: List[Optional[WavStreamState]] = [None] * self.capacity
        self._out: List[List[np.ndarray]] = [[] for _ in range(self.capacity)]
        self._zero_x = np.zeros((self.chunk_frames, self.chain.bins),
                                np.float32)
        self._lock = threading.RLock()
        self.steps_run = 0          # batched device steps
        self.frames_run = 0         # valid frames across all lanes

    # ------------------------------------------------------------------

    @property
    def active(self) -> int:
        with self._lock:
            return sum(s is not None for s in self._slots)

    def open(self) -> int:
        """Claim a free lane; returns the stream id. Raises when full."""
        with self._lock:
            return self._open_locked()

    def _open_locked(self) -> int:
        for sid, slot in enumerate(self._slots):
            if slot is None:
                self._slots[sid] = WavStreamState(self.chain)
                self._out[sid] = []
                # a fresh stream starts from zero recurrent state; the
                # pool's state tensors are its own, so in place
                for c, h in self._state:
                    c[sid] = 0.0
                    h[sid] = 0.0
                return sid
        raise RuntimeError(f"pool is full ({self.capacity} streams)")

    def _step(self) -> None:
        """One batched masked step over every lane's pending frames
        (up to chunk_frames each); absorb + buffer per-lane output."""
        xs, specs, lengths = [], [], []
        for slot in self._slots:
            n = min(slot.pending(), self.chunk_frames) if slot else 0
            if n:
                x, spec = slot.take(n)
                if n < self.chunk_frames:
                    x = np.concatenate(
                        [x, self._zero_x[:self.chunk_frames - n]])
            else:
                x, spec = self._zero_x, None
            xs.append(x)
            specs.append(spec)
            lengths.append(n)
        y, self._state = self.enhancer.step(
            np.stack(xs), self._state, lengths=np.asarray(lengths, np.int32))
        y = y.cpu().numpy()
        self.steps_run += 1
        self.frames_run += int(sum(lengths))
        for sid, (slot, spec, n) in enumerate(
                zip(self._slots, specs, lengths)):
            if not n:
                continue
            enhanced = self.chain.labels_cmvn.denormalize(y[sid, :n])
            slot.absorb(enhanced, spec)
            got = slot.emit_ready()
            if len(got):
                self._out[sid].append(got)

    def _drain(self, stop_when_empty: Optional[int] = None) -> None:
        """Run batched steps while any lane has a full chunk — or, when
        ``stop_when_empty`` is a stream id, until that lane has no
        pending frames at all (its final partial chunk rides along)."""
        def ready():
            if stop_when_empty is not None and \
                    self._slots[stop_when_empty].pending():
                return True
            return any(s and s.pending() >= self.chunk_frames
                       for s in self._slots)
        while ready():
            self._step()

    def _pop_out(self, sid: int) -> np.ndarray:
        buf = self._out[sid]
        self._out[sid] = []
        if not buf:
            return np.zeros((0,), np.float32)
        return np.concatenate(buf)

    def feed(self, sid: int, samples: np.ndarray) -> np.ndarray:
        """Feed samples to stream ``sid``; opportunistically runs batched
        steps and returns this stream's newly finalized samples."""
        with self._lock:
            slot = self._slots[sid]
            if slot is None:
                raise ValueError(f"stream {sid} is not open")
            slot.push(samples)
            self._drain()
            return self._pop_out(sid)

    def poll(self, sid: int) -> np.ndarray:
        """Collect output finalized for ``sid`` by other streams' steps."""
        with self._lock:
            if self._slots[sid] is None:
                raise ValueError(f"stream {sid} is not open")
            return self._pop_out(sid)

    def close(self, sid: int) -> np.ndarray:
        """Flush stream ``sid`` (its buffered partial chunk rides a final
        masked step), free the lane, and return all remaining samples."""
        with self._lock:
            return self._close_locked(sid)

    def _close_locked(self, sid: int) -> np.ndarray:
        slot = self._slots[sid]
        if slot is None:
            raise ValueError(f"stream {sid} is not open")
        self._drain(stop_when_empty=sid)
        tail = slot.emit_tail()
        if len(tail):
            self._out[sid].append(tail)
        self._slots[sid] = None
        return self._pop_out(sid)
