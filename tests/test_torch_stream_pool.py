"""The port's StreamPool (rsrgan_tpu_torch/serving/pool.py) against the
JAX package's under the same interleaving of open, feed and close across
lanes of unequal progress: per-stream waves, steps_run and frames_run;
lane reuse from zero state; capacity, errors and thread-driven streams."""

import threading

import numpy as np
import pytest

from rsrgan_tpu.serving import StreamPool as JaxPool
from rsrgan_tpu_torch.serving import StreamingWavEnhancer, StreamPool
from test_torch_wav_stream import (JAX_NODITHER, NODITHER, cmvns,
                                   lps_params, noisy_speech, wave_cmvns)

# max |diff| / peak: the waves reach ~1e5 on the 16-bit PCM scale (a
# random LPS->LPS generator), where one f32 ulp is ~0.008
REL_TOL = 1e-5


def close(got, want):
    return (got.shape == want.shape and len(want) > 0
            and np.abs(got - want).max() <= REL_TOL * np.abs(want).max())


def drive(pool, waves, blocks, late=None):
    """Open a lane per wave (``late``: the index of a wave opened only
    after the first close), feed each at its own block size in turns,
    close each as it runs out; returns the per-stream waves."""
    outs = [[] for _ in waves]
    pos = [0] * len(waves)
    sids = {i: pool.open() for i in range(len(waves)) if i != late}
    while sids:
        for i in list(sids):
            if pos[i] < len(waves[i]):
                outs[i].append(pool.feed(sids[i],
                                         waves[i][pos[i]:pos[i] + blocks[i]]))
                pos[i] += blocks[i]
            else:
                outs[i].append(pool.close(sids.pop(i)))
                if late is not None and late not in sids and not pos[late]:
                    sids[late] = pool.open()   # reuses the freed lane
    return [np.concatenate(o) for o in outs]


def test_pool_matches_jax_pool():
    params = lps_params()
    waves = [noisy_speech(n, 10 + i)
             for i, n in enumerate((9000, 14500, 5200, 7300))]
    (inp, lab), (jinp, jlab) = wave_cmvns(waves)
    blocks = [1600, 900, 2400, 1111]
    ours = StreamPool(params, inp, lab, frame_opts=NODITHER,
                      chunk_frames=16, capacity=3, device="cpu")
    theirs = JaxPool(params, jinp, jlab, frame_opts=JAX_NODITHER,
                     chunk_frames=16, capacity=3)
    got = drive(ours, waves, blocks, late=3)
    want = drive(theirs, waves, blocks, late=3)
    for g, w in zip(got, want):
        assert close(g, w)
    assert (ours.steps_run, ours.frames_run) == (theirs.steps_run,
                                                 theirs.frames_run)
    assert ours.active == 0


def test_pool_matches_single_streams():
    """Each pooled stream against its own single-stream enhancer."""
    params = lps_params()
    waves = [noisy_speech(9000, 10), noisy_speech(5200, 12)]
    (inp, lab), _ = wave_cmvns(waves)
    pool = StreamPool(params, inp, lab, frame_opts=NODITHER,
                      chunk_frames=16, capacity=4, device="cpu")
    got = drive(pool, waves, [1600, 2400])
    for g, w in zip(got, waves):
        single = StreamingWavEnhancer(params, inp, lab, frame_opts=NODITHER,
                                      chunk_frames=16, device="cpu")
        outs = [single.process(w[lo:lo + 1600])
                for lo in range(0, len(w), 1600)]
        want = np.concatenate(outs + [single.flush()])
        assert close(g, want)


def test_reused_lane_starts_from_zero_state():
    """A stream opened in a used lane equals the first stream on it, and
    the lane's state was zeroed on open (nothing else is reset)."""
    params = lps_params()
    (inp, lab), _ = cmvns(4)
    wave = noisy_speech(6000, 13)
    pool = StreamPool(params, inp, lab, frame_opts=NODITHER,
                      chunk_frames=8, capacity=2, device="cpu")
    other = pool.open()
    pool.feed(other, noisy_speech(3000, 14))
    sid = pool.open()
    first = np.concatenate([pool.feed(sid, wave), pool.close(sid)])
    warm = [t[other].clone() for ch in pool._state for t in ch]
    assert any(bool(t.abs().sum() > 0) for t in warm)
    sid2 = pool.open()
    assert sid2 == sid
    assert all(bool((t[sid2] == 0).all()) for ch in pool._state for t in ch)
    assert all(bool((t[other] == w).all()) for t, w in zip(
        (t for ch in pool._state for t in ch), warm))
    second = np.concatenate([pool.feed(sid2, wave), pool.close(sid2)])
    np.testing.assert_array_equal(first, second)


def test_capacity_errors_and_idle_lanes():
    params = lps_params()
    (inp, lab), _ = cmvns(5)
    pool = StreamPool(params, inp, lab, frame_opts=NODITHER,
                      chunk_frames=32, capacity=2, device="cpu")
    a, b = pool.open(), pool.open()
    with pytest.raises(RuntimeError, match="full"):
        pool.open()
    few = NODITHER.window_size + 3 * NODITHER.window_shift  # 4 frames
    assert len(pool.feed(a, noisy_speech(few, 14))) == 0
    assert pool.steps_run == 0   # less than a chunk runs no step
    pool.feed(a, noisy_speech(32 * NODITHER.window_shift + 2000, 15))
    assert pool.steps_run >= 1
    assert len(pool.poll(b)) == 0
    pool.close(a)
    with pytest.raises(ValueError, match="not open"):
        pool.feed(a, np.zeros(100, np.float32))
    with pytest.raises(ValueError, match="not open"):
        pool.close(a)
    with pytest.raises(ValueError, match="not open"):
        pool.poll(a)
    assert pool.active == 1
    pool.close(b)
    assert pool.active == 0
    with pytest.raises(ValueError, match="capacity"):
        StreamPool(params, inp, lab, frame_opts=NODITHER, capacity=0,
                   device="cpu")


def test_thread_driven_streams():
    """One thread per stream: the lock serializes open, feed and
    close, and every stream equals its dedicated single-stream result."""
    params = lps_params()
    waves = [noisy_speech(n, 20 + i) for i, n in enumerate((7000, 4200,
                                                            9800))]
    (inp, lab), _ = wave_cmvns(waves)
    pool = StreamPool(params, inp, lab, frame_opts=NODITHER,
                      chunk_frames=16, capacity=3, device="cpu")
    results, errors = [None] * len(waves), []

    def run(i):
        try:
            rng = np.random.default_rng(100 + i)
            sid, outs, pos = pool.open(), [], 0
            while pos < len(waves[i]):
                n = int(rng.integers(300, 2500))
                outs.append(pool.feed(sid, waves[i][pos:pos + n]))
                pos += n
            outs.append(pool.close(sid))
            results[i] = np.concatenate(outs)
        except Exception as e:  # surfaced by the main thread
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(waves))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    for i, w in enumerate(waves):
        single = StreamingWavEnhancer(params, inp, lab, frame_opts=NODITHER,
                                      chunk_frames=16, device="cpu")
        want = np.concatenate([single.process(w), single.flush()])
        assert results[i] is not None and close(results[i], want)
