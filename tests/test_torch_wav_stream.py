"""The port's wav->wav streaming (rsrgan_tpu_torch/serving/wav_stream.py)
against the JAX package's at tests/test_stream_pool.py's sizes (257 bins,
cell 32): the host DSP byte-equal, the streamed waves within 1e-5 of the
peak, the stream against the port's offline chain, emission and the
refusals."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsrgan_tpu.data.cmvn import Cmvn as JaxCmvn
from rsrgan_tpu.features import FrameOptions as JaxFrameOptions
from rsrgan_tpu.models.recurrent import ResLstmGenerator as JaxResLstm
from rsrgan_tpu.serving.wav_stream import StreamingWavEnhancer as JaxWav
from rsrgan_tpu.serving.wav_stream import WavChain as JaxChain
from rsrgan_tpu_torch.data.cmvn import Cmvn
from rsrgan_tpu_torch.eval.metrics import snr
from rsrgan_tpu_torch.features import (FrameOptions, SpectrogramOptions,
                                       compute_spectrogram_np)
from rsrgan_tpu_torch.features.resynth import resynthesize
from rsrgan_tpu_torch.models import ResLstmGenerator, load_flax_params
from rsrgan_tpu_torch.serving.wav_stream import (StreamingWavEnhancer,
                                                 WavChain)

NODITHER = FrameOptions(dither=0.0)
JAX_NODITHER = JaxFrameOptions(dither=0.0)
BINS = 257
SIZES = (1000, 37, 4000, 2500, 160, 8000, 303)   # irregular sample blocks


@functools.lru_cache(maxsize=None)
def lps_params(seed=0, out=BINS):
    """A small LPS->LPS res_lstm_l tree (numpy; the tests only read it)."""
    gen = JaxResLstm(output_dim=out, variant="l", cell_size=32)
    x = jnp.zeros((1, 8, BINS), jnp.float32)
    params = gen.init(jax.random.PRNGKey(seed), x,
                      jnp.full((1,), 8, jnp.int32))["params"]
    return jax.tree.map(np.asarray, dict(params))


def cmvns(seed):
    rng = np.random.default_rng(seed)
    stats = [(rng.normal(size=BINS) * 0.1, 1.0 + 0.05 * rng.random(BINS))
             for _ in range(2)]
    return [Cmvn(*s) for s in stats], [JaxCmvn(*s) for s in stats]


def wave_cmvns(waves):
    """Input and label CMVN of the waves' own LPS, as a server's
    train_cmvn.npz holds them. With cmvns()'s stats (mean 0.1, std 1
    against LPS near 25) the random generator's outputs reach e^13, where
    f32 rounding through exp comes to 1e-5 of the peak; the waves
    comparisons run at the normalized operating point."""
    lps = np.concatenate([compute_spectrogram_np(
        w, SpectrogramOptions(NODITHER)) for w in waves])
    stats = (lps.mean(axis=0), lps.std(axis=0) + 1e-5)
    return (Cmvn(*stats), Cmvn(*stats)), (JaxCmvn(*stats), JaxCmvn(*stats))


def noisy_speech(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = 2000 * np.sin(2 * np.pi * 250 * t) * (0.5 + 0.5 * np.sin(
        2 * np.pi * 3 * t)) + 300 * rng.standard_normal(n)
    return (x - x.mean()).astype(np.float32)


def stream(enh, wave, sizes=SIZES):
    outs, pos = [], 0
    for size in sizes:
        outs.append(enh.process(wave[pos:pos + size]))
        pos += size
    outs.append(enh.process(wave[pos:]))
    outs.append(enh.flush())
    return np.concatenate(outs)


def test_chain_dsp_byte_equal():
    """analyze and synth_frames give JAX's bytes on the same frames."""
    params = lps_params()
    (inp, lab), (jinp, jlab) = cmvns(1)
    ours = WavChain(params, inp, lab, frame_opts=NODITHER)
    theirs = JaxChain(params, jinp, jlab, frame_opts=JAX_NODITHER)
    assert ours.den_floor == theirs.den_floor
    assert ours.window.tobytes() == theirs.window.tobytes()
    wave = noisy_speech(4000, 2)
    W, S = NODITHER.window_size, NODITHER.window_shift
    F = 1 + (len(wave) - W) // S
    frames = wave[np.arange(F)[:, None] * S + np.arange(W)[None, :]]
    (x, spec), (jx, jspec) = ours.analyze(frames), theirs.analyze(frames)
    assert x.dtype == jx.dtype and x.tobytes() == jx.tobytes()
    assert spec.dtype == jspec.dtype and spec.tobytes() == jspec.tobytes()
    enhanced = lab.denormalize(x * 0.9 + 0.1)
    got = ours.synth_frames(enhanced, spec)
    want = theirs.synth_frames(enhanced, jspec)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("chunk_frames", [16, 5])
def test_process_and_flush_match_jax(chunk_frames):
    params = lps_params()
    wave = noisy_speech(16000, 4)
    (inp, lab), (jinp, jlab) = wave_cmvns([wave])
    got = stream(StreamingWavEnhancer(params, inp, lab, frame_opts=NODITHER,
                                      chunk_frames=chunk_frames,
                                      device="cpu"), wave)
    want = stream(JaxWav(params, jinp, jlab, frame_opts=JAX_NODITHER,
                         chunk_frames=chunk_frames), wave)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5


def test_matches_offline_chain():
    """Streamed (irregular sample blocks) against the port's offline
    chain: extract, the whole-utterance generator forward (the model, not
    the streaming code), resynthesize — tests/test_wav_stream.py's 35 dB."""
    params = lps_params()
    (inp, lab), _ = cmvns(1)
    wave = noisy_speech(16000, 2)
    lps = compute_spectrogram_np(wave, SpectrogramOptions(NODITHER,
                                                          raw_energy=True))
    gen = ResLstmGenerator(input_dim=BINS, output_dim=BINS, cell_size=32,
                           lstm_impl="scan")
    load_flax_params(gen, params)
    x = torch.from_numpy(inp.apply(lps).astype(np.float32))[None]
    with torch.no_grad():
        y = gen(x, torch.tensor([x.shape[1]])).numpy()[0]
    offline = resynthesize(lab.denormalize(y), wave, NODITHER,
                           raw_energy=True)
    streamed = stream(StreamingWavEnhancer(params, inp, lab,
                                           frame_opts=NODITHER,
                                           chunk_frames=16, device="cpu"),
                      wave)
    assert min(len(streamed), len(offline)) > 15000
    assert snr(streamed, offline) > 35.0


def test_incremental_emission_and_length():
    params = lps_params()
    (inp, lab), _ = cmvns(3)
    enh = StreamingWavEnhancer(params, inp, lab, frame_opts=NODITHER,
                               chunk_frames=8, device="cpu")
    wave = noisy_speech(16000, seed=4)
    got, emitted_early = 0, False
    for lo in range(0, 16000, 1600):
        out = enh.process(wave[lo:lo + 1600])
        got += len(out)
        emitted_early |= lo < 8000 and len(out) > 0
    got += len(enh.flush())
    assert emitted_early  # bounded latency: output before the end
    F = 1 + (16000 - NODITHER.window_size) // NODITHER.window_shift
    assert got == (F - 1) * NODITHER.window_shift + NODITHER.window_size


def test_reset_reproduces():
    params = lps_params()
    (inp, lab), _ = cmvns(5)
    enh = StreamingWavEnhancer(params, inp, lab, frame_opts=NODITHER,
                               chunk_frames=8, device="cpu")
    wave = noisy_speech(6000, seed=6)
    a = np.concatenate([enh.process(wave), enh.flush()])
    enh.reset()
    b = np.concatenate([enh.process(wave), enh.flush()])
    np.testing.assert_array_equal(a, b)


def test_refusals():
    (inp, lab), _ = cmvns(7)
    with pytest.raises(ValueError, match="output dim"):
        StreamingWavEnhancer(lps_params(out=40), inp, lab,
                             frame_opts=NODITHER, device="cpu")
    params = lps_params()
    with pytest.raises(ValueError, match="dither"):
        StreamingWavEnhancer(params, inp, lab,
                             frame_opts=FrameOptions(dither=1.0),
                             device="cpu")
    with pytest.raises(ValueError, match="snip_edges"):
        StreamingWavEnhancer(params, inp, lab,
                             frame_opts=FrameOptions(dither=0.0,
                                                     snip_edges=False),
                             device="cpu")
