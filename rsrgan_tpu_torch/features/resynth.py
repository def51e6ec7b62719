"""Waveform resynthesis from (enhanced) log-power-spectrum features
(numpy and scipy copy of ``rsrgan_tpu/features/resynth.py``).

The reference stops at feature arks for a Kaldi ASR decoder and never
reconstructs audio. This inverts the ``features/frontend.py`` analysis
chain with the standard magnitude-replacement recipe:

    enhanced LPS  -> magnitude  = exp(0.5 * lps)
    noisy wave    -> complex STFT (same analysis chain, no dither)
    S = magnitude * noisy_phase
    S -> irfft -> weighted overlap-add (synthesis window = analysis
    window, normalized by the summed squared window) -> de-emphasis

WOLA with the sum-of-squared-windows denominator reconstructs unmodified
frames exactly (Griffin & Lim's LSEE-MSTFT synthesis), so the only
systematic error sources are the per-frame DC removal / per-frame
preemphasis of the Kaldi analysis chain (both frame-local, smoothed out
by the 60%-overlap WOLA average) and the energy slot: with
``raw_energy=True`` the analysis overwrote bin 0 with the frame log
energy, so the DC magnitude is taken from the noisy spectrum instead.

Plain numpy on the host, as its original: resynthesis is an offline,
O(num_samples) pass over utterances of distinct lengths, and its output
is byte-equal to the JAX package's on the same inputs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from rsrgan_tpu_torch.features.frontend import (EPS_F32, FrameOptions,
                                                feature_window,
                                                frame_indices)


def _process_frames_np(frames: np.ndarray, opts: FrameOptions) -> np.ndarray:
    """Numpy port of frontend.process_frames for the dither-free,
    no-log-energy case (feature-window.cc ProcessWindow): DC removal,
    preemphasis, windowing."""
    frames = np.asarray(frames, np.float32)
    if opts.remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if opts.preemph_coeff != 0.0:
        shifted = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - np.float32(opts.preemph_coeff) * shifted
    window = feature_window(opts).astype(np.float32)
    return frames * window[None, :]


def complex_spectrum(wave: np.ndarray, opts: FrameOptions) -> np.ndarray:
    """[num_samples] -> [num_frames, nfft/2+1] complex STFT.

    Exactly the `compute_spectrogram` analysis chain (DC removal,
    per-frame preemphasis, window, zero-pad to nfft) minus dither, so
    ``|complex_spectrum|**2`` floored at eps equals ``exp(lps)`` of a
    dither-free extraction (bins 1.. when raw_energy replaced bin 0).
    """
    wave = np.asarray(wave, np.float32)
    frames = wave[frame_indices(len(wave), opts)]
    windowed = _process_frames_np(frames, opts)
    return np.fft.rfft(windowed, n=opts.padded_window_size, axis=1)


def overlap_add(frames: np.ndarray, opts: FrameOptions,
                num_samples: Optional[int] = None) -> np.ndarray:
    """WOLA synthesis: [num_frames, window_size] -> [num_samples].

    y[n] = sum_t w[n-tS] * frames[t, n-tS] / sum_t w^2[n-tS], the exact
    inverse of ``x -> w*x`` framing wherever the window-power sum is
    nonzero. Only snip_edges=True framing is supported (the extraction
    default; frame t covers samples [t*S, t*S+window)).
    """
    if not opts.snip_edges:
        raise NotImplementedError("overlap_add requires snip_edges=True")
    frames = np.asarray(frames, np.float64)
    F, W = frames.shape
    S = opts.window_shift
    total = (F - 1) * S + W
    w = feature_window(opts).astype(np.float64)
    idx = (np.arange(F)[:, None] * S + np.arange(W)[None, :]).reshape(-1)
    num = np.zeros((total,))
    np.add.at(num, idx, (frames * w[None, :]).reshape(-1))
    den = np.zeros((total,))
    np.add.at(den, idx, np.broadcast_to(w * w, (F, W)).reshape(-1))
    # Floor the window-power sum at 1% of its peak: at the outermost
    # samples only one window tail covers n and den ~ w[k]^2 -> 0; for
    # MODIFIED spectra (frames no longer exactly w*x) dividing by it
    # amplifies the edge by 1/w[k]. Consistent frames still reconstruct
    # exactly wherever den is above the floor (the whole interior).
    den = np.maximum(den, 0.01 * den.max())
    y = (num / den).astype(np.float32)
    if num_samples is not None:
        y = (y[:num_samples] if total >= num_samples
             else np.pad(y, (0, num_samples - total)))
    return y


def deemphasize(wave: np.ndarray, coeff: float) -> np.ndarray:
    """Host-side inverse of the preemphasis filter: y[n] = x[n]+c*y[n-1]."""
    if coeff == 0.0:
        return np.asarray(wave, np.float32)
    from scipy.signal import lfilter

    return lfilter([1.0], [1.0, -coeff],
                   np.asarray(wave, np.float64)).astype(np.float32)


def resynthesize(lps: np.ndarray, noisy_wave: np.ndarray,
                 opts: FrameOptions = FrameOptions(),
                 raw_energy: bool = True) -> np.ndarray:
    """Enhanced LPS [F, nfft/2+1] + noisy wave -> enhanced wave [n].

    ``raw_energy`` must match the extraction config: when True, feature
    slot 0 holds the frame log energy (not the DC bin), so the DC
    magnitude is carried over from the noisy spectrum.
    """
    lps = np.asarray(lps, np.float32)
    noisy_wave = np.asarray(noisy_wave, np.float32)
    spec = complex_spectrum(noisy_wave, opts)
    F = min(int(spec.shape[0]), lps.shape[0])
    if F == 0:
        return np.zeros((0,), np.float32)
    spec = spec[:F]
    if lps.shape[1] != spec.shape[1]:
        raise ValueError(
            f"LPS dim {lps.shape[1]} != spectrum dim {spec.shape[1]} "
            f"(nfft={opts.padded_window_size}) — enhanced features must "
            "be denormalized log-power spectra from this frame config")
    mag = np.exp(0.5 * np.asarray(lps[:F], np.float64))
    noisy_mag = np.abs(spec)
    if raw_energy:
        mag[:, 0] = noisy_mag[:, 0]
    phase = spec / np.maximum(noisy_mag, np.sqrt(EPS_F32))
    frames = np.fft.irfft(mag * phase, n=opts.padded_window_size,
                          axis=1)[:, :opts.window_size]
    y = overlap_add(frames, opts, num_samples=int(noisy_wave.shape[0]))
    return deemphasize(y, opts.preemph_coeff)
