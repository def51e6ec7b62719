"""Short-Time Objective Intelligibility (STOI) and extended STOI (numpy
and scipy copy of ``rsrgan_tpu/eval/stoi.py``).

Implements the published algorithms directly from the papers:

- STOI: Taal, Hendriks, Heusdens, Jensen, "An Algorithm for
  Intelligibility Prediction of Time-Frequency Weighted Noisy Speech",
  IEEE TASLP 2011 — 10 kHz analysis, 256/128 Hann frames with 512-pt
  FFT, 15 one-third-octave bands from 150 Hz, 40 dB silent-frame
  removal keyed on the clean signal, 384 ms (N=30 frame) segments,
  clean-energy normalization with -15 dB SDR clipping, averaged
  band/segment correlation.
- ESTOI: Jensen, Taal, "An Algorithm for Predicting the Intelligibility
  of Speech Masked by Modulated Noise Maskers", IEEE TASLP 2016 — same
  front-end, no clipping, row+column normalized spectrogram segments.

These are the standard intelligibility metrics in the dereverberation
literature the reference targets (its own evaluation is only an external
Kaldi ASR decode, the reference's README.md:36-48). PESQ remains out of
scope: ITU-T P.862 reference code is licensed. Without a third-party
STOI implementation to compare with, correctness is guarded by
property tests (tests/test_eval.py: identity ~= 1, monotone in SNR,
silence invariance) plus VALUE-ANCHORED cases pinned to the papers'
formulas: hand-derived one-third-octave band-to-bin ranges (2011 Sec.
II-A), an exact Pearson-0.5 segment construction and an engaged
-15 dB-clip case (2011 eqs. 4-5), and ESTOI's exact per-band gain
invariance (2016 eqs. 2-4).

Deviations from the common `pystoi` implementation: regularization uses
a deterministic epsilon instead of random dither (scores are
reproducible), and too-short inputs raise ValueError instead of
returning a sentinel.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

_EPS = 1e-12

FS = 10000          # analysis rate (Hz)
FRAME_LEN = 256     # 25.6 ms
HOP = 128
NFFT = 512
NUM_BANDS = 15
MIN_CF = 150.0      # lowest one-third-octave center frequency (Hz)
SEG_FRAMES = 30     # 384 ms intermediate-intelligibility segments
DYN_RANGE_DB = 40.0
BETA_DB = -15.0     # SDR clipping bound (STOI only)


def _hann(n: int) -> np.ndarray:
    # MATLAB hanning(n): symmetric, endpoints excluded.
    return np.hanning(n + 2)[1:-1]


def _frame(x: np.ndarray, win: np.ndarray) -> np.ndarray:
    n = 1 + (len(x) - FRAME_LEN) // HOP if len(x) >= FRAME_LEN else 0
    if n <= 0:
        return np.zeros((0, FRAME_LEN))
    idx = np.arange(n)[:, None] * HOP + np.arange(FRAME_LEN)[None, :]
    return x[idx] * win[None, :]


def _remove_silent_frames(x: np.ndarray, y: np.ndarray):
    """Drop frames whose CLEAN energy is >40 dB below the loudest frame,
    then overlap-add the kept (windowed) frames back into signals."""
    win = _hann(FRAME_LEN)
    xf, yf = _frame(x, win), _frame(y, win)
    if len(xf) == 0:
        raise ValueError(
            f"signal too short for STOI: {len(x)} samples at {FS} Hz, "
            f"need >= {FRAME_LEN} (one analysis frame)")
    energies_db = 20.0 * np.log10(np.linalg.norm(xf, axis=1) + _EPS)
    mask = energies_db > energies_db.max() - DYN_RANGE_DB
    xf, yf = xf[mask], yf[mask]

    def ola(frames: np.ndarray) -> np.ndarray:
        out = np.zeros((len(frames) - 1) * HOP + FRAME_LEN)
        for i, fr in enumerate(frames):
            out[i * HOP:i * HOP + FRAME_LEN] += fr
        return out

    if len(xf) == 0:
        raise ValueError("no frames above the 40 dB dynamic range "
                         "(clean signal is silent)")
    return ola(xf), ola(yf)


def _third_octave_matrix() -> np.ndarray:
    """(NUM_BANDS, NFFT//2+1) 0/1 matrix grouping FFT bins into
    one-third-octave bands; edges snapped to the nearest bin."""
    f = np.linspace(0, FS, NFFT + 1)[:NFFT // 2 + 1]
    k = np.arange(NUM_BANDS)
    f_low = MIN_CF * 2.0 ** ((2.0 * k - 1.0) / 6.0)
    f_high = MIN_CF * 2.0 ** ((2.0 * k + 1.0) / 6.0)
    obm = np.zeros((NUM_BANDS, len(f)))
    for i in range(NUM_BANDS):
        lo = int(np.argmin((f - f_low[i]) ** 2))
        hi = int(np.argmin((f - f_high[i]) ** 2))
        obm[i, lo:hi] = 1.0
    return obm


def _band_spectrogram(x: np.ndarray, obm: np.ndarray) -> np.ndarray:
    """(NUM_BANDS, M) one-third-octave band magnitudes of x."""
    frames = _frame(x, _hann(FRAME_LEN))
    spec = np.abs(np.fft.rfft(frames, NFFT)) ** 2        # (M, NFFT/2+1)
    return np.sqrt(obm @ spec.T + _EPS)                   # (J, M)


def _resample(x: np.ndarray, fs: int) -> np.ndarray:
    if fs == FS:
        return np.asarray(x, np.float64)
    from scipy.signal import resample_poly
    frac = Fraction(FS, int(fs))
    return resample_poly(np.asarray(x, np.float64),
                         frac.numerator, frac.denominator)


def _segments(tob: np.ndarray) -> np.ndarray:
    """(n_segs, J, N) sliding N-frame segments of a (J, M) band spec."""
    m = tob.shape[1]
    if m < SEG_FRAMES:
        raise ValueError(
            f"signal too short for STOI: {m} analysis frames after "
            f"silence removal, need >= {SEG_FRAMES} (~{SEG_FRAMES * HOP / FS:.2f} s "
            f"of active speech)")
    return np.stack([tob[:, i:i + SEG_FRAMES]
                     for i in range(m - SEG_FRAMES + 1)])


def _tf_segments(est: np.ndarray, ref: np.ndarray, fs: int):
    """Shared front-end: resample, silence-remove, band spectrograms,
    segment. Returns (clean_segments, degraded_segments), each (S, J, N)."""
    est, ref = np.asarray(est, np.float64), np.asarray(ref, np.float64)
    n = min(len(est), len(ref))
    est, ref = _resample(est[:n], fs), _resample(ref[:n], fs)
    ref, est = _remove_silent_frames(ref, est)
    obm = _third_octave_matrix()
    return (_segments(_band_spectrogram(ref, obm)),
            _segments(_band_spectrogram(est, obm)))


def _stoi_score(x: np.ndarray, y: np.ndarray) -> float:
    alpha = np.sqrt(np.sum(x ** 2, axis=2, keepdims=True)
                    / (np.sum(y ** 2, axis=2, keepdims=True) + _EPS))
    y_prime = np.minimum(alpha * y, x * (1.0 + 10.0 ** (-BETA_DB / 20.0)))
    xc = x - x.mean(axis=2, keepdims=True)
    yc = y_prime - y_prime.mean(axis=2, keepdims=True)
    xc = xc / (np.linalg.norm(xc, axis=2, keepdims=True) + _EPS)
    yc = yc / (np.linalg.norm(yc, axis=2, keepdims=True) + _EPS)
    return float(np.sum(xc * yc) / (NUM_BANDS * x.shape[0]))


def _estoi_score(x: np.ndarray, y: np.ndarray) -> float:
    def row_col_norm(a):
        a = a - a.mean(axis=2, keepdims=True)
        a = a / (np.linalg.norm(a, axis=2, keepdims=True) + _EPS)
        a = a - a.mean(axis=1, keepdims=True)
        return a / (np.linalg.norm(a, axis=1, keepdims=True) + _EPS)
    return float(np.sum(row_col_norm(x) * row_col_norm(y))
                 / (SEG_FRAMES * x.shape[0]))


def stoi(est: np.ndarray, ref: np.ndarray, fs: int = FS,
         extended: bool = False) -> float:
    """Intelligibility of ``est`` (degraded/enhanced) given clean ``ref``.

    Returns a correlation-based score, roughly in [0, 1] (higher is more
    intelligible; identical signals score 1.0). ``fs`` is the input
    sample rate; anything != 10 kHz is polyphase-resampled first.
    """
    x, y = _tf_segments(est, ref, fs)
    return _estoi_score(x, y) if extended else _stoi_score(x, y)


def estoi(est: np.ndarray, ref: np.ndarray, fs: int = FS) -> float:
    """Extended STOI (Jensen & Taal 2016)."""
    return stoi(est, ref, fs=fs, extended=True)


def stoi_both(est: np.ndarray, ref: np.ndarray, fs: int = FS):
    """(stoi, estoi) sharing one front-end pass — the resample /
    silence-removal / spectrogram work dominates, so scoring both this
    way costs ~half of two separate calls."""
    x, y = _tf_segments(est, ref, fs)
    return _stoi_score(x, y), _estoi_score(x, y)
