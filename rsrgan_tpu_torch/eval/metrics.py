"""Objective enhancement metrics: SNR, SI-SNR, segmental SNR, LSD,
feature MSE and the global-variance ratio (numpy copy of
``rsrgan_tpu/eval/metrics.py``).

The reference judges enhanced features only by the WER of an external
Kaldi ASR decode; these metrics make quality measurable inside the
framework (``cli/score.py`` and the chain's gates). Plain numpy on the
host: scoring is offline and O(n).
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-10


def _align(est: np.ndarray, ref: np.ndarray):
    n = min(len(est), len(ref))
    return (np.asarray(est[:n], np.float64),
            np.asarray(ref[:n], np.float64))


def snr(est: np.ndarray, ref: np.ndarray) -> float:
    """Plain SNR in dB: 10log10(||ref||^2 / ||ref-est||^2)."""
    est, ref = _align(est, ref)
    return float(10.0 * np.log10(
        (np.sum(ref ** 2) + _EPS) / (np.sum((ref - est) ** 2) + _EPS)))


def si_snr(est: np.ndarray, ref: np.ndarray) -> float:
    """Scale-invariant SNR (Le Roux et al. 2019) in dB.

    Both signals are zero-meaned; the reference is rescaled to the
    orthogonal projection of the estimate, so gain differences don't
    count as error.
    """
    est, ref = _align(est, ref)
    est = est - est.mean()
    ref = ref - ref.mean()
    target = (np.dot(est, ref) / (np.dot(ref, ref) + _EPS)) * ref
    noise = est - target
    return float(10.0 * np.log10(
        (np.sum(target ** 2) + _EPS) / (np.sum(noise ** 2) + _EPS)))


def seg_snr(est: np.ndarray, ref: np.ndarray, frame_len: int = 400,
            frame_shift: int = 160, floor_db: float = -10.0,
            ceil_db: float = 35.0) -> float:
    """Segmental SNR in dB: mean of per-frame SNRs clamped to
    [floor_db, ceil_db] (the classical guard against silence frames
    dominating the average). Defaults match the 25 ms / 10 ms analysis
    framing.
    """
    est, ref = _align(est, ref)
    n = len(ref)
    if n < frame_len:
        return snr(est, ref)
    starts = np.arange(0, n - frame_len + 1, frame_shift)
    idx = starts[:, None] + np.arange(frame_len)[None, :]
    r, e = ref[idx], est[idx]
    per = 10.0 * np.log10((np.sum(r ** 2, axis=1) + _EPS)
                          / (np.sum((r - e) ** 2, axis=1) + _EPS))
    return float(np.mean(np.clip(per, floor_db, ceil_db)))


def lsd_from_lps(lps_est: np.ndarray, lps_ref: np.ndarray,
                 skip_first_bin: bool = True) -> float:
    """Log-spectral distance in dB from natural-log power spectra.

    LSD = mean over frames of sqrt(mean over bins of (10log10 Pe -
    10log10 Pr)^2). ``skip_first_bin`` excludes slot 0, which holds the
    raw frame log energy (not a spectral bin) under the extraction
    default ``raw_energy=True``.
    """
    a = np.asarray(lps_est, np.float64)
    b = np.asarray(lps_ref, np.float64)
    t = min(a.shape[0], b.shape[0])
    a, b = a[:t], b[:t]
    if a.shape != b.shape:
        raise ValueError(f"LPS shapes differ: {a.shape} vs {b.shape}")
    if skip_first_bin:
        a, b = a[:, 1:], b[:, 1:]
    db = (10.0 / np.log(10.0)) * (a - b)
    return float(np.mean(np.sqrt(np.mean(db ** 2, axis=1))))


def variance_ratio(est: np.ndarray, ref: np.ndarray,
                   skip_first_bin: bool = True) -> float:
    """Global-variance ratio: mean over bins of std_t(est)/std_t(ref).

    The classic over-smoothing diagnostic for regression-trained
    spectral mappers: minimizing MSE drives the estimate toward the
    conditional mean, which has LESS temporal variance per bin than
    real clean speech (ratio < 1); adversarial objectives are motivated
    precisely by restoring that natural variance (the reference's LSGAN
    objective, models/gan_rnn_placeholder.py:244-260,
    exists to sharpen the over-smoothed MSE solution). 1.0 = matches
    the clean spectra's dynamics; the metric is orthogonal to LSD/MSE,
    which reward the over-smoothed solution.

    ``skip_first_bin`` excludes slot 0 (raw frame energy under the
    extraction default), matching ``lsd_from_lps``.
    """
    a = np.asarray(est, np.float64)
    b = np.asarray(ref, np.float64)
    t = min(a.shape[0], b.shape[0])
    a, b = a[:t], b[:t]
    if a.shape != b.shape:
        raise ValueError(f"feature shapes differ: {a.shape} vs {b.shape}")
    if skip_first_bin:
        a, b = a[:, 1:], b[:, 1:]
    return float(np.mean(a.std(axis=0) / (b.std(axis=0) + _EPS)))


def feature_mse(est: np.ndarray, ref: np.ndarray) -> float:
    """Mean squared error over aligned feature frames (any feature kind)."""
    a = np.asarray(est, np.float64)
    b = np.asarray(ref, np.float64)
    t = min(a.shape[0], b.shape[0])
    return float(np.mean((a[:t] - b[:t]) ** 2))
