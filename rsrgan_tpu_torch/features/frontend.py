"""Kaldi-parity frame extraction and log-power-spectrum features, in
PyTorch on any device (port of ``rsrgan_tpu/features/frontend.py``).

Replaces Kaldi's ``compute-spectrogram-feats`` for the 257-dim LPS inputs,
with feat/feature-window.cc + feature-spectrogram.cc semantics:

frame -> [dither] -> remove DC -> (raw log energy) -> preemphasis
      -> window (povey/hamming/...) -> zero-pad to 2^k -> rFFT
      -> power -> floor(eps) -> log ; feature[0] = raw log energy

Every step is a batched tensor op over ``[B, F, W]`` frames, so one call
extracts a stack of equal-length waves on the card (``cli/extract.py``).
The options, the window and the frame count are numpy, shared with
``features/resynth.py``. Dither draws from one ``torch.Generator`` per
row: the JAX package draws it from ``jax.random``, whose stream torch
cannot reproduce, so parity with it holds at ``dither=0``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

# float32 machine epsilon: Kaldi's power floor (std::numeric_limits<float>::epsilon)
EPS_F32 = float(np.finfo(np.float32).eps)


@dataclass(frozen=True)
class FrameOptions:
    """Kaldi FrameExtractionOptions (defaults for 16 kHz)."""

    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    dither: float = 1.0
    preemph_coeff: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"
    round_to_power_of_two: bool = True
    snip_edges: bool = True

    @property
    def window_size(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_length_ms)

    @property
    def window_shift(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_shift_ms)

    @property
    def padded_window_size(self) -> int:
        if not self.round_to_power_of_two:
            return self.window_size
        n = 1
        while n < self.window_size:
            n *= 2
        return n


def feature_window(opts: FrameOptions) -> np.ndarray:
    """The analysis window (feature-window.cc FeatureWindowFunction)."""
    N = opts.window_size
    n = np.arange(N, dtype=np.float64)
    a = 2.0 * math.pi / (N - 1)
    if opts.window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * n)
    elif opts.window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * n)
    elif opts.window_type == "povey":  # like hanning^0.85, Kaldi default
        w = (0.5 - 0.5 * np.cos(a * n)) ** 0.85
    elif opts.window_type == "rectangular":
        w = np.ones(N)
    elif opts.window_type == "blackman":
        coeff = 0.42
        w = (coeff - 0.5 * np.cos(a * n)
             + (0.5 - coeff) * np.cos(2 * a * n))
    else:
        raise ValueError(f"unknown window type {opts.window_type}")
    return w.astype(np.float32)


def num_frames(num_samples: int, opts: FrameOptions) -> int:
    """Frame count under snip_edges semantics (feature-window.cc NumFrames)."""
    if opts.snip_edges:
        if num_samples < opts.window_size:
            return 0
        return 1 + (num_samples - opts.window_size) // opts.window_shift
    return (num_samples + opts.window_shift // 2) // opts.window_shift


def frame_indices(num_samples: int, opts: FrameOptions) -> np.ndarray:
    """[num_frames, window_size] sample indices of each frame.

    snip_edges=True: frames fully inside the wave. snip_edges=False:
    frames centered at shift*(t+0.5) with Kaldi edge reflection
    (feature-window.cc ExtractWindow: idx<0 -> -idx-1, idx>=n -> 2n-1-idx).
    """
    n = num_frames(num_samples, opts)
    if opts.snip_edges:
        starts = np.arange(n) * opts.window_shift
        return starts[:, None] + np.arange(opts.window_size)[None, :]
    mid = np.arange(n) * opts.window_shift + opts.window_shift // 2
    starts = mid - opts.window_size // 2
    idx = starts[:, None] + np.arange(opts.window_size)[None, :]
    idx = np.where(idx < 0, -idx - 1, idx)
    return np.where(idx >= num_samples, 2 * num_samples - 1 - idx, idx)


def extract_frames(wave: torch.Tensor, opts: FrameOptions) -> torch.Tensor:
    """[..., num_samples] -> [..., num_frames, window_size] raw frames."""
    idx = frame_indices(int(wave.shape[-1]), opts)
    return wave[..., torch.from_numpy(idx).to(wave.device)]


def dither_noise(shape: Sequence[int],
                 generators: Sequence[torch.Generator],
                 device: torch.device) -> torch.Tensor:
    """[B, *shape] standard normal noise, row b drawn from
    ``generators[b]`` alone: a row's noise depends only on its generator
    and the shape, so a wave gets the same dither in any batch."""
    return torch.stack([torch.randn(tuple(shape), generator=g,
                                    device=device, dtype=torch.float32)
                        for g in generators])


def process_frames(frames: torch.Tensor, opts: FrameOptions,
                   generators: Optional[Sequence[torch.Generator]] = None,
                   return_log_energy: bool = True):
    """Dither / DC removal / raw energy / preemphasis / windowing.

    Port of feature-window.cc ProcessWindow over ``[..., F, W]`` frames
    (``[B, F, W]`` with one generator per row, or ``[F, W]`` with one).
    Returns (windowed [..., F, W], raw_log_energy [..., F] or None).
    Dither is applied only when generators are given and opts.dither > 0.
    """
    frames = frames.to(torch.float32)
    if generators is not None and opts.dither != 0.0:
        noise = dither_noise(frames.shape[-2:], generators, frames.device)
        frames = frames + opts.dither * noise.reshape(frames.shape)
    if opts.remove_dc_offset:
        frames = frames - torch.mean(frames, dim=-1, keepdim=True)

    log_energy = None
    if return_log_energy:
        energy = torch.clamp(torch.sum(frames * frames, dim=-1),
                             min=EPS_F32)
        log_energy = torch.log(energy)

    if opts.preemph_coeff != 0.0:
        shifted = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - opts.preemph_coeff * shifted

    window = torch.from_numpy(feature_window(opts)).to(frames.device)
    return frames * window, log_energy


def power_spectrum(windowed: torch.Tensor,
                   opts: FrameOptions) -> torch.Tensor:
    """[..., F, win] windowed frames -> [..., F, nfft/2+1] power."""
    spec = torch.fft.rfft(windowed, n=opts.padded_window_size, dim=-1)
    return spec.real ** 2 + spec.imag ** 2


@dataclass(frozen=True)
class SpectrogramOptions:
    frame_opts: FrameOptions = FrameOptions()
    energy_floor: float = 0.0
    raw_energy: bool = True

    @property
    def dim(self) -> int:
        return self.frame_opts.padded_window_size // 2 + 1


def compute_spectrogram(
        wave: torch.Tensor,
        opts: SpectrogramOptions = SpectrogramOptions(),
        generators: Optional[Sequence[torch.Generator]] = None
) -> torch.Tensor:
    """Log-power-spectrum features (compute-spectrogram-feats parity).

    [B, num_samples] (or [num_samples]) float32 wave, 16-bit PCM scale,
    on any device -> [B, num_frames, 257] (or [num_frames, 257]) LPS.
    ``generators``: one per row for dither, or None for none.
    """
    frames = extract_frames(wave, opts.frame_opts)
    windowed, log_energy = process_frames(
        frames, opts.frame_opts, generators,
        return_log_energy=opts.raw_energy)
    power = power_spectrum(windowed, opts.frame_opts)
    feats = torch.log(torch.clamp(power, min=EPS_F32))
    if opts.raw_energy:
        if opts.energy_floor > 0.0:
            log_energy = torch.clamp(log_energy,
                                     min=math.log(opts.energy_floor))
        feats = torch.cat([log_energy.unsqueeze(-1), feats[..., 1:]],
                          dim=-1)
    return feats


def seeded_generators(seeds: Sequence[int],
                      device: torch.device) -> list:
    """One ``torch.Generator`` on ``device`` per seed."""
    return [torch.Generator(device=device).manual_seed(int(s))
            for s in seeds]


def compute_spectrogram_np(wave: np.ndarray,
                           opts: SpectrogramOptions = SpectrogramOptions(),
                           seed: Optional[int] = None) -> np.ndarray:
    """CPU convenience wrapper (deterministic unless a seed is given)."""
    gens = (seeded_generators([seed], torch.device("cpu"))
            if seed is not None else None)
    return compute_spectrogram(
        torch.from_numpy(np.asarray(wave, np.float32)), opts, gens).numpy()
