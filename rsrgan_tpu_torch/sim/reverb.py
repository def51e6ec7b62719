"""Reverberant-corpus simulation: RIR convolution and SNR noise mixing
(numpy copy of ``rsrgan_tpu/sim/reverb.py``; on the same
``np.random.Generator`` it draws in the same order and writes the same
samples).

The Kaldi ``wav-reverberate`` pipeline of the reference
(reverberate/steps/data/reverberate_bash.py:200-383,
reverberate/run.sh:25-64), executed directly:

* rir_list / noise_list parsing of Kaldi option-string manifests
  (``--rir-id ... --room-id ... path.wav``), with probability smoothing
  (reverberate_bash.py:508-623)
* room -> RIR sampling by probability (PickItemWithProbability, :154)
* FFT convolution of speech with the RIR, output shifted by the RIR peak
  (--shift-output=true) and power-normalized to the dry input
  (--normalize-output=true)
* point-source noises convolved with an RIR **from the speech's room**
  (:215-216) and mixed at an SNR drawn uniformly from [lower, upper];
  background noises span the speech from t=0, foreground noises keep
  their own duration and start at ``round(random()*speech_dur, 2)``
  seconds (:218-227)
* isotropic noises are room-linked (:267-281), mixed unconvolved over the
  full duration
* SNR energy basis per Kaldi ``wav-reverberate``: with an RIR, every
  additive noise is scaled against the DRY signal's early-reverberation
  energy (``ComputeEarlyReverbEnergy``, 1 ms before to 50 ms after the
  RIR's peak), and ``--normalize-output=true`` scales the FINAL mixture
  back to the dry power (:219-227,377). When the speech stays dry (no
  rooms, or the rvb probability not drawn) the basis is the current
  mixture's power at mix time and no global renormalization runs.

The convolutions are host rFFTs in float64 (``fft_convolve``); corpus
generation is a host loop over utterances.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# manifest parsing (option-string format)
# ---------------------------------------------------------------------------

def _parse_option_line(line: str) -> Tuple[Dict[str, str], str]:
    """``--key value ... path`` -> ({key: value}, path)."""
    tokens = line.strip().split()
    opts: Dict[str, str] = {}
    rest: List[str] = []
    i = 0
    while i < len(tokens):
        if tokens[i].startswith("--"):
            opts[tokens[i][2:].replace("-", "_")] = tokens[i + 1]
            i += 2
        else:
            rest.append(tokens[i])
            i += 1
    return opts, " ".join(rest)


@dataclass
class Rir:
    rir_id: str
    room_id: str
    location: str
    probability: float = 0.0


@dataclass
class Room:
    room_id: str
    rirs: List[Rir] = field(default_factory=list)
    probability: float = 0.0


@dataclass
class Noise:
    noise_id: str
    location: str
    noise_type: str = "point-source"  # or "isotropic"
    bg_fg_type: str = "background"
    room_linkage: Optional[str] = None
    probability: float = 0.0


def _smooth_probabilities(items, smoothing: float = 0.3) -> None:
    """Probability smoothing per reverberate_bash.py:508-560: unspecified
    probabilities get uniform mass; specified ones are renormalized and
    blended with uniform by ``smoothing``."""
    n = len(items)
    if n == 0:
        return
    given = [it.probability for it in items if it.probability > 0]
    if not given:
        for it in items:
            it.probability = 1.0 / n
        return
    total = sum(it.probability for it in items)
    for it in items:
        base = it.probability / total if total > 0 else 1.0 / n
        it.probability = ((1.0 - smoothing) * base + smoothing / n)
    total = sum(it.probability for it in items)
    for it in items:
        it.probability /= total


def parse_rir_list(path: str) -> List[Room]:
    rooms: Dict[str, Room] = {}
    rirs: List[Rir] = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            opts, location = _parse_option_line(line)
            rir = Rir(rir_id=opts.get("rir_id", location),
                      room_id=opts.get("room_id", "room0"),
                      location=location,
                      probability=float(opts.get("probability", 0.0)))
            rirs.append(rir)
    _smooth_probabilities(rirs)
    for rir in rirs:
        room = rooms.setdefault(rir.room_id, Room(rir.room_id))
        room.rirs.append(rir)
        room.probability += rir.probability
    return list(rooms.values())


def parse_noise_list(path: str) -> Tuple[List[Noise],
                                         Dict[str, List[Noise]]]:
    """-> (pointsource_noise_list, iso_noise_dict) keyed by room-id.

    Mirrors ParseNoiseList (reverberate_bash.py:575-623): isotropic
    noises REQUIRE --room-linkage and go into the per-room dict (each
    room's probabilities normalized separately); point-source noises form
    a flat smoothed list.
    """
    pointsource: List[Noise] = []
    iso_noise_dict: Dict[str, List[Noise]] = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            opts, location = _parse_option_line(line)
            noise = Noise(
                noise_id=opts.get("noise_id", location),
                location=location,
                noise_type=opts.get("noise_type", "point-source"),
                bg_fg_type=opts.get("bg_fg_type", "background"),
                room_linkage=opts.get("room_linkage"),
                probability=float(opts.get("probability", 0.0)))
            if noise.noise_type == "isotropic":
                if noise.room_linkage is None:
                    raise ValueError(
                        "--room-linkage must be specified if --noise-type "
                        f"is isotropic ({noise.noise_id})")
                iso_noise_dict.setdefault(noise.room_linkage,
                                          []).append(noise)
            else:
                pointsource.append(noise)
    _smooth_probabilities(pointsource)
    for room_noises in iso_noise_dict.values():
        _smooth_probabilities(room_noises)
    return pointsource, iso_noise_dict


def pick_item_with_probability(rng: np.random.Generator, items):
    """PickItemWithProbability (reverberate_bash.py:154-166)."""
    p = np.array([getattr(it, "probability") for it in items])
    p = p / p.sum()
    return items[int(rng.choice(len(items), p=p))]


# ---------------------------------------------------------------------------
# DSP
# ---------------------------------------------------------------------------

def fft_convolve(signal: np.ndarray, kernel: np.ndarray,
                 out_len: Optional[int] = None) -> np.ndarray:
    """Linear convolution via a power-of-two zero-padded rFFT, on the
    host in float64. Corpus corruption convolves each utterance once, so
    a device version would pay a host -> device -> host round trip per
    convolution, and numpy's float64 rFFT is more accurate than a float32
    one.
    """
    n = len(signal) + len(kernel) - 1
    out_len = out_len or n
    nfft = 1 << (n - 1).bit_length()
    full = np.fft.irfft(np.fft.rfft(signal, nfft) * np.fft.rfft(kernel, nfft),
                        nfft)[:n].astype(np.float32)
    return full[:out_len]


def reverberate(speech: np.ndarray, rir: np.ndarray,
                shift_output: bool = True,
                normalize_output: bool = True) -> np.ndarray:
    """wav-reverberate core: convolve, undo propagation delay, renormalize
    power to the dry signal (--shift-output / --normalize-output)."""
    wet = fft_convolve(speech, rir, len(speech) + len(rir) - 1)
    if shift_output:
        shift = int(np.argmax(np.abs(rir)))
        wet = wet[shift:shift + len(speech)]
    else:
        wet = wet[:len(speech)]
    if normalize_output:
        p_in = float(np.sum(speech ** 2))
        p_out = float(np.sum(wet ** 2))
        if p_out > 0:
            wet = wet * np.sqrt(p_in / p_out)
    return wet


def early_reverb_energy(speech: np.ndarray, rir: np.ndarray,
                        sample_rate: int,
                        sec_before_peak: float = 0.001,
                        sec_after_peak: float = 0.05) -> float:
    """Kaldi wav-reverberate's ``ComputeEarlyReverbEnergy``: mean power of
    the DRY signal convolved with the early RIR segment (1 ms before to
    50 ms after the signed peak). This is the signal-energy basis every
    additive noise's SNR is computed against when an RIR is in play
    (semantics invoked by the commands built at
    reverberate_bash.py:219-227)."""
    peak = int(np.argmax(rir))  # signed max, per Kaldi Vector::Max
    start = max(0, peak - int(sec_before_peak * sample_rate))
    end = min(len(rir), peak + int(sec_after_peak * sample_rate))
    early = np.ascontiguousarray(rir[start:end], dtype=np.float32)
    early_rev = fft_convolve(speech, early, len(speech))
    return float(np.mean(early_rev ** 2))


def extend_to_duration(noise: np.ndarray, length: int) -> np.ndarray:
    """wav-reverberate --duration=t semantics: loop the signal from its
    start to reach ``length`` samples, or truncate from the start
    (no random crop offset)."""
    if len(noise) >= length:
        return noise[:length]
    reps = -(-length // len(noise))
    return np.tile(noise, reps)[:length]


def mix_at_snr(speech: np.ndarray, noise: np.ndarray, snr_db: float,
               start_time: int = 0,
               extend: bool = False,
               signal_power: Optional[float] = None) -> np.ndarray:
    """Add ``noise`` scaled so that 10log10(P_signal/P_noise) == snr_db.

    ``extend=True`` (background/isotropic noises) loops the noise to cover
    ``speech`` fully from ``start_time``; ``extend=False`` (foreground)
    keeps the noise's own duration, truncating whatever runs past the end
    of the speech (reverberate_bash.py:218-227 / wav-reverberate
    --start-times behavior).

    ``signal_power`` is the Kaldi ``AddNoise`` path: the fixed energy
    basis (the dry signal's early-reverberation energy) with the noise's
    power taken over the full prepared noise even if its tail is
    truncated at the end of the speech. ``None`` keeps the legacy basis:
    the current mixture's full-length power against the mixed segment.
    """
    room = len(speech) - start_time
    if room <= 0:
        return speech
    if extend:
        segment = extend_to_duration(noise, room)
    else:
        segment = noise[:room]
    if signal_power is None:
        p_signal = float(np.mean(speech ** 2))
        p_noise = float(np.mean(segment ** 2))
    else:
        p_signal = signal_power
        p_noise = float(np.mean((noise if not extend else segment) ** 2))
    if p_noise <= 0 or p_signal <= 0:
        return speech
    scale = np.sqrt(p_signal / (p_noise * (10.0 ** (snr_db / 10.0))))
    out = speech.copy()
    out[start_time:start_time + len(segment)] += scale * segment
    return out


@dataclass
class SimulationOptions:
    """reverberate/run.sh:26-47 parameters."""

    foreground_snr_bounds: Tuple[float, float] = (5.0, 20.0)
    background_snr_bounds: Tuple[float, float] = (5.0, 20.0)
    speech_rvb_probability: float = 1.0
    pointsource_noise_addition_probability: float = 1.0
    isotropic_noise_addition_probability: float = 1.0
    max_noises_added: int = 1
    shift_output: bool = True
    normalize_output: bool = True
    sample_rate: int = 16000
    seed: int = 1


def corrupt_utterance(speech: np.ndarray, rooms: Sequence[Room],
                      pointsource_noises: Sequence[Noise],
                      iso_noise_dict: Dict[str, List[Noise]],
                      opts: SimulationOptions,
                      rng: np.random.Generator,
                      read_wav_fn) -> np.ndarray:
    """One utterance through the reverberate+noise pipeline
    (GenerateReverberationOpts semantics, reverberate_bash.py:241-303).

    Placement rules (all from the reference):
    * the room and speech RIR are drawn ONCE, even when the speech itself
      is not reverberated (:260-262) — they anchor the noise placement;
    * isotropic noise comes from ``iso_noise_dict[speech_rir.room_id]``,
      is never convolved, spans the full duration from t=0 (:267-281);
    * every point-source noise is convolved with an RIR from the SAME
      room (:215-216); background ones span the full duration from t=0,
      foreground ones keep their duration and start at
      ``round(random()*speech_dur, 2)`` seconds (:218-227);
    * noise convolution runs with wav-reverberate's own defaults
      (normalize on, no peak shift) — the speech-level --shift-output /
      --normalize-output flags apply to the speech only (:219-224 build
      bare ``--impulse-response`` commands);
    * when the speech IS reverberated, every noise's SNR scale uses the
      dry signal's early-reverberation energy (wav-reverberate
      ``ComputeEarlyReverbEnergy``) and --normalize-output scales the
      FINAL mixture back to the dry power — one wav-reverberate call
      carries the RIR, the noises and the normalize flag (:219-227,377).
    """
    out = speech.astype(np.float32)
    speech_dur = len(speech) / float(opts.sample_rate)
    power_before = float(np.mean(out ** 2))
    signal_power = None  # per-mix current power (dry-speech extension path)
    reverberated = False
    room = speech_rir_entry = None
    if rooms:
        room = pick_item_with_probability(rng, rooms)
        speech_rir_entry = pick_item_with_probability(rng, room.rirs)
        if rng.random() < opts.speech_rvb_probability:
            speech_rir = read_wav_fn(speech_rir_entry.location)
            signal_power = early_reverb_energy(out, speech_rir,
                                               opts.sample_rate)
            out = reverberate(out, speech_rir, opts.shift_output,
                              normalize_output=False)
            reverberated = True

    # No rooms (simulate --noise_list without --rir_list, an extension
    # past the reference's always-reverberant recipe): the speech stays
    # dry, point-source noises mix unconvolved, and room-linked
    # isotropic noises have no room to come from.
    iso_list = (iso_noise_dict.get(speech_rir_entry.room_id, [])
                if speech_rir_entry is not None else [])
    if iso_list and (rng.random()
                     < opts.isotropic_noise_addition_probability):
        noise_entry = pick_item_with_probability(rng, iso_list)
        noise = read_wav_fn(noise_entry.location).astype(np.float32)
        snr = float(rng.uniform(*opts.background_snr_bounds))
        out = mix_at_snr(out, noise, snr, start_time=0, extend=True,
                         signal_power=signal_power)

    if (pointsource_noises
            and rng.random() < opts.pointsource_noise_addition_probability
            and opts.max_noises_added >= 1):
        num = int(rng.integers(1, opts.max_noises_added + 1))
        for _ in range(num):
            noise_entry = pick_item_with_probability(rng,
                                                     pointsource_noises)
            noise = read_wav_fn(noise_entry.location).astype(np.float32)
            if room is not None:
                noise_rir = read_wav_fn(
                    pick_item_with_probability(rng, room.rirs).location)
                noise = reverberate(noise, noise_rir, shift_output=False,
                                    normalize_output=True)
            if noise_entry.bg_fg_type == "background":
                snr = float(rng.uniform(*opts.background_snr_bounds))
                out = mix_at_snr(out, noise, snr, start_time=0,
                                 extend=True, signal_power=signal_power)
            else:
                snr = float(rng.uniform(*opts.foreground_snr_bounds))
                # uniform sampling — the reference fork's change vs stock
                # Kaldi's cycled list
                start_sec = round(float(rng.random()) * speech_dur, 2)
                start = min(int(start_sec * opts.sample_rate),
                            len(speech))
                out = mix_at_snr(out, noise, snr, start_time=start,
                                 extend=False, signal_power=signal_power)
    if reverberated and opts.normalize_output:
        power_after = float(np.mean(out ** 2))
        if power_after > 0:
            out = out * np.sqrt(power_before / power_after)
    return out
