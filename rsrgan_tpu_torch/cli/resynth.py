"""Waveform resynthesis CLI: enhanced LPS arks + noisy wavs -> wavs
(port of ``rsrgan_tpu/cli/resynth.py``, the same flags and bytes).

The reference pipeline ends at feature arks for a downstream ASR decoder
(its README.md:36-48); it can never play back what the GAN
did to the signal. This closes the loop:

    python -m rsrgan_tpu_torch.cli.resynth \
        --enhanced_scp exp/test/feats.scp --wav_scp noisy_wav.scp \
        --out_dir exp/test/wav [--no_raw_energy]

Each utterance's enhanced log-power spectrum (decode output, already
CMVN-denormalized by `train --decode`) is combined with the phase of the
paired noisy wav and inverted through the exact analysis chain
(features/resynth.py). Writes <out_dir>/<utt>.wav (16-bit PCM) and
<out_dir>/wav.scp.

The feature dim must be nfft/2+1 (257 at 16 kHz defaults) — i.e. the
model was trained feature-to-feature on LPS targets. MFCC targets are
not invertible (mel+DCT are lossy); use the ASR-feature path for those.
"""

from __future__ import annotations

import argparse
import os
import sys

from rsrgan_tpu_torch.data.kaldi_ark import ScpReader
from rsrgan_tpu_torch.features.frontend import FrameOptions
from rsrgan_tpu_torch.features.resynth import resynthesize
from rsrgan_tpu_torch.sim.wavio import read_wav, write_wav


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rsrgan_tpu_torch.cli.resynth")
    p.add_argument("--enhanced_scp", required=True,
                   help="scp of enhanced (denormalized) LPS features")
    p.add_argument("--wav_scp", required=True,
                   help="scp of the paired NOISY wavs (phase source)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--no_raw_energy", action="store_true",
                   help="extraction ran with raw_energy=false (slot 0 is "
                        "the true DC bin, not frame energy)")
    args = p.parse_args(argv)

    with open(args.wav_scp) as f:
        wav_by_id = dict(line.strip().split(None, 1)
                         for line in f if line.strip())
    feats = ScpReader(args.enhanced_scp)
    os.makedirs(args.out_dir, exist_ok=True)
    opts = FrameOptions()  # resynthesis is dither-free by construction

    out_scp = os.path.join(args.out_dir, "wav.scp")
    n = 0
    with open(out_scp, "w") as scp:
        for utt_id, lps in feats:
            if utt_id not in wav_by_id:
                print(f"WARNING: no noisy wav for {utt_id}; skipped",
                      file=sys.stderr)
                continue
            wave, rate = read_wav(wav_by_id[utt_id])
            if rate != opts.samp_freq:
                print(f"WARNING: {utt_id} rate {rate} != "
                      f"{opts.samp_freq:g}", file=sys.stderr)
            y = resynthesize(lps, wave, opts,
                             raw_energy=not args.no_raw_energy)
            out_path = os.path.join(args.out_dir, f"{utt_id}.wav")
            write_wav(out_path, y, rate=int(rate))
            scp.write(f"{utt_id} {out_path}\n")
            n += 1
    print(f"Resynthesized {n} utterances -> {args.out_dir}")
    return 0 if n else 1


if __name__ == "__main__":
    sys.exit(main())
