"""The recipes' wave-to-score chains through the port's CLIs.

    python -m rsrgan_tpu_torch.tools.e2e_chain --target=mfcc|lps \\
        --workdir=DIR [--epochs=20 --num_utts=96 --val_size=12 \\
        --device=cuda]

``--target=mfcc`` runs ``recipes/run_e2e_sim.sh`` (the wav -> ark chain,
257-dim LPS of corrupted speech -> 40-dim clean MFCC), ``--target=lps``
``recipes/run_enhance_demo.sh`` (LPS -> LPS, then back to waves). Stage
by stage, with the recipes' flags letter for letter and ``--device``
added where a stage computes on the device:

0. clean speech, rooms and noises (``sim.make_sim_assets``, seed 11 for
   mfcc, 23 for lps);
1. ``cli.simulate`` (reverb + noise);
2. ``cli.extract``: LPS inputs, then MFCC (mfcc) or LPS (lps) labels,
   with CMVN; for mfcc also the no-enhancement MFCC of the corrupted
   audio;
3. ``cli.prepare``: cmvn, split, the tr/cv stores and the test store;
4. ``cli.train --trainer=gan_rnn --g_type=res_lstm_l`` (the flagship
   LSGAN);
5. ``cli.train --decode`` of the held-out corrupted utterances;
6. (lps) ``cli.resynth`` of the enhanced LPS with the noisy phase;
7. (lps) the four ``cli.score`` calls.

Then the recipe's gate: mfcc, the enhanced-vs-clean MFCC MSE below the
no-enhancement MSE and below 0.8 x the predict-the-mean MSE; lps, the
enhanced LSD below the corrupted LSD. Prints one JSON line with each
stage's seconds, the rates, the gate's numbers and ``passed``; exits 1
when the gate fails. The recipes' waits between stages are dropped.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
from typing import Callable, Dict, List, Optional

import numpy as np

from rsrgan_tpu_torch.tools.recipe_stages import (StageTimer, call,
                                                  filter_scp,
                                                  prepare_stores,
                                                  read_jsonl, score_summary)

ASSET_SEED = {"mfcc": 11, "lps": 23}
SAVE_NAME = {"mfcc": "gan_res_lstm_l", "lps": "gan_lps2lps"}
OUTPUT_DIM = {"mfcc": 40, "lps": 257}


def recipe_train_flags(target: str, train_dir: str, save_dir: str,
                       epochs: int) -> List[str]:
    """Stage 4 of both recipes (``--output_dim`` by target)."""
    return ["--trainer=gan_rnn", "--g_type=res_lstm_l",
            f"--data_dir={train_dir}",
            f"--tr_list_file={train_dir}/tr.list",
            f"--cv_list_file={train_dir}/cv.list",
            f"--save_dir={save_dir}",
            "--batch_size=4",
            "--g_learning_rate=0.0003", "--d_learning_rate=0.001",
            "--disc_updates=1", "--gen_updates=2",
            "--init_mse_weight=10.0",
            "--input_dim=257", f"--output_dim={OUTPUT_DIM[target]}",
            f"--min_epoches={epochs}", f"--max_epoches={epochs}",
            "--init_disc_noise_std=0.05",
            "--lstm_impl=wavefront", "--l2_scale=0.0"]


def recipe_decode_flags(target: str, train_dir: str,
                        save_dir: str) -> List[str]:
    """Stage 5 of both recipes."""
    return ["--decode", "--trainer=gan_rnn", "--g_type=res_lstm_l",
            f"--data_dir={train_dir}",
            f"--test_list_file={train_dir}/test.list",
            f"--save_dir={save_dir}",
            "--input_dim=257", f"--output_dim={OUTPUT_DIM[target]}",
            "--batch_size=1", "--decode_batch_size=4",
            "--lstm_impl=wavefront"]


def mfcc_gate(clean: Dict[str, np.ndarray], enhanced: Dict[str, np.ndarray],
              rvb: Dict[str, np.ndarray]) -> dict:
    """``run_e2e_sim.sh`` stage 6 on {utt: matrix} dicts: per-utterance
    MSEs averaged over utterances."""
    if clean.keys() != enhanced.keys():
        raise ValueError("decoded utterances differ from the cv labels")
    mse_model, mse_mean, mse_noenh = [], [], []
    for u in clean:
        y, g = clean[u], enhanced[u]
        if y.shape != g.shape:
            raise ValueError(f"{u}: enhanced {g.shape} vs clean {y.shape}")
        r = rvb[u][:len(y)]
        mse_model.append(np.mean((g - y) ** 2))
        mse_mean.append(np.mean((y.mean(axis=0) - y) ** 2))
        mse_noenh.append(np.mean((r - y[:len(r)]) ** 2))
    out = {"mse_model": float(np.mean(mse_model)),
           "mse_mean": float(np.mean(mse_mean)),
           "mse_noenh": float(np.mean(mse_noenh))}
    out["passed"] = bool(out["mse_model"] < out["mse_noenh"]
                         and out["mse_model"] < 0.8 * out["mse_mean"])
    return out


def lsd_gate(noisy_rows: List[dict], enhanced_rows: List[dict]) -> dict:
    """``run_enhance_demo.sh``'s gate on the per-utterance JSON rows of
    the two feats-mode ``cli.score`` calls."""
    noisy = float(np.mean([r["lsd_db"] for r in noisy_rows]))
    enh = float(np.mean([r["lsd_db"] for r in enhanced_rows]))
    return {"lsd_corrupted_db": noisy, "lsd_enhanced_db": enh,
            "passed": bool(enh < noisy)}


def read_feats(scp: str) -> Dict[str, np.ndarray]:
    from rsrgan_tpu_torch.data import ScpReader
    return {u: np.asarray(m) for u, m in ScpReader(scp)}


def run_chain(target: str, workdir: str, epochs: int = 20,
              num_utts: int = 96, val_size: int = 12,
              device: str = "cuda", assets: Optional[dict] = None,
              train_flags: Optional[List[str]] = None,
              decode_flags: Optional[List[str]] = None,
              stage_context: Callable = contextlib.nullcontext) -> dict:
    """Both recipes' stages in order; returns the result line's dict.

    ``assets`` overrides ``make_sim_assets``'s keywords; ``train_flags``
    and ``decode_flags`` replace the recipes' stage 4 and 5 flags (the
    CPU-sized chain of the tests); ``stage_context(name)`` wraps each
    stage (chip_smoke.py counts kernel launches in it)."""
    from rsrgan_tpu_torch.cli import extract, resynth, simulate
    from rsrgan_tpu_torch.cli import train
    from rsrgan_tpu_torch.sim import make_sim_assets

    if target not in ASSET_SEED:
        raise ValueError(f"--target must be mfcc or lps, not {target}")
    if os.path.exists(workdir):
        shutil.rmtree(workdir)
    os.makedirs(workdir)
    sim = os.path.join(workdir, "sim")
    train_dir = os.path.join(workdir, "data", "train")
    save_dir = os.path.join(workdir, "exp", SAVE_NAME[target])
    os.makedirs(train_dir)
    timer = StageTimer(stage_context)
    stage, secs = timer.stage, timer.secs

    with stage("assets"):
        kw = dict(min_dur_s=1.2, max_dur_s=3.0, seed=ASSET_SEED[target])
        kw.update(assets or {})
        make_sim_assets(sim, num_utts=num_utts, **kw)

    with stage("simulate"):
        call(simulate.main, [f"--wav_scp={sim}/clean/wav.scp",
                             f"--rir_list={sim}/rir_list",
                             f"--noise_list={sim}/noise_list",
                             f"--output_dir={sim}/rvb",
                             "--foreground_snrs=5:20",
                             "--background_snrs=5:20",
                             "--random_seed=1"], "simulate")

    label_type = "mfcc" if target == "mfcc" else "spectrogram"
    extractions = [
        ("extract_inputs", f"{sim}/rvb/wav.scp", "spectrogram", train_dir,
         "inputs", True),
        ("extract_labels", f"{sim}/clean/wav.scp", label_type, train_dir,
         "labels", True)]
    if target == "mfcc":   # the no-enhancement baseline
        extractions.append(("extract_baseline", f"{sim}/rvb/wav.scp",
                            "mfcc", f"{workdir}/baseline", "rvb_mfcc",
                            False))
    extract_frames = {}
    for name, scp, feat_type, out_dir, out_name, cmvn in extractions:
        with stage(name):
            call(extract.main,
                 [f"--wav_scp={scp}", f"--feat_type={feat_type}",
                  f"--output_dir={out_dir}", f"--name={out_name}",
                  *(["--accumulate_cmvn"] if cmvn else []),
                  f"--device={device}"], name)
        extract_frames[name] = sum(
            len(m) for m in read_feats(f"{out_dir}/{out_name}.scp").values())

    with stage("prepare"):
        prepare_stores(train_dir, val_size, "prepare")

    with stage("train"):
        call(train.main, (train_flags or recipe_train_flags(
            target, train_dir, save_dir, epochs))
             + [f"--device={device}"], "train")
    with stage("decode"):
        call(train.main, (decode_flags or recipe_decode_flags(
            target, train_dir, save_dir)) + [f"--device={device}"],
             "decode")

    rows = read_jsonl(f"{save_dir}/metrics_train.jsonl")
    fps = [r["train_frames_per_sec"] for r in rows]
    result = {"target": target, "utterances": num_utts, "epochs": len(rows),
              "device": device,
              "extract_frames": extract_frames,
              "extract_frames_per_s": {k: n / secs[k] for k, n in
                                       extract_frames.items()},
              "train_frames_per_s_last": fps[-1],
              "train_frames_per_s_median": float(np.median(fps)),
              "g_loss_first_last": [rows[0]["g_loss"], rows[-1]["g_loss"]]}

    if target == "mfcc":
        gate = mfcc_gate(read_feats(f"{train_dir}/cv/labels.scp"),
                         read_feats(f"{save_dir}/test/feats.scp"),
                         read_feats(f"{workdir}/baseline/rvb_mfcc.scp"))
    else:
        noisy_scp = f"{workdir}/cv_noisy_wav.scp"
        clean_scp = f"{workdir}/cv_clean_wav.scp"
        with stage("resynth"):
            filter_scp(f"{train_dir}/cv/inputs.scp", f"{sim}/rvb/wav.scp",
                       noisy_scp)
            filter_scp(f"{train_dir}/cv/inputs.scp", f"{sim}/clean/wav.scp",
                       clean_scp)
            call(resynth.main, [f"--enhanced_scp={save_dir}/test/feats.scp",
                                f"--wav_scp={noisy_scp}",
                                f"--out_dir={save_dir}/test/wav"], "resynth")
        with stage("score"):
            score_summary(["--mode", "feats",
                           f"--est_scp={train_dir}/cv/inputs.scp",
                           f"--ref_scp={train_dir}/cv/labels.scp",
                           f"--per_utt={workdir}/score_noisy_feats.jsonl"])
            score_summary(["--mode", "feats",
                           f"--est_scp={save_dir}/test/feats.scp",
                           f"--ref_scp={train_dir}/cv/labels.scp",
                           f"--per_utt={workdir}/score_enh_feats.jsonl"])
            result["wav_noisy"] = score_summary(
                ["--mode", "wav", f"--est_scp={noisy_scp}",
                 f"--ref_scp={clean_scp}"])
            result["wav_enhanced"] = score_summary(
                ["--mode", "wav", f"--est_scp={save_dir}/test/wav/wav.scp",
                 f"--ref_scp={clean_scp}"])
        gate = lsd_gate(read_jsonl(f"{workdir}/score_noisy_feats.jsonl"),
                        read_jsonl(f"{workdir}/score_enh_feats.jsonl"))
    result.update(gate=gate, passed=gate["passed"], stage_seconds=secs,
                  seconds=timer.seconds())
    return result


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rsrgan_tpu_torch.tools.e2e_chain",
                                description=__doc__.splitlines()[0])
    p.add_argument("--target", choices=["mfcc", "lps"], required=True)
    p.add_argument("--workdir", required=True,
                   help="emptied first, as the recipes do")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--num_utts", type=int, default=96)
    p.add_argument("--val_size", type=int, default=12)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    result = run_chain(args.target, args.workdir, args.epochs,
                       args.num_utts, args.val_size, args.device)
    print(json.dumps(result), flush=True)
    return 0 if result["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
