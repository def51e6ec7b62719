"""The ablation recipes' table and quality gate (counterpart of
``tools/ablation_table.py``: the same flags, files, lines and exit code).

    python -m rsrgan_tpu_torch.tools.ablation_table WORKDIR \
        --train_dir=DIR --gan_dir=DIR --mse_dir=DIR \
        [--extra=NAME[:LABEL] ...] [--aggregate=LABEL:N1,N2 ...]

Reads the per-utterance JSONL dumps written by cli.score in stage 7 and
emits `ablation.md` (markdown table) + `ablation.json` under the workdir,
then asserts the enhancement wins are unambiguous (thresholds overridable
via env for smoke runs: ABLATION_MAX_LSD_RATIO, ABLATION_MIN_ESTOI_DELTA).
``proxy.json`` (``tools.proxy_asr``), where it is there, adds the proxy
FER and SER columns.

This is the evidence for the reference's core claim (LSGAN beats plain
MSE regression for dereverberation, the reference README's results):
same corpus, same generator, same held-out set — only the training
objective differs. numpy only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

SYSTEMS = ["noisy", "mse", "gan"]
LABELS = {"noisy": "no enhancement", "mse": "MSE (run_rnn.sh schedule)",
          "gan": "LSGAN (flagship schedule)"}


def _means(path):
    if not os.path.exists(path):
        return {}
    rows = [json.loads(line) for line in open(path)]
    keys = [k for k in rows[0] if k != "utt_id"]
    out = {}
    for k in keys:
        vals = [r[k] for r in rows if r.get(k) is not None
                and np.isfinite(r[k])]
        out[k] = float(np.mean(vals)) if vals else None
    out["num_utts"] = len(rows)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("workdir")
    p.add_argument("--train_dir", required=True)
    p.add_argument("--gan_dir", required=True)
    p.add_argument("--mse_dir", required=True)
    p.add_argument("--extra", action="append", default=[],
                   metavar="NAME[:LABEL]",
                   help="additional system rows (sweep/seed runs) read "
                        "from feats_NAME.jsonl / wav_NAME.jsonl")
    p.add_argument("--aggregate", action="append", default=[],
                   metavar="LABEL:NAME1,NAME2",
                   help="mean ± half-range row over member systems "
                        "(seed-variance reporting)")
    args = p.parse_args(argv)
    w = args.workdir

    systems = list(SYSTEMS)
    labels = dict(LABELS)
    for spec in args.extra:
        name, _, label = spec.partition(":")
        systems.append(name)
        labels[name] = label or name

    stats = {}
    for sys_name in systems:
        stats[sys_name] = {**_means(f"{w}/feats_{sys_name}.jsonl"),
                           **_means(f"{w}/wav_{sys_name}.jsonl")}

    # recognition-proxy scores (tools.proxy_asr), if that stage ran
    proxy = {}
    if os.path.exists(f"{w}/proxy.json"):
        with open(f"{w}/proxy.json") as f:
            proxy = json.load(f).get("systems", {})
        for sys_name in systems:
            if sys_name in proxy:
                stats[sys_name]["proxy_fer"] = proxy[sys_name]["fer"]
                stats[sys_name]["proxy_ser"] = proxy[sys_name]["ser"]

    cols = [("feature-MSE", "mse", "{:.4f}"),
            ("LSD (dB)", "lsd_db", "{:.3f}"),
            ("GV ratio", "gv_ratio", "{:.4f}"),
            ("SI-SNR (dB)", "si_snr_db", "{:.2f}"),
            ("STOI", "stoi", "{:.4f}"),
            ("ESTOI", "estoi", "{:.4f}")]
    if proxy:
        cols += [("proxy FER", "proxy_fer", "{:.4f}"),
                 ("proxy SER", "proxy_ser", "{:.4f}")]
    lines = ["| system | " + " | ".join(c[0] for c in cols) + " |",
             "|---|" + "---|" * len(cols)]
    for sys_name in systems:
        row = [labels[sys_name]]
        for _, key, fmt in cols:
            v = stats[sys_name].get(key)
            row.append(fmt.format(v) if v is not None else "—")
        lines.append("| " + " | ".join(row) + " |")
    for spec in args.aggregate:
        label, _, members = spec.partition(":")
        names = [m for m in members.split(",") if m in stats]
        row = [label]
        agg = {}
        for _, key, fmt in cols:
            vals = [stats[m][key] for m in names
                    if stats[m].get(key) is not None]
            if not vals:
                row.append("—")
                continue
            mid = float(np.mean(vals))
            half = (max(vals) - min(vals)) / 2.0
            agg[key] = (mid, half)
            row.append(f"{fmt.format(mid)} ± {fmt.format(half).lstrip('-')}")
        lines.append("| " + " | ".join(row) + " |")
        stats[f"agg:{label}"] = {k: v[0] for k, v in agg.items()}
        stats[f"agg:{label}:spread"] = {k: v[1] for k, v in agg.items()}
    table = "\n".join(lines)
    if proxy.get("clean"):
        table += (f"\n\nProxy classifier ceiling on clean held-out "
                  f"features: FER {proxy['clean']['fer']:.4f}, "
                  f"SER {proxy['clean']['ser']:.4f} "
                  f"({proxy['clean']['segments']} segments).")

    noisy, mse, gan = stats["noisy"], stats["mse"], stats["gan"]
    derived = {}
    if gan.get("lsd_db") and noisy.get("lsd_db"):
        derived["gan_lsd_ratio"] = round(gan["lsd_db"] / noisy["lsd_db"], 4)
        derived["mse_lsd_ratio"] = round(mse["lsd_db"] / noisy["lsd_db"], 4)
    if gan.get("estoi") is not None and noisy.get("estoi") is not None:
        derived["gan_estoi_delta"] = round(gan["estoi"] - noisy["estoi"], 4)
        derived["mse_estoi_delta"] = round(mse["estoi"] - noisy["estoi"], 4)
        derived["gan_vs_mse_estoi"] = round(gan["estoi"] - mse["estoi"], 4)
    if gan.get("gv_ratio") is not None and mse.get("gv_ratio") is not None:
        # over-smoothing: |1 - GV| measures distance from the clean
        # spectra's temporal dynamics (MSE regression under-shoots it;
        # the adversarial term exists to restore it)
        derived["gan_gv_gap"] = round(abs(1.0 - gan["gv_ratio"]), 4)
        derived["mse_gv_gap"] = round(abs(1.0 - mse["gv_ratio"]), 4)
    if gan.get("proxy_fer") is not None and mse.get("proxy_fer") is not None:
        # the recognition axis (the reference's actual claim is ASR WER)
        derived["gan_vs_mse_proxy_fer"] = round(
            gan["proxy_fer"] - mse["proxy_fer"], 4)
        derived["gan_vs_mse_proxy_ser"] = round(
            gan["proxy_ser"] - mse["proxy_ser"], 4)

    md = (f"# Ablation: {LABELS['gan']} vs {LABELS['mse']} vs baseline\n\n"
          f"Held-out set: {noisy.get('num_utts', 0)} utterances, "
          f"same corpus / generator / decode for both systems.\n\n"
          f"{table}\n\nDerived: {json.dumps(derived)}\n")
    with open(f"{w}/ablation.md", "w") as f:
        f.write(md)
    with open(f"{w}/ablation.json", "w") as f:
        json.dump({"systems": stats, "derived": derived}, f, indent=1)
    print(md)

    max_ratio = float(os.environ.get("ABLATION_MAX_LSD_RATIO", "0.45"))
    min_delta = float(os.environ.get("ABLATION_MIN_ESTOI_DELTA", "0.03"))
    ok = True
    if derived.get("gan_lsd_ratio", 1.0) >= max_ratio:
        print(f"FAIL: GAN LSD ratio {derived.get('gan_lsd_ratio')} >= "
              f"{max_ratio}", file=sys.stderr)
        ok = False
    estoi_delta = derived.get("gan_estoi_delta")
    if estoi_delta is None:
        # feature-only runs (e.g. the MFCC config, not resynthesizable)
        # disable this gate with an explicit NEGATIVE sentinel; any
        # threshold >= 0 (including 0 = "GAN must not lose to noisy")
        # demands the metric exist
        if min_delta >= 0:
            print(f"FAIL: ESTOI gate set ({min_delta}) but no ESTOI "
                  f"scores found", file=sys.stderr)
            ok = False
    elif estoi_delta <= min_delta:
        print(f"FAIL: GAN ESTOI delta {estoi_delta} <= "
              f"{min_delta}", file=sys.stderr)
        ok = False
    if ok:
        print("ABLATION QUALITY CHECK PASSED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
