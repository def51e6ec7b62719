"""rsrgan_tpu_torch/tools/ablation_table.py against tools/ablation_table.py
on the same per-utterance JSONL dumps (tests/test_ablation_table.py's
keys): ablation.md and ablation.json byte-equal, the same stdout,
stderr and exit code, for every gate outcome, the sweep and aggregate
rows, with and without proxy.json, and the environments the three
recipes set."""

import json
import os
import shutil
import sys

import numpy as np
import pytest

from rsrgan_tpu_torch.tools import ablation_table as port_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import ablation_table as ref_table  # noqa: E402


def write_jsonl(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def make_workdir(w, gan_lsd=7.0, gan_estoi=0.65, wav=True, proxy=None,
                 extra=()):
    """feats mode: lsd_db, mse, gv_ratio; wav mode: snr/si_snr/seg_snr,
    stoi, estoi (None where STOI was undefined)."""
    os.makedirs(w)
    rng = np.random.default_rng(0)
    systems = [("noisy", 20.0, 2.0, 1.10, 0.47), ("mse", 9.0, 0.4, 0.62,
                                                    0.60),
               ("gan", gan_lsd, 0.45, 0.91, gan_estoi)]
    systems += [(name, 8.0 + i, 0.5, 0.95, 0.6 - 0.01 * i)
                for i, name in enumerate(extra)]
    for name, lsd, mse, gv, st in systems:
        write_jsonl(f"{w}/feats_{name}.jsonl",
                    [{"utt_id": f"u{i}", "lsd_db": lsd + rng.normal(0, .1),
                      "mse": mse, "gv_ratio": gv} for i in range(10)])
        if wav:
            write_jsonl(f"{w}/wav_{name}.jsonl",
                        [{"utt_id": f"u{i}", "snr_db": 5.0,
                          "si_snr_db": 4.0 + rng.normal(0, 1),
                          "seg_snr_db": 3.0,
                          "stoi": None if i == 3 else st,
                          "estoi": None if i == 3 else
                          st - 0.05 + rng.normal(0, .01)}
                         for i in range(10)])
    if proxy is not None:
        with open(f"{w}/proxy.json", "w") as f:
            json.dump(proxy, f)


def proxy_dump(names, clean=True):
    rng = np.random.default_rng(1)
    systems = {n: {"fer": round(float(rng.uniform(0.2, 0.9)), 4),
                   "ser": round(float(rng.uniform(0.1, 0.9)), 4),
                   "frames": 900, "segments": 80} for n in names}
    if clean:
        systems["clean"] = {"fer": 0.05, "ser": 0.03, "frames": 900,
                            "segments": 80}
    return {"classes": 16, "context": 2, "systems": systems}


SWEEP = ("gan_w3_s777", "gan_w10_s778", "mse_s778")
BASE = ("noisy", "mse", "gan")
CASES = {
    "gates_pass": (dict(), [], {}),
    "lsd_gate_fails": (dict(gan_lsd=19.0), [], {}),
    "estoi_gate_fails": (dict(gan_estoi=0.48), [], {}),
    "both_gates_fail": (dict(gan_lsd=19.0, gan_estoi=0.48), [], {}),
    "no_estoi_sentinel": (dict(wav=False), [],
                          {"ABLATION_MIN_ESTOI_DELTA": "-1",
                           "ABLATION_MAX_LSD_RATIO": "0.9"}),
    "no_estoi_threshold_zero": (dict(wav=False), [],
                                {"ABLATION_MIN_ESTOI_DELTA": "0"}),
    "no_estoi_default_threshold": (dict(wav=False), [], {}),
    "extra_rows": (dict(extra=SWEEP),
                   ["--extra=gan_w3_s777:LSGAN(w=3,seed=777)",
                    "--extra=gan_w10_s778:LSGAN(w=10,seed=778)",
                    "--extra=mse_s778:MSE(seed=778)",
                    "--extra=gan_cond"], {}),
    "aggregate_rows": (dict(extra=SWEEP),
                       ["--extra=gan_w10_s778:LSGAN(w=10,seed=778)",
                        "--extra=mse_s778:MSE(seed=778)",
                        "--aggregate=LSGAN mean±spread (2 seeds):"
                        "gan,gan_w10_s778",
                        "--aggregate=MSE mean±spread (2 seeds):"
                        "mse,mse_s778",
                        "--aggregate=empty:nothing"], {}),
    "proxy_present": (dict(extra=SWEEP,
                           proxy=proxy_dump(BASE + SWEEP)),
                      ["--extra=gan_w10_s778:LSGAN(w=10,seed=778)",
                       "--aggregate=LSGAN mean±spread (2 seeds):"
                       "gan,gan_w10_s778"], {}),
    "proxy_without_clean": (dict(proxy=proxy_dump(BASE, clean=False)),
                            [], {}),
    "ref_scale_env": (dict(wav=False, proxy=proxy_dump(BASE)), [],
                      {"ABLATION_MIN_ESTOI_DELTA": "-1",
                       "ABLATION_MAX_LSD_RATIO": "0.9"}),
    "ref_scale_env_gate_fails": (dict(wav=False, gan_lsd=19.0,
                                      proxy=proxy_dump(BASE)), [],
                                 {"ABLATION_MIN_ESTOI_DELTA": "-1",
                                  "ABLATION_MAX_LSD_RATIO": "0.9"}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_port_table_equals_tools_table(tmp_path, monkeypatch, capsys,
                                       case):
    kw, extra, env = CASES[case]
    for k in ("ABLATION_MIN_ESTOI_DELTA", "ABLATION_MAX_LSD_RATIO"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    outs = {}
    for side, mod in (("ref", ref_table), ("port", port_table)):
        w = str(tmp_path / side)
        make_workdir(w, **kw)
        argv = [w, f"--train_dir={w}/data/train", f"--gan_dir={w}/exp/gan",
                f"--mse_dir={w}/exp/mse", *extra]
        rc = mod.main(argv)
        cap = capsys.readouterr()
        files = {n: open(f"{w}/{n}", "rb").read()
                 for n in ("ablation.md", "ablation.json")}
        outs[side] = (rc, cap.out, cap.err, files)
        shutil.rmtree(w)
    assert outs["port"] == outs["ref"]
    rc, out, err, files = outs["port"]
    assert rc == (0 if "ABLATION QUALITY CHECK PASSED" in out else 1)
    if case in ("gates_pass", "no_estoi_sentinel", "ref_scale_env"):
        assert rc == 0 and err == ""
    if "fails" in case or case == "no_estoi_default_threshold":
        assert rc == 1 and "FAIL" in err
    table = files["ablation.md"].decode()
    for spec in extra:
        label = spec.split("=", 1)[1].rpartition(":")
        label = label[0] if spec.startswith("--aggregate") else (
            label[2] or label[0])
        assert f"| {label} |" in table
    assert ("proxy FER" in table) == ("proxy" in kw)
