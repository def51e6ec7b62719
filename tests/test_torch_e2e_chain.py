"""The recipes' chains through the port (``tools/e2e_chain.py``) on the
CPU: the CPU-sized chain of tests/test_e2e_sim.py (8 utterances, frame
DNN) for the MFCC target, and the LPS target on the recipe's own flagship
flags at 8 utterances and 2 epochs. Their wave stages (assets and
corruption) are byte-equal to the JAX package's; the gates' arithmetic is
the recipes' heredocs'."""

import json
import os

import numpy as np
import pytest
import torch

from rsrgan_tpu.cli import simulate as jax_simulate
from rsrgan_tpu.sim import make_sim_assets as jax_make_sim_assets
from rsrgan_tpu_torch.data import ScpReader
from rsrgan_tpu_torch.tools import e2e_chain

torch.set_num_threads(2)

ASSETS = dict(min_dur_s=0.6, max_dur_s=1.0, num_rooms=1, rirs_per_room=1,
              seed=5)


def tree_bytes(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = \
                    f.read().replace(root.encode(), b"ROOT")
    return out


def dnn_flags(target, work):
    """tests/test_e2e_sim.py's frame DNN in place of the flagship."""
    td = f"{work}/data/train"
    sd = f"{work}/exp/{e2e_chain.SAVE_NAME[target]}"
    common = ["--trainer=dnn", "--g_type=dnn", f"--data_dir={td}",
              f"--save_dir={sd}", "--input_dim=257",
              f"--output_dim={e2e_chain.OUTPUT_DIM[target]}",
              "--left_context=2", "--right_context=2", "--bf16=false"]
    return (common + [f"--tr_list_file={td}/tr.list",
                      f"--cv_list_file={td}/cv.list", "--batch_size=128",
                      "--g_learning_rate=0.001", "--min_epoches=2",
                      "--max_epoches=2", "--keep_lr=2", "--l2_scale=0.0"],
            ["--decode", *common, f"--test_list_file={td}/test.list",
             "--batch_size=1"])


def jax_wave_stages(work, seed_assets):
    """The recipes' stages 0 and 1 through the JAX package."""
    sim = os.path.join(work, "sim")
    jax_make_sim_assets(sim, num_utts=8, **seed_assets)
    assert jax_simulate.main([f"--wav_scp={sim}/clean/wav.scp",
                              f"--rir_list={sim}/rir_list",
                              f"--noise_list={sim}/noise_list",
                              f"--output_dir={sim}/rvb",
                              "--foreground_snrs=5:20",
                              "--background_snrs=5:20",
                              "--random_seed=1"]) == 0
    return tree_bytes(sim)


def test_mfcc_chain_cpu_sized(tmp_path):
    work = str(tmp_path / "port")
    train, decode = dnn_flags("mfcc", work)
    res = e2e_chain.run_chain("mfcc", work, epochs=2, num_utts=8,
                              val_size=2, device="cpu", assets=ASSETS,
                              train_flags=train, decode_flags=decode)
    assert tree_bytes(os.path.join(work, "sim")) == jax_wave_stages(
        str(tmp_path / "jax"), ASSETS)
    assert list(res["stage_seconds"]) == [
        "assets", "simulate", "extract_inputs", "extract_labels",
        "extract_baseline", "prepare", "train", "decode"]
    frames = res["extract_frames"]
    assert frames["extract_inputs"] == frames["extract_labels"] \
        == frames["extract_baseline"] > 0
    gate = res["gate"]
    assert all(np.isfinite(gate[k]) for k in ("mse_model", "mse_mean",
                                              "mse_noenh"))
    assert res["passed"] == gate["passed"] == (
        gate["mse_model"] < gate["mse_noenh"]
        and gate["mse_model"] < 0.8 * gate["mse_mean"])
    clean = dict(iter(ScpReader(f"{work}/data/train/cv/labels.scp")))
    enhanced = dict(iter(ScpReader(
        f"{work}/exp/gan_res_lstm_l/test/feats.scp")))
    assert clean.keys() == enhanced.keys() and len(clean) == 2
    for u, y in clean.items():
        assert enhanced[u].shape == y.shape == (len(y), 40)
        assert np.isfinite(enhanced[u]).all()


def test_lps_chain_on_recipe_flags(tmp_path):
    """The flagship gan_rnn at the recipe's flags (res_lstm_l, B=4, the
    kernels' plain twins on the CPU), then resynthesis and scoring."""
    work = str(tmp_path / "port")
    res = e2e_chain.run_chain("lps", work, epochs=2, num_utts=8,
                              val_size=2, device="cpu",
                              assets=dict(ASSETS, seed=23))
    assert tree_bytes(os.path.join(work, "sim")) == jax_wave_stages(
        str(tmp_path / "jax"), dict(ASSETS, seed=23))
    assert res["epochs"] == 2 and res["train_frames_per_s_last"] > 0
    assert list(res["stage_seconds"])[-2:] == ["resynth", "score"]
    save = f"{work}/exp/gan_lps2lps/test"
    assert sorted(os.listdir(f"{save}/wav")) == sorted(
        [u + ".wav" for u, _ in ScpReader(f"{save}/feats.scp")]
        + ["wav.scp"])
    for key in ("wav_noisy", "wav_enhanced"):
        assert res[key]["num_utts"] == 2
    gate = res["gate"]
    assert np.isfinite(gate["lsd_corrupted_db"])
    assert res["passed"] == (gate["lsd_enhanced_db"]
                             < gate["lsd_corrupted_db"])
    with open(f"{work}/cv_noisy_wav.scp") as f:
        noisy = [line.split()[0] for line in f]
    with open(f"{work}/data/train/cv/inputs.scp") as f:
        assert noisy == sorted(line.split()[0] for line in f)


def heredoc_mfcc(clean, enhanced, rvb):
    """run_e2e_sim.sh stage 6, transcribed (its asserts as booleans)."""
    assert clean.keys() == enhanced.keys()
    mse_model, mse_mean, mse_noenh = [], [], []
    for u in clean:
        y, g = clean[u], enhanced[u]
        assert y.shape == g.shape, (u, y.shape, g.shape)
        r = rvb[u][:len(y)]
        mse_model.append(np.mean((g - y) ** 2))
        mse_mean.append(np.mean((y.mean(axis=0) - y) ** 2))
        mse_noenh.append(np.mean((r - y[:len(r)]) ** 2))
    mse_model = float(np.mean(mse_model))
    mse_mean = float(np.mean(mse_mean))
    mse_noenh = float(np.mean(mse_noenh))
    return (mse_model, mse_mean, mse_noenh,
            mse_model < mse_noenh and mse_model < 0.8 * mse_mean)


def heredoc_lsd(noisy_lines, enh_lines):
    """run_enhance_demo.sh's last heredoc, on the JSONL lines."""
    def mean_lsd(lines):
        return float(np.mean([json.loads(line)["lsd_db"]
                              for line in lines]))
    noisy, enh = mean_lsd(noisy_lines), mean_lsd(enh_lines)
    return noisy, enh, enh < noisy


@pytest.mark.parametrize("noise", [0.1, 0.6, 3.0])
def test_gates_match_recipe_heredocs(noise):
    rng = np.random.default_rng(int(noise * 10))
    clean = {f"u{i}": rng.normal(size=(30 + 7 * i, 40)) for i in range(5)}
    enhanced = {u: y + noise * rng.normal(size=y.shape)
                for u, y in clean.items()}
    rvb = {u: y[:len(y) - i] + 0.8 * rng.normal(size=(len(y) - i, 40))
           for i, (u, y) in enumerate(clean.items())}
    got = e2e_chain.mfcc_gate(clean, enhanced, rvb)
    assert (got["mse_model"], got["mse_mean"], got["mse_noenh"],
            got["passed"]) == heredoc_mfcc(clean, enhanced, rvb)

    noisy_rows = [{"utt_id": f"u{i}", "lsd_db": float(v)}
                  for i, v in enumerate(rng.uniform(20, 30, size=6))]
    enh_rows = [{"utt_id": r["utt_id"], "lsd_db": r["lsd_db"] * noise / 1.5}
                for r in noisy_rows]
    got = e2e_chain.lsd_gate(noisy_rows, enh_rows)
    assert (got["lsd_corrupted_db"], got["lsd_enhanced_db"],
            got["passed"]) == heredoc_lsd(
        [json.dumps(r) for r in noisy_rows],
        [json.dumps(r) for r in enh_rows])


@pytest.mark.parametrize("passed,rc", [(True, 0), (False, 1)])
def test_main_prints_one_line_and_exits_by_the_gate(monkeypatch, capsys,
                                                    passed, rc):
    seen = {}

    def fake(*args):
        seen["args"] = args
        return {"passed": passed, "gate": {}}
    monkeypatch.setattr(e2e_chain, "run_chain", fake)
    assert e2e_chain.main(["--target=lps", "--workdir=w"]) == rc
    assert seen["args"] == ("lps", "w", 20, 96, 12, "cuda")
    assert json.loads(capsys.readouterr().out) == {"passed": passed,
                                                   "gate": {}}
