"""The port's scoring and resynthesis (``rsrgan_tpu_torch.eval``,
``features/resynth.py``, ``cli.resynth``, ``cli.score``, ``cli.plot``)
against the JAX package's on the same inputs: every metric, STOI and
ESTOI exactly equal, resynthesized waves and the resynth CLI's files
byte-equal, the score CLI's printed lines, JSON summary and per-utterance
JSONL equal. Mirrors tests/test_eval.py."""

import importlib
import json
import os

import numpy as np
import pytest

from rsrgan_tpu import eval as jeval
from rsrgan_tpu.cli import plot as jax_plot
from rsrgan_tpu.cli import resynth as jax_resynth
from rsrgan_tpu.cli import score as jax_score
from rsrgan_tpu.data.kaldi_ark import ArkWriter
from rsrgan_tpu.features import resynth as jres
from rsrgan_tpu.features.frontend import (FrameOptions as JFrameOptions,
                                          SpectrogramOptions,
                                          compute_spectrogram_np)
from rsrgan_tpu.sim.wavio import write_wav
from rsrgan_tpu_torch import eval as teval
from rsrgan_tpu_torch.cli import plot as port_plot
from rsrgan_tpu_torch.cli import resynth as port_resynth
from rsrgan_tpu_torch.cli import score as port_score
from rsrgan_tpu_torch.features import resynth as tres
from rsrgan_tpu_torch.features.frontend import FrameOptions

NODITHER = FrameOptions(dither=0.0)
# the packages' eval/__init__ export the function stoi over the module
jstoi = importlib.import_module("rsrgan_tpu.eval.stoi")
tstoi = importlib.import_module("rsrgan_tpu_torch.eval.stoi")


def speechlike(n, seed=0, scale=3000.0):
    """Zero-mean modulated multi-tone + noise at 16-bit PCM scale."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = np.zeros(n)
    for f0 in (180.0, 550.0, 1700.0, 3400.0):
        x += rng.uniform(0.3, 1.0) * np.sin(
            2 * np.pi * f0 * t + rng.uniform(0, 2 * np.pi)) * (
            0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 5) * t))
    x += 0.05 * rng.standard_normal(n)
    x -= x.mean()
    return (scale * x).astype(np.float32)


def noisy(clean, seed, level):
    rng = np.random.default_rng(seed)
    return clean + level * np.std(clean) * rng.standard_normal(
        len(clean)).astype(np.float32)


CLEAN = speechlike(16000, seed=1)
PAIRS = {"noisy": (noisy(CLEAN, 2, 0.5), CLEAN),
         "scaled": (0.3 * noisy(CLEAN, 3, 0.1), CLEAN),
         "ragged": (noisy(CLEAN, 4, 1.0)[:15000], CLEAN)}


@pytest.mark.parametrize("metric", ["snr", "si_snr", "seg_snr"])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_wave_metrics_equal(metric, pair):
    est, ref = PAIRS[pair]
    assert getattr(teval, metric)(est, ref) == \
        getattr(jeval, metric)(est, ref)


@pytest.mark.parametrize("metric", ["lsd_from_lps", "variance_ratio"])
@pytest.mark.parametrize("skip", [True, False])
def test_feature_metrics_equal(metric, skip):
    rng = np.random.default_rng(11)
    ref = rng.normal(size=(60, 257))
    est = 0.7 * ref[:55] + 0.2 * rng.normal(size=(55, 257)) + 1.0
    assert getattr(teval, metric)(est, ref, skip_first_bin=skip) == \
        getattr(jeval, metric)(est, ref, skip_first_bin=skip)
    assert teval.feature_mse(est, ref) == jeval.feature_mse(est, ref)


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_stoi_and_estoi_equal(pair):
    est, ref = PAIRS[pair]
    assert teval.stoi_both(est, ref, fs=16000) == \
        jeval.stoi_both(est, ref, fs=16000)
    assert teval.stoi(est, ref, fs=16000) == jeval.stoi(est, ref, fs=16000)
    assert teval.estoi(est, ref, fs=16000) == \
        jeval.estoi(est, ref, fs=16000)


def test_stoi_pieces_and_errors_equal():
    np.testing.assert_array_equal(tstoi._third_octave_matrix(),
                                  jstoi._third_octave_matrix())
    x = np.random.default_rng(7).uniform(0.1, 2.0, size=(3, 15, 30))
    y = x * np.random.default_rng(8).uniform(0.2, 5.0, size=(3, 15, 30))
    assert tstoi._stoi_score(x, y) == jstoi._stoi_score(x, y)
    assert tstoi._estoi_score(x, y) == jstoi._estoi_score(x, y)
    short = speechlike(2000, seed=39)
    for mod in (tstoi, jstoi):
        with pytest.raises(ValueError, match="too short"):
            mod.stoi(short, short, fs=16000)


@pytest.mark.parametrize("raw_energy", [True, False])
def test_resynthesize_equal(raw_energy):
    clean = speechlike(12000, seed=5)
    lps = compute_spectrogram_np(clean, SpectrogramOptions(
        JFrameOptions(dither=0.0), raw_energy=raw_energy))
    lps = lps + np.random.default_rng(6).normal(scale=0.3, size=lps.shape)
    wave = noisy(clean, 7, 0.4)
    got = tres.resynthesize(lps, wave, NODITHER, raw_energy=raw_energy)
    want = jres.resynthesize(lps, wave, JFrameOptions(dither=0.0),
                             raw_energy=raw_energy)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_resynth_pieces_equal():
    wave = speechlike(8000, seed=8)
    jopts = JFrameOptions(dither=0.0)
    np.testing.assert_array_equal(tres.complex_spectrum(wave, NODITHER),
                                  jres.complex_spectrum(wave, jopts))
    frames = np.random.default_rng(9).normal(size=(30, 400))
    for n in (None, 4000, 6000):
        np.testing.assert_array_equal(
            tres.overlap_add(frames, NODITHER, num_samples=n),
            jres.overlap_add(frames, jopts, num_samples=n))
    np.testing.assert_array_equal(tres.deemphasize(wave, 0.97),
                                  jres.deemphasize(wave, 0.97))
    with pytest.raises(ValueError, match="LPS dim"):
        tres.resynthesize(np.zeros((10, 40), np.float32), wave, NODITHER)


@pytest.fixture(scope="module")
def scored_corpus(tmp_path_factory):
    """Three clean/noisy wav pairs and their clean LPS as an ark (the
    oracle G output), plus a fourth noisy wav with no LPS."""
    root = tmp_path_factory.mktemp("corpus")
    opts = SpectrogramOptions(JFrameOptions(dither=0.0), raw_energy=True)
    writer = ArkWriter(str(root / "feats.scp"))
    with open(root / "clean.scp", "w") as cs, \
            open(root / "noisy.scp", "w") as ns:
        for i in range(4):
            utt = f"utt{i}"
            clean = speechlike(8000 + 1000 * i, seed=20 + i)
            for kind, wave in (("clean", clean),
                               ("noisy", noisy(clean, 30 + i, 0.3))):
                path = str(root / f"{kind}{i}.wav")
                write_wav(path, wave)
                (cs if kind == "clean" else ns).write(f"{utt} {path}\n")
            if i < 3:
                writer.write_next_utt(str(root / "feats.ark"), utt,
                                      compute_spectrogram_np(clean, opts))
    writer.close()
    return root


def both(capsys, argv_of, tmp_path):
    """Run the port's and the JAX CLI on argv_of(out_dir); (return codes,
    printed lines, out dirs)."""
    rcs, outs, dirs = [], [], []
    for tag, main in (("port", argv_of[0]), ("jax", argv_of[1])):
        d = str(tmp_path / tag)
        rcs.append(main(argv_of[2](d)))
        outs.append(capsys.readouterr().out.replace(d, "OUT"))
        dirs.append(d)
    return rcs, outs, dirs


@pytest.mark.parametrize("no_raw_energy", [False, True])
def test_resynth_cli_byte_equal(scored_corpus, tmp_path, capsys,
                                no_raw_energy):
    root = scored_corpus
    rcs, outs, dirs = both(capsys, (port_resynth.main, jax_resynth.main,
                                    lambda d: [
        "--enhanced_scp", str(root / "feats.scp"),
        "--wav_scp", str(root / "noisy.scp"), "--out_dir", d]
        + (["--no_raw_energy"] if no_raw_energy else [])), tmp_path)
    assert rcs == [0, 0] and outs[0] == outs[1]
    names = sorted(os.listdir(dirs[0]))
    assert names == sorted(os.listdir(dirs[1])) == [
        "utt0.wav", "utt1.wav", "utt2.wav", "wav.scp"]
    for n in names:
        with open(os.path.join(dirs[0], n), "rb") as f, \
                open(os.path.join(dirs[1], n), "rb") as g:
            assert f.read().replace(dirs[0].encode(), b"OUT") == \
                g.read().replace(dirs[1].encode(), b"OUT")


@pytest.mark.parametrize("flags", [
    ["--mode", "wav", "--est_scp", "noisy.scp", "--ref_scp", "clean.scp"],
    ["--mode", "wav", "--est_scp", "noisy.scp", "--ref_scp", "clean.scp",
     "--intelligibility=0"],
    ["--mode", "feats", "--est_scp", "feats.scp", "--ref_scp", "feats.scp"],
    ["--mode", "feats", "--est_scp", "feats.scp", "--ref_scp", "feats.scp",
     "--raw_energy=false"]])
def test_score_cli_lines_equal(scored_corpus, tmp_path, capsys, flags):
    root = scored_corpus
    argv = [str(root / f) if f.endswith(".scp") else f for f in flags]
    rcs, outs, dirs = both(capsys, (port_score.main, jax_score.main,
                                    lambda d: argv + ["--per_utt", d]),
                           tmp_path)
    assert rcs == [0, 0] and outs[0] == outs[1]
    summary = json.loads(outs[0].strip().splitlines()[-1])
    assert summary["num_utts"] == (4 if "wav" in flags else 3)
    with open(dirs[0]) as f, open(dirs[1]) as g:
        assert f.read() == g.read()


def test_score_cli_short_wav_and_no_rows_equal(tmp_path, capsys):
    """Sub-STOI-length utterances: null, never NaN, in both; no scored
    utterance returns 1 in both."""
    wav = tmp_path / "s.wav"
    write_wav(str(wav), speechlike(2000, seed=50))
    (tmp_path / "a.scp").write_text(f"u0 {wav}\n")
    (tmp_path / "b.scp").write_text(f"u1 {wav}\n")
    for ref, rc in (("a.scp", 0), ("b.scp", 1)):
        argv = ["--mode", "wav", "--est_scp", str(tmp_path / "a.scp"),
                "--ref_scp", str(tmp_path / ref)]
        outs = []
        for main in (port_score.main, jax_score.main):
            assert main(argv) == rc
            outs.append(capsys.readouterr())
        assert outs[0].out == outs[1].out
        assert outs[0].err == outs[1].err


def test_plot_cli_writes_the_curves(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    save_dir = tmp_path / "exp"
    os.makedirs(save_dir)
    assert port_plot.main(["--save_dir", str(save_dir)]) == 1
    assert jax_plot.main(["--save_dir", str(save_dir)]) == 1
    for split in ("train", "eval"):
        with open(save_dir / f"metrics_{split}.jsonl", "w") as f:
            for it in (1, 2, 3):
                f.write(json.dumps({"iteration": it, "g_loss": 3.0 / it,
                                    "d_loss": 0.5}) + "\n")
    capsys.readouterr()
    for main, name in ((port_plot.main, "port.png"),
                       (jax_plot.main, "jax.png")):
        assert main(["--save_dir", str(save_dir),
                     "--output", str(save_dir / name)]) == 0
        assert os.path.getsize(save_dir / name) > 1000
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"Wrote {save_dir / 'port.png'}",
                     f"Wrote {save_dir / 'jax.png'}"]
