"""The port's feature front-end (``features/frontend.py``,
``features/mfcc.py``) and extraction CLI against the JAX package's on
the same waves, and against the independent C++ oracle's fixture.

Parity is the float32 contract of tests/test_feature_oracle.py: LPS
power within 1e-5 of the frame's peak, the log domain within 5e-4 on
bins above 1e-6 of the peak, the energy slot within 1e-5; MFCC within
2e-2 (speech, tone) or 1e-3 (noise), median under 1e-4. Two float32 FFTs
(XLA's, PyTorch's) agree to that and no further: below 1e-6 of a frame's
peak their rounding noise is the value. Dither cannot follow JAX's
stream, so parity runs at dither 0 and the port's own dither is held to
its determinism and statistics."""

import os

import numpy as np
import pytest
import torch

from rsrgan_tpu.cli import extract as jax_extract
from rsrgan_tpu.data.cmvn import read_kaldi_cmvn
from rsrgan_tpu.features import frontend as jf
from rsrgan_tpu.features import mfcc as jm
from rsrgan_tpu.sim.wavio import write_wav
from rsrgan_tpu_torch.cli import extract as port_extract
from rsrgan_tpu_torch.data import kaldi_ark as tark
from rsrgan_tpu_torch.features import frontend as tf
from rsrgan_tpu_torch.features import mfcc as tm

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = os.path.join(REPO, "tests", "fixtures", "oracle_feats.npz")
GOLDEN = os.path.join(REPO, "tests", "fixtures", "dsp_golden.npz")
MFCC_TOL = {"speech": 2e-2, "tone": 2e-2, "noise": 1e-3}
# median bounds: the oracle tests' 1e-4; this file's synthetic tone (a
# 1 kHz sine 50 dB over its noise) leaves most mel bins near the floor,
# where two float32 FFTs' MFCCs differ by a median of ~1.4e-4
MFCC_MEDIAN = {"speech": 1e-4, "noise": 1e-4, "tone": 2e-4}


def assert_lps_parity(got, want, raw_energy=True):
    assert got.shape == want.shape
    first = 1 if raw_energy else 0
    if raw_energy:
        np.testing.assert_allclose(got[:, 0], want[:, 0], atol=1e-5)
    p_g, p_w = np.exp(got[:, first:]), np.exp(want[:, first:])
    scale = p_w.max(axis=1, keepdims=True)
    assert float((np.abs(p_g - p_w) / scale).max()) < 1e-5
    mask = p_w > 1e-6 * scale
    assert float(np.abs(got[:, first:] - want[:, first:])[mask].max()) \
        < 5e-4


def assert_mfcc_parity(got, want, kind):
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert float(diff.max()) < MFCC_TOL[kind]
    assert float(np.median(diff)) < MFCC_MEDIAN[kind]


def make_wave(kind, n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    if kind == "noise":
        w = rng.normal(scale=2500, size=n)
    elif kind == "tone":
        w = 9000 * np.sin(2 * np.pi * 1000 * t) + rng.normal(scale=30,
                                                             size=n)
    else:
        w = np.zeros(n)
        for f0 in (180.0, 550.0, 1700.0, 3400.0):
            w += rng.uniform(800, 3000) * np.sin(
                2 * np.pi * f0 * t + rng.uniform(0, 6.3)) * (
                0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 5) * t))
        w += rng.normal(scale=100, size=n)
    return w.astype(np.float32)


class TestFraming:
    def test_num_frames_equal(self):
        for snip in (True, False):
            o, j = tf.FrameOptions(snip_edges=snip), \
                jf.FrameOptions(snip_edges=snip)
            for n in (0, 399, 400, 401, 559, 560, 561, 16000, 23456):
                assert tf.num_frames(n, o) == jf.num_frames(n, j)

    @pytest.mark.parametrize("window", ["povey", "hanning", "hamming",
                                        "rectangular", "blackman"])
    def test_feature_window_equal(self, window):
        np.testing.assert_array_equal(
            tf.feature_window(tf.FrameOptions(window_type=window)),
            jf.feature_window(jf.FrameOptions(window_type=window)))

    @pytest.mark.parametrize("snip", [True, False])
    def test_frames_equal(self, snip):
        wave = np.arange(1000, dtype=np.float32)
        got = tf.extract_frames(torch.from_numpy(wave),
                                tf.FrameOptions(snip_edges=snip))
        want = np.asarray(jf.extract_frames(
            wave, jf.FrameOptions(snip_edges=snip)))
        np.testing.assert_array_equal(got.numpy(), want)


LPS_CASES = {
    "default": {},
    "no_raw_energy": {"raw_energy": False},
    "energy_floor": {"energy_floor": 1.0},
    "hamming": {"window_type": "hamming"},
    "centered": {"snip_edges": False},
}


def lps_pair(case, wave):
    opts = dict(LPS_CASES[case])
    spec = {k: opts.pop(k) for k in ("raw_energy", "energy_floor")
            if k in opts}
    got = tf.compute_spectrogram_np(wave, tf.SpectrogramOptions(
        tf.FrameOptions(dither=0.0, **opts), **spec))
    want = np.asarray(jf.compute_spectrogram_np(wave, jf.SpectrogramOptions(
        jf.FrameOptions(dither=0.0, **opts), **spec)))
    return got, want, spec.get("raw_energy", True)


@pytest.mark.parametrize("case", sorted(LPS_CASES))
@pytest.mark.parametrize("kind,n", [("speech", 7001), ("noise", 16000),
                                    ("tone", 561)])
def test_lps_matches_jax(case, kind, n):
    got, want, raw = lps_pair(case, make_wave(kind, n, seed=n))
    assert_lps_parity(got, want, raw)


MFCC_CASES = {
    "hires": {},
    "energy": {"use_energy": True},
    "energy_windowed": {"use_energy": True, "raw_energy": False,
                        "energy_floor": 2.0},
    "13_ceps": {"num_ceps": 13},
}


@pytest.mark.parametrize("case", sorted(MFCC_CASES))
@pytest.mark.parametrize("kind,n", [("speech", 9000), ("noise", 4000)])
def test_mfcc_matches_jax(case, kind, n):
    wave = make_wave(kind, n, seed=n)
    kw = MFCC_CASES[case]
    got = tm.compute_mfcc_np(wave, tm.MfccOptions(
        frame_opts=tf.FrameOptions(dither=0.0), **kw))
    want = np.asarray(jm.compute_mfcc_np(wave, jm.MfccOptions(
        frame_opts=jf.FrameOptions(dither=0.0), **kw)))
    assert_mfcc_parity(got, want, kind)


def test_mel_dct_lifter_builders_equal():
    for (t, j) in ((tm.mel_banks(tm.MelOptions(), tf.FrameOptions()),
                    jm.mel_banks(jm.MelOptions(), jf.FrameOptions())),
                   (tm.dct_matrix(40, 40), jm.dct_matrix(40, 40)),
                   (tm.lifter_coeffs(13, 22.0), jm.lifter_coeffs(13, 22.0))):
        np.testing.assert_array_equal(t, j)


class TestOracleFixture:
    """The independent double-precision C++ oracle's committed features
    (tests/fixtures/oracle_feats.npz)."""

    @pytest.fixture(scope="class")
    def fx(self):
        return np.load(ORACLE)

    @pytest.mark.parametrize("name", ["speech", "noise", "tone"])
    def test_lps_and_mfcc_match_oracle(self, fx, name):
        wave = fx[f"wave_{name}"]
        opts = tf.FrameOptions(dither=0.0)
        assert_lps_parity(tf.compute_spectrogram_np(
            wave, tf.SpectrogramOptions(opts)), fx[f"lps_{name}"])
        assert_mfcc_parity(tm.compute_mfcc_np(
            wave, tm.MfccOptions(frame_opts=opts)), fx[f"mfcc_{name}"],
            name)


def test_golden_fixture_float32_contract():
    """tests/fixtures/dsp_golden.npz holds the JAX front-end's own output
    on a tone whose frames span eleven decades of power. The port meets
    the float32 contract on it: LPS as above, and the MFCC's bulk within
    the oracle tests' bound. Its noise-floor bins differ by up to ~0.3
    in the log domain, and its MFCC by a few 1e-2, because there the
    value is float32 FFT rounding: the golden itself lies 2e-2 from the
    same features computed in float64 (checked here), so only XLA's own
    FFT reproduces it to the JAX test's 1e-3."""
    fx = np.load(GOLDEN)
    opts = tf.FrameOptions(dither=0.0)
    assert_lps_parity(tf.compute_spectrogram_np(
        fx["wave"], tf.SpectrogramOptions(opts)), fx["lps"])
    got = tm.compute_mfcc_np(fx["wave"], tm.MfccOptions(frame_opts=opts))
    assert float(np.abs(got - fx["mfcc"]).max()) < 5e-2

    frames = tf.extract_frames(torch.from_numpy(fx["wave"]).double(), opts)
    frames = frames - frames.mean(-1, keepdim=True)
    frames = frames - 0.97 * torch.cat([frames[..., :1],
                                        frames[..., :-1]], -1)
    frames = frames * torch.from_numpy(tf.feature_window(opts)).double()
    spec = torch.fft.rfft(frames, n=512)
    mel = (spec.real ** 2 + spec.imag ** 2).numpy() @ tm.mel_banks(
        tm.MelOptions(), opts).T.astype(np.float64)
    f64 = (np.log(np.maximum(mel, tf.EPS_F32))
           @ tm.dct_matrix(40, 40).T.astype(np.float64)) \
        * tm.lifter_coeffs(40, 22.0)
    assert float(np.abs(fx["mfcc"] - f64).max()) > 1e-2
    assert float(np.abs(got - f64).max()) < 5e-2


@pytest.mark.parametrize("feat", ["lps", "mfcc"])
def test_stack_rows_equal_each_row_alone(feat):
    """[B, S] extraction gives each row the bits it gets alone, dither
    included (one generator per row)."""
    opts = tf.FrameOptions(dither=1.0)
    waves = np.stack([make_wave(k, 6000, seed=i) for i, k in
                      enumerate(("speech", "noise", "tone"))])
    fn = (lambda w, g: tf.compute_spectrogram(
        w, tf.SpectrogramOptions(opts), g)) if feat == "lps" else \
        (lambda w, g: tm.compute_mfcc(w, tm.MfccOptions(frame_opts=opts), g))
    cpu = torch.device("cpu")
    stacked = fn(torch.from_numpy(waves), tf.seeded_generators([5, 6, 7],
                                                               cpu))
    for i, seed in enumerate((5, 6, 7)):
        alone = fn(torch.from_numpy(waves[i]),
                   tf.seeded_generators([seed], cpu))
        assert torch.equal(stacked[i], alone)


class TestDither:
    def test_deterministic_per_seed(self):
        wave = make_wave("speech", 4000, seed=1)
        opts = tf.SpectrogramOptions(tf.FrameOptions(dither=1.0))
        a = tf.compute_spectrogram_np(wave, opts, seed=1)
        b = tf.compute_spectrogram_np(wave, opts, seed=1)
        c = tf.compute_spectrogram_np(wave, opts, seed=2)
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, c)
        plain = tf.compute_spectrogram_np(
            wave, tf.SpectrogramOptions(tf.FrameOptions(dither=0.0)),
            seed=1)
        assert not np.array_equal(a, plain)

    @pytest.mark.parametrize("dither", [1.0, 0.25])
    def test_noise_statistics(self, dither):
        """Dithered minus undithered frames, before DC removal: zero
        mean and standard deviation ``dither`` (Kaldi adds dither *
        N(0, 1) to every sample of every frame)."""
        opts = tf.FrameOptions(dither=dither, remove_dc_offset=False,
                               preemph_coeff=0.0, window_type="rectangular")
        frames = tf.extract_frames(
            torch.from_numpy(make_wave("speech", 80000, seed=2)), opts)
        gens = tf.seeded_generators([3], torch.device("cpu"))
        noisy, _ = tf.process_frames(frames, opts, gens, False)
        plain, _ = tf.process_frames(frames, opts, None, False)
        diff = (noisy - plain).double()
        n = diff.numel()
        assert abs(float(diff.mean())) < 5 * dither / np.sqrt(n)
        assert abs(float(diff.std()) / dither - 1.0) < 0.01
        # independent draws per frame, overlapping samples included
        assert abs(float(torch.corrcoef(torch.stack(
            [diff[:-1, 160:].reshape(-1),
             diff[1:, :-160].reshape(-1)]))[0, 1])) < 0.02


# --- the extraction CLI ----------------------------------------------------

CORPUS = (("speech", 1.0), ("noise", 2.9), ("tone", 0.5), ("speech", 3.2),
          ("speech", 1.7), ("noise", 0.8), ("tone", 2.2))


@pytest.fixture(scope="module")
def wav_corpus(tmp_path_factory):
    """Seven PCM waves of 0.5-3.2 s (two 200-frame buckets), listed out
    of length order."""
    root = tmp_path_factory.mktemp("wavs")
    lines = []
    for i, (kind, secs) in enumerate(CORPUS):
        path = str(root / f"u{i}.wav")
        write_wav(path, make_wave(kind, int(secs * 16000), seed=i))
        lines.append(f"u{i} {path}")
    (root / "wav.scp").write_text("\n".join(lines) + "\n")
    return str(root / "wav.scp")


FEAT = {"spectrogram": "lps", "mfcc": "mfcc"}


@pytest.fixture(scope="module")
def extracted(wav_corpus, tmp_path_factory):
    """Both CLIs at --dither=0 with CMVN, per feature type; the port also
    with --compress, --text and --batch_size=1."""
    out = {}
    for feat in FEAT:
        for tag, main, extra in (
                ("jax", jax_extract.main, []),
                ("port", port_extract.main, ["--device=cpu"]),
                ("compress", port_extract.main, ["--device=cpu",
                                                 "--compress"]),
                ("text", port_extract.main, ["--device=cpu", "--text"]),
                ("b1", port_extract.main, ["--device=cpu",
                                           "--batch_size=1"])):
            d = str(tmp_path_factory.mktemp(f"{feat}_{tag}"))
            assert main([f"--wav_scp={wav_corpus}", f"--feat_type={feat}",
                         f"--output_dir={d}", "--name=feats", "--dither=0",
                         "--accumulate_cmvn", *extra]) == 0
            out[feat, tag] = d
    return out


def read_ark(d):
    return list(tark.ScpReader(os.path.join(d, "feats.scp")))


@pytest.mark.parametrize("feat", sorted(FEAT))
def test_extract_cli_matches_jax(extracted, feat):
    port, jax = read_ark(extracted[feat, "port"]), \
        read_ark(extracted[feat, "jax"])
    assert [u for u, _ in port] == [u for u, _ in jax] == \
        [f"u{i}" for i in range(7)]
    for (_, got), (_, want), (kind, _) in zip(port, jax, CORPUS):
        if feat == "spectrogram":
            assert_lps_parity(got, want)
        else:
            assert_mfcc_parity(got, want, kind)
    cmvn = [read_kaldi_cmvn(os.path.join(extracted[feat, t], "feats.cmvn"))
            for t in ("port", "jax")]
    assert cmvn[0].shape == cmvn[1].shape
    assert cmvn[0][0, -1] == cmvn[1][0, -1] == sum(len(m) for _, m in jax)
    np.testing.assert_allclose(cmvn[0][0, :-1], cmvn[1][0, :-1],
                               rtol=1e-4, atol=1.0)


@pytest.mark.parametrize("feat", sorted(FEAT))
def test_extract_cli_compress_text_and_batch_one(extracted, feat):
    """--compress writes the codec's bytes of the plain matrices, --text
    their text archive, --batch_size=1 the same bits as 16."""
    plain = read_ark(extracted[feat, "port"])
    for tag, encode in (("compress", tark._encode_compressed),
                        ("text", tark._format_text_matrix)):
        with open(os.path.join(extracted[feat, tag], "feats.ark"),
                  "rb") as f:
            assert f.read() == b"".join(u.encode() + b" " + encode(m)
                                        for u, m in plain)
    for (u, m), (v, b) in zip(plain, read_ark(extracted[feat, "b1"])):
        assert u == v
        np.testing.assert_array_equal(b, m)


def test_extract_dithered_batches_bit_equal_and_seeded(wav_corpus,
                                                       tmp_path):
    """With dither, --batch_size=1 and 3 write the same bits; another
    --dither_seed writes others."""
    arks = {}
    for tag, extra in (("b1", ["--batch_size=1"]), ("b3", ["--batch_size=3"]),
                       ("seed", ["--dither_seed=9"])):
        d = str(tmp_path / tag)
        assert port_extract.main([f"--wav_scp={wav_corpus}",
                                  "--feat_type=spectrogram",
                                  f"--output_dir={d}", "--name=feats",
                                  "--device=cpu", *extra]) == 0
        arks[tag] = read_ark(d)
    for (u, a), (v, b), (_, c) in zip(arks["b1"], arks["b3"], arks["seed"]):
        assert u == v
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, c)


def test_extract_without_card_raises_and_leaves_tf32_off(wav_corpus,
                                                         tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [f"--wav_scp={wav_corpus}", "--feat_type=mfcc",
            f"--output_dir={tmp_path}", "--name=x"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_extract.main(argv)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    assert port_extract.main(argv + ["--device=cpu", "--dither=0"]) == 0
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
