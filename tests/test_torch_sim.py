"""The port's simulation (``rsrgan_tpu_torch.sim`` and ``cli.simulate``)
against the JAX package's on the same seeded inputs: wav files written
and read byte-equal, every DSP and manifest function equal, corruption
equal on the same ``np.random.Generator`` (so the draws come in the same
order), ``make_sim_assets`` trees and the simulate CLI's outputs
byte-equal, its resume path included. Mirrors tests/test_sim.py."""

import os
import wave

import numpy as np
import pytest
import scipy.signal

from rsrgan_tpu import sim as jsim
from rsrgan_tpu.cli import simulate as jax_simulate
from rsrgan_tpu.sim import synthwav as jsynth
from rsrgan_tpu_torch import sim as tsim
from rsrgan_tpu_torch.cli import simulate as port_simulate
from rsrgan_tpu_torch.sim import synthwav as tsynth


def tree_bytes(root):
    """{relative path: bytes} of every file under root, with the root's
    own path replaced in text files (scp and manifests name it)."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                data = f.read()
            if not n.endswith((".wav", ".npy")):
                data = data.replace(root.encode(), b"ROOT")
            out[os.path.relpath(p, root)] = data
    return out


class TestWavIO:
    def test_write_byte_equal_and_read_equal(self, tmp_path, rng):
        samples = (rng.normal(size=8000) * 9000).astype(np.float32)
        samples[:3] = [40000.0, -40000.0, 0.4]   # clipped and rounded
        for mod, name in ((jsim, "j.wav"), (tsim, "t.wav")):
            mod.write_wav(str(tmp_path / name), samples, 16000)
        assert ((tmp_path / "j.wav").read_bytes()
                == (tmp_path / "t.wav").read_bytes())
        got, want = (tsim.read_wav(str(tmp_path / "t.wav")),
                     jsim.read_wav(str(tmp_path / "t.wav")))
        assert got[1] == want[1] == 16000
        np.testing.assert_array_equal(got[0], want[0])

    @pytest.mark.parametrize("width,channels", [(1, 1), (4, 1), (2, 2)])
    def test_read_other_widths_equal(self, tmp_path, rng, width, channels):
        raw = rng.integers(0, 255, size=600 * width * channels,
                           dtype=np.uint8).tobytes()
        path = str(tmp_path / "w.wav")
        with wave.open(path, "wb") as w:
            w.setnchannels(channels)
            w.setsampwidth(width)
            w.setframerate(8000)
            w.writeframes(raw)
        got, want = tsim.read_wav(path), jsim.read_wav(path)
        assert got[1] == want[1] == 8000
        np.testing.assert_array_equal(got[0], want[0])


class TestDsp:
    def test_fft_convolve_equal_and_matches_scipy(self, rng):
        x = rng.normal(size=1000).astype(np.float32)
        h = rng.normal(size=64).astype(np.float32)
        got = tsim.fft_convolve(x, h)
        np.testing.assert_array_equal(got, jsim.fft_convolve(x, h))
        np.testing.assert_array_equal(tsim.fft_convolve(x, h, 700),
                                      jsim.fft_convolve(x, h, 700))
        np.testing.assert_allclose(got, scipy.signal.fftconvolve(x, h),
                                   atol=2e-2)

    @pytest.mark.parametrize("shift,normalize", [(True, True),
                                                 (False, True),
                                                 (True, False)])
    def test_reverberate_equal(self, rng, shift, normalize):
        x = rng.normal(size=2000).astype(np.float32) * 100
        rir = (rng.normal(size=300) * np.exp(-np.arange(300) / 60.0)
               ).astype(np.float32)
        rir[20] = 3.0
        np.testing.assert_array_equal(
            tsim.reverberate(x, rir, shift, normalize),
            jsim.reverberate(x, rir, shift, normalize))

    def test_early_reverb_energy_equal(self, rng):
        speech = rng.normal(size=4000).astype(np.float32) * 100
        rir = rng.normal(size=2400).astype(np.float32)
        rir[100] = 9.0
        assert (tsim.early_reverb_energy(speech, rir, 16000)
                == jsim.early_reverb_energy(speech, rir, 16000))

    @pytest.mark.parametrize("length", [40, 100, 250])
    def test_extend_to_duration_equal(self, rng, length):
        noise = rng.normal(size=100).astype(np.float32)
        np.testing.assert_array_equal(
            tsim.extend_to_duration(noise, length),
            jsim.extend_to_duration(noise, length))

    @pytest.mark.parametrize("start,extend,power", [
        (0, True, None), (300, False, None), (800, False, None),
        (0, True, 5e4), (200, False, 5e4), (1200, False, None)])
    def test_mix_at_snr_equal(self, rng, start, extend, power):
        speech = rng.normal(size=1000).astype(np.float32) * 100
        noise = rng.normal(size=450).astype(np.float32) * 7
        np.testing.assert_array_equal(
            tsim.mix_at_snr(speech, noise, 7.5, start, extend, power),
            jsim.mix_at_snr(speech, noise, 7.5, start, extend, power))


MANIFESTS = {
    "rir_list": "--rir-id r1 --room-id A --probability 0.7 /p/r1.wav\n"
                "--rir-id r2 --room-id A /p/r2.wav\n"
                "\n"
                "--rir-id r3 --room-id B --probability 0.1 /p/r3.wav\n",
    "noise_list": "--noise-id n1 --noise-type point-source "
                  "--bg-fg-type foreground /p/n1.wav\n"
                  "--noise-id n2 --noise-type isotropic --bg-fg-type "
                  "background --room-linkage A --probability 0.2 "
                  "/p/n2.wav\n"
                  "--noise-id n3 --noise-type isotropic --bg-fg-type "
                  "background --room-linkage A /p/n3.wav\n"
                  "--noise-id n4 /p/n4.wav\n",
}


def as_dicts(items):
    return [vars(it) if not hasattr(it, "rirs") else
            {**vars(it), "rirs": [vars(r) for r in it.rirs]}
            for it in items]


class TestManifests:
    def test_parse_rir_list_equal(self, tmp_path):
        path = tmp_path / "rir_list"
        path.write_text(MANIFESTS["rir_list"])
        assert (as_dicts(tsim.parse_rir_list(str(path)))
                == as_dicts(jsim.parse_rir_list(str(path))))

    def test_parse_noise_list_equal(self, tmp_path):
        path = tmp_path / "noise_list"
        path.write_text(MANIFESTS["noise_list"])
        tp, ti = tsim.parse_noise_list(str(path))
        jp, ji = jsim.parse_noise_list(str(path))
        assert as_dicts(tp) == as_dicts(jp)
        assert {k: as_dicts(v) for k, v in ti.items()} == \
            {k: as_dicts(v) for k, v in ji.items()}

    def test_iso_without_room_raises_in_both(self, tmp_path):
        path = tmp_path / "noise_list"
        path.write_text("--noise-id n1 --noise-type isotropic /p/n1.wav\n")
        for mod in (tsim, jsim):
            with pytest.raises(ValueError, match="room-linkage"):
                mod.parse_noise_list(str(path))

    def test_pick_with_probability_same_draws(self, tmp_path):
        path = tmp_path / "rir_list"
        path.write_text(MANIFESTS["rir_list"])
        picks = []
        for mod in (tsim, jsim):
            rooms = mod.parse_rir_list(str(path))
            rng = np.random.default_rng(4)
            picks.append([mod.pick_item_with_probability(rng, rooms).room_id
                          for _ in range(50)])
        assert picks[0] == picks[1]


def room_setup(mod, rng):
    """Two rooms with decaying RIRs, a foreground and a background
    point-source noise and a room-linked isotropic noise (one package's
    dataclasses, the same arrays)."""
    def rir(length, pos):
        r = (rng.normal(size=length) * np.exp(-np.arange(length) / 40.0)
             * 0.3).astype(np.float32)
        r[pos] = 1.0
        return r

    wavs = {"A/r1.wav": rir(300, 5), "A/r2.wav": rir(200, 0),
            "B/r1.wav": rir(250, 12),
            "fg.wav": rng.normal(size=900).astype(np.float32) * 50,
            "bg.wav": rng.normal(size=700).astype(np.float32) * 30,
            "iso_a.wav": rng.normal(size=300).astype(np.float32) * 20}
    rooms = [mod.Room("A", rirs=[mod.Rir("a1", "A", "A/r1.wav", 0.3),
                                 mod.Rir("a2", "A", "A/r2.wav", 0.2)],
                      probability=0.5),
             mod.Room("B", rirs=[mod.Rir("b1", "B", "B/r1.wav", 0.5)],
                      probability=0.5)]
    noises = [mod.Noise("fg", "fg.wav", "point-source", "foreground",
                        probability=0.5),
              mod.Noise("bg", "bg.wav", "point-source", "background",
                        probability=0.5)]
    iso = {"A": [mod.Noise("i0", "iso_a.wav", "isotropic", "background",
                           room_linkage="A", probability=1.0)]}
    return rooms, noises, iso, wavs


@pytest.mark.parametrize("options", [
    {}, {"speech_rvb_probability": 0.5, "max_noises_added": 3},
    {"normalize_output": False, "shift_output": False},
    {"pointsource_noise_addition_probability": 0.3,
     "isotropic_noise_addition_probability": 0.6}])
@pytest.mark.parametrize("with_rooms", [True, False])
def test_corrupt_utterance_equal_on_the_same_generator(options, with_rooms):
    speech = np.random.default_rng(1).normal(size=4000).astype(
        np.float32) * 100
    outs = []
    for mod in (tsim, jsim):
        rooms, noises, iso, wavs = room_setup(mod, np.random.default_rng(2))
        opts = mod.SimulationOptions(**options)
        rng = np.random.default_rng(3)
        outs.append([mod.corrupt_utterance(speech, rooms if with_rooms
                                           else [], noises, iso, opts, rng,
                                           wavs.__getitem__)
                     for _ in range(6)] + [rng.random()])
    for got, want in zip(*outs):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn,args", [
    ("make_speech_like_wav", (0.7,)), ("make_colored_noise", (0.5,)),
    ("make_synthetic_rir", (0.4,)), ("make_phone_like_wav", (0.6,))])
def test_synth_functions_equal(fn, args):
    got = getattr(tsynth, fn)(np.random.default_rng(9), *args)
    want = getattr(jsynth, fn)(np.random.default_rng(9), *args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_array_equal(g, w)


def test_frame_alignment_equal():
    units = np.random.default_rng(3).integers(0, 16, size=5000).astype(
        np.int32)
    np.testing.assert_array_equal(tsynth.frame_alignment(units),
                                  jsynth.frame_alignment(units))


@pytest.mark.parametrize("alignments", [False, True])
def test_make_sim_assets_tree_byte_equal(tmp_path, alignments):
    trees = []
    for tag, mod in (("port", tsim), ("jax", jsim)):
        root = str(tmp_path / tag)
        paths = mod.make_sim_assets(root, num_utts=3, min_dur_s=0.3,
                                    max_dur_s=0.6, num_rooms=2,
                                    rirs_per_room=2, seed=11,
                                    alignments=alignments)
        assert paths == tuple(os.path.join(root, p) for p in
                              ("clean/wav.scp", "rir_list", "noise_list"))
        trees.append(tree_bytes(root))
    assert trees[0] == trees[1]
    assert len(trees[0]) == 3 + 1 + 8 + 2 + (4 if alignments else 0)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("assets"))
    return tsim.make_sim_assets(root, num_utts=4, min_dur_s=0.4,
                                max_dur_s=0.8, num_rooms=2,
                                rirs_per_room=2, seed=5)


@pytest.mark.parametrize("extra", [
    [], ["--num_replications=2", "--random_seed=7"],
    ["--max_noises_added=2", "--speech_rvb_probability=0.5",
     "--foreground_snrs=0:10", "--background_snrs=3:4"],
    ["--shift_output=false", "--normalize_output=false"]])
def test_simulate_cli_byte_equal(assets, tmp_path, capsys, extra):
    wav_scp, rir_list, noise_list = assets
    trees, printed = [], []
    for tag, main in (("port", port_simulate.main),
                      ("jax", jax_simulate.main)):
        out = str(tmp_path / tag)
        assert main([f"--wav_scp={wav_scp}", f"--rir_list={rir_list}",
                     f"--noise_list={noise_list}", f"--output_dir={out}",
                     *extra]) == 0
        printed.append(capsys.readouterr().out.replace(out, "OUT"))
        trees.append(tree_bytes(out))
    assert trees[0] == trees[1]
    assert printed[0] == printed[1]


def test_simulate_resume_and_overwrite_equal(assets, tmp_path, capsys):
    """A resumed run keeps the wavs it finds, draws nothing for them, and
    corrupts the missing ones from the generator's current state: both
    CLIs write the same bytes and print the same counts; --overwrite
    redoes all."""
    wav_scp, rir_list, _ = assets
    trees, printed = [], []
    for tag, main in (("port", port_simulate.main),
                      ("jax", jax_simulate.main)):
        out = str(tmp_path / tag)
        args = [f"--wav_scp={wav_scp}", f"--rir_list={rir_list}",
                f"--output_dir={out}"]
        assert main(args) == 0
        os.remove(os.path.join(out, "utt0001.wav"))
        with open(os.path.join(out, "utt0002.wav"), "wb") as f:
            f.write(b"RIFF")   # a truncated output is redone
        assert main(args) == 0
        resumed = tree_bytes(out)
        assert main(args + ["--overwrite"]) == 0
        printed.append(capsys.readouterr().out.replace(out, "OUT"))
        trees.append((resumed, tree_bytes(out)))
    assert trees[0] == trees[1]
    assert printed[0] == printed[1]
    assert "Corrupted 2 utterances (2 already present)" in printed[0]
