"""The port's numpy data codecs against rsrgan_tpu.data: the same inputs
give identical bytes (.rtu stores, binary and text arks) and identical
arrays (readers, splice, infer_batches, CMVN)."""

import os

import numpy as np
import pytest

from rsrgan_tpu.data import cmvn as jax_cmvn
from rsrgan_tpu.data import dataset as jax_dataset
from rsrgan_tpu.data import kaldi_ark as jax_ark
from rsrgan_tpu.data import splice as jax_splice
from rsrgan_tpu.data import store as jax_store
from rsrgan_tpu_torch.data import cmvn, dataset, kaldi_ark, splice, store


def utterances(rng, n=5, dim=7, labels=3):
    out = []
    for i in range(n):
        T = int(rng.integers(1, 40))
        out.append((f"utt{i}", rng.normal(size=(T, dim)).astype(np.float32),
                    rng.normal(size=(T, labels)).astype(np.float32)))
    return out


@pytest.mark.parametrize("with_labels", [True, False])
def test_store_bytes_and_reads_identical(tmp_path, rng, with_labels):
    utts = utterances(rng)
    paths = {}
    for name, mod in (("jax", jax_store), ("port", store)):
        paths[name] = str(tmp_path / f"{name}.rtu")
        with mod.StoreWriter(paths[name]) as w:
            for utt, x, y in utts:
                w.add(utt, x, y if with_labels else None)
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    mine = store.UtteranceStore([paths["jax"], paths["port"]])
    ref = jax_store.UtteranceStore([paths["jax"], paths["port"]])
    assert mine.utt_ids == ref.utt_ids and len(mine) == 2 * len(utts)
    np.testing.assert_array_equal(mine.lengths, ref.lengths)
    assert (mine.has_labels, mine.input_dim, mine.output_dim) == (
        ref.has_labels, ref.input_dim, ref.output_dim)
    for i in range(len(mine)):
        np.testing.assert_array_equal(mine.inputs(i), ref.inputs(i))
        lab, ref_lab = mine.labels(i), ref.labels(i)
        assert (lab is None) == (ref_lab is None)
        if lab is not None:
            np.testing.assert_array_equal(lab, ref_lab)


def test_store_rejects_bad_files(tmp_path, rng):
    path = str(tmp_path / "s.rtu")
    with store.StoreWriter(path) as w:
        w.add("u", np.ones((2, 3), np.float32))
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[:-2])
    with pytest.raises(ValueError, match="truncated"):
        store.UtteranceStore(path)
    with store.StoreWriter(str(tmp_path / "t.rtu")) as w:
        with pytest.raises(ValueError, match="frame-aligned"):
            w.add("u", np.ones((2, 3)), np.ones((3, 1)))


def test_list_file(tmp_path):
    path = tmp_path / "x.list"
    path.write_text("a.rtu\n\n  b.rtu \n")
    assert store.read_list_file(str(path)) == jax_store.read_list_file(
        str(path)) == ["a.rtu", "b.rtu"]


@pytest.mark.parametrize("text", [False, True])
def test_ark_bytes_identical_and_cross_read(tmp_path, rng, text):
    utts = utterances(rng)
    arks = {}
    for name, mod in (("jax", jax_ark), ("port", kaldi_ark)):
        d = tmp_path / name
        d.mkdir()
        ark = str(d / "feats.ark")
        with mod.ArkWriter(str(d / "feats.scp"), text=text) as w:
            for utt, x, _ in utts:
                w.write_next_utt(ark, utt, x)
        arks[name] = (ark, str(d / "feats.scp"))
    with open(arks["jax"][0], "rb") as a, open(arks["port"][0], "rb") as b:
        assert a.read() == b.read()
    mine = kaldi_ark.read_scp(arks["jax"][1])
    assert [(u, o) for u, _, o in mine] == [
        (u, o) for u, _, o in jax_ark.read_scp(arks["port"][1])]
    reader = kaldi_ark.ScpReader(arks["jax"][1])
    assert reader.utt_ids == [u for u, _, _ in utts]
    for (utt, x, _), (rid, mat) in zip(utts, reader):
        assert rid == utt
        np.testing.assert_array_equal(mat, x)
        np.testing.assert_array_equal(reader.read_utt(utt), x)


def test_reads_double_matrices_as_jax(tmp_path):
    path = str(tmp_path / "d.ark")
    with open(path, "wb") as f:
        f.write(b"\0BDM " + b"\x04" + np.int32(2).tobytes() + b"\x04"
                + np.int32(3).tobytes() + np.arange(6.0).tobytes())
    got = kaldi_ark.read_ark_matrix(path)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, jax_ark.read_ark_matrix(path))


def test_text_archive_cannot_be_compressed(tmp_path):
    for mod in (jax_ark, kaldi_ark):
        with pytest.raises(ValueError, match="text archives"):
            mod.ArkWriter(str(tmp_path / "y.scp"), compress=True, text=True)


# ---------------------------------------------------------------------------
# compressed matrices: both of the JAX package's codecs (numpy, and the C
# one of rsrgan_tpu/native when it is loaded) against the port's numpy one
# ---------------------------------------------------------------------------

@pytest.fixture(params=["native", "numpy"])
def jax_codec(request, monkeypatch):
    """The JAX package's ark codec, with its C codec loaded or not."""
    if request.param == "numpy":
        monkeypatch.setattr(jax_ark, "_native", None)
    else:
        assert jax_ark._native is not None, "rsrgan_tpu/native not built"
    return jax_ark


def compressible(rng, rows, cols=6):
    """Seeded matrices that hit the codec's corners: a constant column, a
    column of one repeated value but one, and wide dynamic range."""
    mat = rng.normal(0, 3, size=(rows, cols)).astype(np.float32)
    mat[:, 0] = 1.25
    mat[:, 1] = -4.0
    mat[rows // 2, 1] = 7.5
    mat[:, -1] *= 100.0
    return mat


def assert_decoded_alike(got, want, codec):
    """The port decodes format 1 with the JAX package's numpy arithmetic,
    in float64: bit-equal to its numpy reader. Its C reader tabulates in
    float32 (built with -march=native, so possibly with FMA), which
    rounds differently: there the gate is 4 float32 ulps of the largest
    value the matrix can decode to."""
    if codec._native is None:
        np.testing.assert_array_equal(got, want)
    else:
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=4 * np.finfo(np.float32).eps * scale)


def encoded(mod, mat) -> bytes:
    import io
    buf = io.BytesIO()
    mod.write_matrix(buf, mat, compress=True)
    return buf.getvalue()


@pytest.mark.parametrize("rows", [1, 2, 8, 9, 10, 64, 301])
def test_compressed_write_bytes_and_read_identical(tmp_path, rng,
                                                   jax_codec, rows):
    """Format 2 up to 8 rows, format 1 from 9: the port's bytes equal the
    JAX writer's, and both readers give the same array from them."""
    mat = compressible(rng, rows)
    blob = encoded(kaldi_ark, mat)
    assert blob == encoded(jax_codec, mat)
    assert blob[:5] == (b"\0BCM2" if rows <= 8 else b"\0BCM ")
    path = tmp_path / "c.ark"
    path.write_bytes(blob)
    got = kaldi_ark.read_ark_matrix(str(path))
    want = jax_codec.read_ark_matrix(str(path))
    assert got.dtype == want.dtype == np.float32
    assert got.shape == (rows, 6)
    assert_decoded_alike(got, want, jax_codec)
    # lossy, but within one step of the coarsest quantizer (format 1's
    # 63 steps over a column's top quarter; format 2's 65535 over the
    # global range)
    step = (mat.max() - mat.min()) / (65535.0 if rows <= 8 else 63.0)
    assert np.abs(got - mat).max() <= step


def test_compressed_constant_matrix_and_float64(rng, jax_codec):
    for mat in (np.full((12, 3), 2.5), np.full((4, 3), -1.0),
                rng.normal(size=(20, 5))):   # float64 in, float32 coded
        assert encoded(kaldi_ark, mat) == encoded(jax_codec, mat)


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_compressing_non_finite_raises(rng, bad):
    for rows in (3, 12):
        mat = rng.normal(size=(rows, 4))
        mat[1, 2] = bad
        for mod in (jax_ark, kaldi_ark):
            with pytest.raises(ValueError, match="non-finite"):
                encoded(mod, mat)
    for mod in (jax_ark, kaldi_ark):
        with pytest.raises(ValueError, match="shape"):
            encoded(mod, np.zeros((0, 3)))


def test_compressed_formats_2_and_3_read_as_jax(tmp_path, rng, jax_codec):
    """Formats 2 and 3 as stock Kaldi writes them (built by hand, as
    tests/test_data_io.py builds them: the JAX writer emits 1 and 2)."""
    import struct
    rows, cols = 5, 7
    ark = tmp_path / "cm23.ark"
    offsets = {}
    with open(ark, "wb") as f:
        for fmt, dtype, top in (("2", "<u2", 65535), ("3", np.uint8, 255)):
            codes = rng.integers(0, top + 1, size=rows * cols).astype(dtype)
            offsets[fmt] = f.tell()
            f.write(f"\0BCM{fmt} ".encode())
            f.write(struct.pack("<ffii", -2.5, 9.0, rows, cols))
            f.write(codes.tobytes())
    for fmt, off in offsets.items():
        got = kaldi_ark.read_ark_matrix(str(ark), off)
        assert got.dtype == np.float32 and got.shape == (rows, cols)
        np.testing.assert_array_equal(
            got, jax_codec.read_ark_matrix(str(ark), off))


def test_compressed_ark_writer_bytes_and_scp_identical(tmp_path, rng,
                                                       jax_codec):
    """ArkWriter(compress=True), and a per-utterance override, write the
    JAX writer's bytes and scp offsets; the scp reads back alike."""
    utts = [(f"u{i}", compressible(rng, n)) for i, n in
            enumerate((3, 40, 8, 9, 120))]
    out = {}
    for name, mod in (("jax", jax_codec), ("port", kaldi_ark)):
        d = tmp_path / name
        d.mkdir()
        ark = str(d / "feats.ark")
        with mod.ArkWriter(str(d / "feats.scp"), compress=True) as w:
            for k, (utt, mat) in enumerate(utts):
                w.write_next_utt(ark, utt, mat,
                                 compress=False if k == 2 else None)
        out[name] = (open(ark, "rb").read(),
                     [o for _, _, o in mod.read_scp(str(d / "feats.scp"))],
                     str(d / "feats.scp"))
    assert out["jax"][:2] == out["port"][:2]
    mine = dict(iter(kaldi_ark.ScpReader(out["port"][2])))
    ref = dict(iter(jax_codec.ScpReader(out["jax"][2])))
    assert list(mine) == list(ref) == [u for u, _ in utts]
    for utt in ref:
        assert_decoded_alike(mine[utt], ref[utt], jax_codec)
    np.testing.assert_array_equal(mine["u2"], utts[2][1])  # not compressed


def test_write_matrix_bytes_identical(tmp_path, rng):
    mat = rng.normal(size=(4, 5))
    blobs = []
    for mod in (jax_ark, kaldi_ark):
        path = tmp_path / f"{mod.__name__}.bin"
        with open(path, "wb") as f:
            mod.write_matrix(f, mat)
        blobs.append(path.read_bytes())
    assert blobs[0] == blobs[1]


@pytest.mark.parametrize("left,right", [(0, 0), (2, 1), (3, 0)])
def test_splice_identical(rng, left, right):
    feats = rng.normal(size=(9, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        splice.splice_frames_np(feats, left, right),
        jax_splice.splice_frames_np(feats, left, right))


@pytest.mark.parametrize("left,right", [(0, 0), (2, 1)])
def test_infer_batches_identical(tmp_path, rng, left, right):
    path = str(tmp_path / "t.rtu")
    with store.StoreWriter(path) as w:
        for utt, x, _ in utterances(rng, n=4) + [
                ("long", rng.normal(size=(130, 7)).astype(np.float32),
                 None)]:
            w.add(utt, x)
    mine = list(dataset.infer_batches(store.UtteranceStore(path), left,
                                      right))
    ref = list(jax_dataset.infer_batches(jax_store.UtteranceStore(path),
                                         left, right))
    assert len(mine) == len(ref) == 5
    for a, b in zip(mine, ref):
        assert a.utt_ids == b.utt_ids and a.labels is None
        assert a.inputs.dtype == b.inputs.dtype == np.float32
        np.testing.assert_array_equal(a.inputs, b.inputs)
        np.testing.assert_array_equal(a.lengths, b.lengths)
    assert mine[-1].inputs.shape[1] == 256  # 130 frames pad to 2 x 128


def test_cmvn_npz_identical(tmp_path, rng):
    path = str(tmp_path / "train_cmvn.npz")
    np.savez(path, mean_inputs=rng.normal(size=7),
             stddev_inputs=rng.uniform(1, 2, 7),
             mean_labels=rng.normal(size=3),
             stddev_labels=rng.uniform(1, 2, 3))
    feats = rng.normal(size=(5, 3))
    for mine, ref in zip(cmvn.load_cmvn_npz(path),
                         jax_cmvn.load_cmvn_npz(path)):
        np.testing.assert_array_equal(mine.mean, ref.mean)
        np.testing.assert_array_equal(mine.stddev, ref.stddev)
    labels, ref_labels = (cmvn.load_cmvn_npz(path)[1],
                          jax_cmvn.load_cmvn_npz(path)[1])
    np.testing.assert_array_equal(labels.denormalize(feats),
                                  ref_labels.denormalize(feats))
    np.testing.assert_array_equal(labels.apply(feats),
                                  ref_labels.apply(feats))
    assert os.path.isfile(path)


def test_sequence_batcher_matches_jax(tmp_path):
    """Same seed, same store: the port's SequenceBatcher gives the JAX
    package's batches, in order, bit for bit (both drop_remainder modes
    and without shuffling)."""
    from rsrgan_tpu.data import SequenceBatcher as JaxBatcher
    from rsrgan_tpu.data import UtteranceStore as JaxStore
    from rsrgan_tpu_torch.data import SequenceBatcher, StoreWriter
    from rsrgan_tpu_torch.data import UtteranceStore as PortStore
    rng = np.random.default_rng(0)
    path = str(tmp_path / "s.rtu")
    with StoreWriter(path) as w:
        for i in range(40):
            n = int(rng.integers(150, 620))
            w.add(f"u{i}", rng.normal(size=(n, 5)).astype(np.float32),
                  rng.normal(size=(n, 3)).astype(np.float32))
    for kw in ({}, {"drop_remainder": False}, {"shuffle": False},
               {"left_context": 1, "right_context": 2}):
        ours = list(SequenceBatcher(PortStore([path]), 3, seed=5, **kw))
        ref = list(JaxBatcher(JaxStore([path]), 3, seed=5, **kw))
        assert len(ours) == len(ref) > 0
        for a, b in zip(ours, ref):
            assert a.utt_ids == b.utt_ids
            for x, y in ((a.inputs, b.inputs), (a.labels, b.labels),
                         (a.lengths, b.lengths)):
                assert x.dtype == y.dtype and x.shape == y.shape
                assert np.array_equal(x, y)


@pytest.mark.parametrize("kw", [{}, {"drop_remainder": False},
                                {"shuffle": False},
                                {"left_context": 2, "right_context": 1},
                                {"left_context": 5, "right_context": 5}])
def test_frame_batcher_matches_jax(tmp_path, kw):
    """Same seed, same store: the port's FrameBatcher gives the JAX
    package's frame batches, in order, bit for bit, over two epochs (the
    second a new permutation from the same generator); the frame tables,
    num_frames and num_batches equal; a store without labels gives None
    labels."""
    from rsrgan_tpu.data import FrameBatcher as JaxBatcher
    from rsrgan_tpu.data import UtteranceStore as JaxStore
    from rsrgan_tpu_torch.data import FrameBatcher, StoreWriter
    from rsrgan_tpu_torch.data import UtteranceStore as PortStore
    rng = np.random.default_rng(1)
    path, bare = str(tmp_path / "f.rtu"), str(tmp_path / "bare.rtu")
    with StoreWriter(path) as w, StoreWriter(bare) as wb:
        for i in range(6):
            n = int(rng.integers(20, 60))
            x = rng.normal(size=(n, 5)).astype(np.float32)
            w.add(f"u{i}", x, rng.normal(size=(n, 3)).astype(np.float32))
            wb.add(f"u{i}", x)
    ours = FrameBatcher(PortStore([path]), 16, seed=5, **kw)
    ref = JaxBatcher(JaxStore([path]), 16, seed=5, **kw)
    assert np.array_equal(ours.inputs, ref.inputs)
    assert np.array_equal(ours.labels, ref.labels)
    assert ours.num_frames == ref.num_frames
    assert ours.num_batches() == ref.num_batches()
    for _ in range(2):
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == ref.num_batches()
        for (x, y), (xr, yr) in zip(got, want):
            assert x.dtype == xr.dtype and y.dtype == yr.dtype
            assert np.array_equal(x, xr) and np.array_equal(y, yr)
    no_labels = FrameBatcher(PortStore([bare]), 16, seed=5, **kw)
    assert np.array_equal(no_labels.inputs, ours.inputs)
    assert all(y is None for _, y in no_labels)


def test_staged_decay_matches_jax():
    from rsrgan_tpu.training.schedules import staged_decay as jax_decay
    from rsrgan_tpu_torch.training import staged_decay
    for steps in range(6):
        for factor in (0.5, 0.7):
            assert staged_decay(3e-4, factor, steps) == \
                jax_decay(3e-4, factor, steps)


# ---------------------------------------------------------------------------
# CMVN stats, the store's preparation, the synthetic corpus
# ---------------------------------------------------------------------------

def test_cmvn_accumulator_and_kaldi_stats_identical(tmp_path, rng):
    feats = [rng.normal(2.0, 3.0, size=(n, 7)) for n in (5, 17, 1)]
    accs = [cmvn.CmvnAccumulator(7), jax_cmvn.CmvnAccumulator(7)]
    for acc in accs:
        for f in feats:
            acc.accumulate(f)
    np.testing.assert_array_equal(accs[0].stats_matrix(),
                                  accs[1].stats_matrix())
    for a, b in zip((accs[0].finalize(),), (accs[1].finalize(),)):
        np.testing.assert_array_equal(a.mean, b.mean)
        np.testing.assert_array_equal(a.stddev, b.stddev)
    paths = []
    for mod, acc in zip((cmvn, jax_cmvn), accs):
        paths.append(str(tmp_path / f"{mod.__name__}.cmvn"))
        mod.write_kaldi_cmvn(paths[-1], acc.stats_matrix())
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    np.testing.assert_array_equal(cmvn.read_kaldi_cmvn(paths[1]),
                                  jax_cmvn.read_kaldi_cmvn(paths[1]))
    with pytest.raises(ValueError, match="features"):
        accs[0].accumulate(np.zeros((3, 6)))


def test_convert_cmvn_to_numpy_identical(tmp_path, rng):
    stats = {}
    for name, dim in (("inputs", 7), ("labels", 3)):
        acc = cmvn.CmvnAccumulator(dim)
        acc.accumulate(rng.normal(size=(30, dim)))
        stats[name] = str(tmp_path / f"{name}.cmvn")
        cmvn.write_kaldi_cmvn(stats[name], acc.stats_matrix())
    outs = []
    for mod in (cmvn, jax_cmvn):
        d = tmp_path / mod.__name__
        d.mkdir()
        outs.append(mod.convert_cmvn_to_numpy(stats["inputs"],
                                              stats["labels"], str(d)))
    with np.load(outs[0]) as a, np.load(outs[1]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.fixture
def scp_pair(tmp_path, rng):
    """Paired inputs/labels scp files (half compressed), CMVN from their
    stats, and an rt60 table."""
    d = tmp_path / "scp"
    d.mkdir()
    with kaldi_ark.ArkWriter(str(d / "inputs.scp")) as wi, \
            kaldi_ark.ArkWriter(str(d / "labels.scp")) as wl, \
            open(d / "rt60.scp", "w") as rt:
        for i in range(6):
            n = int(rng.integers(3, 30))
            wi.write_next_utt(str(d / "inputs.ark"), f"utt{i}",
                              rng.normal(1, 2, size=(n, 7)),
                              compress=bool(i % 2))
            wl.write_next_utt(str(d / "labels.ark"), f"utt{i}",
                              rng.normal(size=(n, 3)))
            rt.write(f"utt{i} {0.2 + 0.1 * i}\n")
    norm = (cmvn.Cmvn(rng.normal(size=7), rng.uniform(1, 2, 7)),
            cmvn.Cmvn(rng.normal(size=3), rng.uniform(1, 2, 3)))
    return d, norm


@pytest.mark.parametrize("mode", ["labels", "test", "rt60", "no_cmvn"])
def test_build_store_from_scp_bytes_identical(tmp_path, scp_pair, jax_codec,
                                              mode):
    """Byte-equal stores where the JAX package decodes with numpy; with
    its C codec loaded the compressed utterances differ by its float32
    rounding (``assert_decoded_alike``) and the rest is equal."""
    d, (ci, cl) = scp_pair
    kw = dict(labels_scp=None if mode == "test" else str(d / "labels.scp"),
              inputs_cmvn=None if mode == "no_cmvn" else ci,
              labels_cmvn=None if mode in ("no_cmvn", "test") else cl,
              rt60_scp=str(d / "rt60.scp") if mode == "rt60" else None)
    paths, counts = [], []
    for mod in (store, jax_store):
        paths.append(str(tmp_path / f"{mod.__name__}.rtu"))
        counts.append(mod.build_store_from_scp(str(d / "inputs.scp"),
                                               paths[-1], **kw))
        assert mod.verify_store(paths[-1]) == (6, 0)
    assert counts == [6, 6]
    if jax_codec._native is None:
        assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    got, want = store.UtteranceStore(paths[0]), store.UtteranceStore(paths[1])
    assert got.utt_ids == want.utt_ids
    assert got.input_dim == want.input_dim == 7 + (mode == "rt60")
    assert got.has_labels == want.has_labels == (mode != "test")
    for i in range(6):
        # back to the decoded values' scale, where the gate is stated
        scale = ci.stddev.min() if mode != "no_cmvn" else 1.0
        assert_decoded_alike(got.inputs(i) * scale, want.inputs(i) * scale,
                             jax_codec)
        if got.has_labels:
            np.testing.assert_array_equal(got.labels(i), want.labels(i))


def test_build_store_rejects_mispaired_scp(tmp_path, scp_pair):
    d, _ = scp_pair
    lines = (d / "labels.scp").read_text().splitlines()
    (d / "swapped.scp").write_text("\n".join([lines[1], lines[0]]
                                             + lines[2:]) + "\n")
    (d / "short.scp").write_text("\n".join(lines[:-1]) + "\n")
    for mod in (store, jax_store):
        with pytest.raises(AssertionError, match="utt id mismatch"):
            mod.build_store_from_scp(str(d / "inputs.scp"),
                                     str(tmp_path / "x.rtu"),
                                     str(d / "swapped.scp"))
        with pytest.raises(ValueError, match="length mismatch"):
            mod.build_store_from_scp(str(d / "inputs.scp"),
                                     str(tmp_path / "y.rtu"),
                                     str(d / "short.scp"))


def test_verify_store_counts_bad_entries_as_jax(tmp_path, rng):
    """An index entry pointing past the end of the file is counted bad by
    both; a broken footer raises in both."""
    import json
    import struct
    path = str(tmp_path / "s.rtu")
    with store.StoreWriter(path) as w:
        for utt, x, y in utterances(rng, n=3):
            w.add(utt, x, y)
    blob = open(path, "rb").read()
    n = struct.unpack("<Q", blob[-12:-4])[0]
    index = json.loads(blob[-12 - n:-12])
    index[1]["ir"] += 1000
    index[1]["lr"] += 1000
    new = json.dumps(index).encode()
    bad = str(tmp_path / "bad.rtu")
    with open(bad, "wb") as f:
        f.write(blob[:-12 - n] + new + struct.pack("<Q", len(new)) + b"RTU1")
    assert store.verify_store(bad) == jax_store.verify_store(bad) == (3, 1)
    with open(bad, "r+b") as f:
        f.truncate(len(blob) - 2)
    for mod in (store, jax_store):
        with pytest.raises(ValueError):
            mod.verify_store(bad)


def test_synthetic_corpus_bytes_identical(tmp_path):
    from rsrgan_tpu.data.synthetic import make_synthetic_corpus as jax_make
    from rsrgan_tpu_torch.data.synthetic import make_synthetic_corpus
    for fn, name in ((jax_make, "jax"), (make_synthetic_corpus, "port")):
        fn(str(tmp_path / name), num_utts=4, input_dim=9, output_dim=3,
           min_len=5, max_len=20, seed=3)
    for f in ("inputs.ark", "labels.ark", "inputs.cmvn", "labels.cmvn"):
        assert ((tmp_path / "jax" / f).read_bytes()
                == (tmp_path / "port" / f).read_bytes()), f
    for f in ("inputs.scp", "labels.scp"):
        assert ((tmp_path / "jax" / f).read_text().replace("/jax/", "/")
                == (tmp_path / "port" / f).read_text().replace("/port/",
                                                               "/")), f
