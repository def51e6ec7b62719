"""The port's data preparation CLI (``python -m rsrgan_tpu_torch.cli.prepare``)
against the JAX package's (``rsrgan_tpu.cli.prepare``): every subcommand
on the same scp, ark, store and TFRecord files gives byte-equal outputs
(``train_cmvn.npz`` by array equality), the same exit code and the same
printed lines; and the port's two CLIs import no jax, flax or JAX
package module."""

import os
import shutil
import struct
import subprocess
import sys

import numpy as np
import pytest

from rsrgan_tpu.cli import prepare as jax_prepare
from rsrgan_tpu.data import kaldi_ark as jax_ark
from rsrgan_tpu.data.synthetic import make_synthetic_corpus
from rsrgan_tpu.training.tensorboard import _bytes_field, tfrecord_frame
from rsrgan_tpu_torch.cli import prepare as port_prepare
from rsrgan_tpu_torch.data import ArkWriter, CmvnAccumulator, StoreWriter
from rsrgan_tpu_torch.data import write_kaldi_cmvn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IN_DIM, OUT_DIM = 9, 4
CLIS = (("jax", jax_prepare), ("port", port_prepare))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A synthetic Kaldi corpus (arks, scp files, CMVN stats) and an rt60
    table, shared read-only by the tests."""
    d = str(tmp_path_factory.mktemp("prep"))
    make_synthetic_corpus(d, num_utts=11, input_dim=IN_DIM,
                          output_dim=OUT_DIM, min_len=5, max_len=40, seed=2)
    with open(os.path.join(d, "rt60.scp"), "w") as f:
        for i in range(11):
            f.write(f"utt{i:04d} {0.1 * (i + 1):.2f}\n")
    return d


def run(capsys, main, argv, cwd_tag, root):
    """(exit code, stdout and stderr lines with ``root/cwd_tag`` made
    neutral) of one CLI call."""
    capsys.readouterr()
    rc = main(argv)
    out = capsys.readouterr()
    norm = lambda s: s.replace(os.path.join(root, cwd_tag), "<dir>")  # noqa
    return rc, norm(out.out).splitlines(), norm(out.err).splitlines()


def both(capsys, tmp_path, argv_of):
    """Run each package's CLI with ``argv_of(its own directory)``; assert
    equal exit codes and printed lines; return (rc, {tag: dir})."""
    results, dirs = {}, {}
    for tag, cli in CLIS:
        dirs[tag] = str(tmp_path / tag)
        os.makedirs(dirs[tag], exist_ok=True)
        results[tag] = run(capsys, cli.main, argv_of(dirs[tag]), tag,
                           str(tmp_path))
    assert results["jax"] == results["port"]
    return results["port"][0], dirs


def same_bytes(a: str, b: str) -> None:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


def test_cmvn(capsys, tmp_path, corpus):
    rc, dirs = both(capsys, tmp_path, lambda d: [
        "cmvn", f"--inputs={corpus}/inputs.cmvn",
        f"--labels={corpus}/labels.cmvn", f"--save_dir={d}"])
    assert rc == 0
    with np.load(os.path.join(dirs["jax"], "train_cmvn.npz")) as a, \
            np.load(os.path.join(dirs["port"], "train_cmvn.npz")) as b:
        assert sorted(a.files) == sorted(b.files) == [
            "mean_inputs", "mean_labels", "stddev_inputs", "stddev_labels"]
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("val_size,seed", [(3, 123), (4, 7), (11, 123)])
def test_split(capsys, tmp_path, corpus, val_size, seed):
    """The same shuffle (random.Random(seed)): identical tr/ and cv/ scp
    files; a val_size as large as the corpus exits 1 with the same
    message."""
    def argv(d):
        for name in ("inputs.scp", "labels.scp"):
            shutil.copy(os.path.join(corpus, name), d)
        return ["split", f"--val_size={val_size}", f"--data_dir={d}",
                f"--seed={seed}"]

    rc, dirs = both(capsys, tmp_path, argv)
    assert rc == (1 if val_size >= 11 else 0)
    if rc == 0:
        for sub in ("tr", "cv"):
            for name in ("inputs.scp", "labels.scp"):
                same_bytes(os.path.join(dirs["jax"], sub, name),
                           os.path.join(dirs["port"], sub, name))
        with open(os.path.join(dirs["port"], "cv", "inputs.scp")) as f:
            assert len(f.readlines()) == val_size


@pytest.mark.parametrize("flags", [
    [], ["--test"], [f"--rt60_scp=RT60"], ["--apply_cmvn=false"]],
    ids=["labels", "test", "rt60", "no_cmvn"])
def test_make_store(capsys, tmp_path, corpus, flags):
    cmvn_dir = str(tmp_path / "cmvn")
    os.makedirs(cmvn_dir)
    assert port_prepare.main([
        "cmvn", f"--inputs={corpus}/inputs.cmvn",
        f"--labels={corpus}/labels.cmvn", f"--save_dir={cmvn_dir}"]) == 0
    flags = [f.replace("RT60", os.path.join(corpus, "rt60.scp"))
             for f in flags]
    rc, dirs = both(capsys, tmp_path, lambda d: [
        "make-store", f"--inputs={corpus}/inputs.scp",
        f"--labels={corpus}/labels.scp", f"--cmvn_dir={cmvn_dir}",
        f"--output_dir={d}/stores", "--name=tr1", *flags])
    assert rc == 0
    same_bytes(os.path.join(dirs["jax"], "stores", "tr1.rtu"),
               os.path.join(dirs["port"], "stores", "tr1.rtu"))


def test_make_store_from_compressed_arks(capsys, tmp_path, monkeypatch,
                                         corpus):
    """Half the inputs compressed (formats 1 and 2): byte-equal stores
    where the JAX package decodes with its numpy codec, which the port
    copies (its C codec rounds otherwise: tests/test_torch_data.py)."""
    monkeypatch.setattr(jax_ark, "_native", None)
    rng = np.random.default_rng(4)
    d = str(tmp_path / "compressed")
    os.makedirs(d)
    acc = {"inputs": CmvnAccumulator(IN_DIM),
           "labels": CmvnAccumulator(OUT_DIM)}
    with ArkWriter(f"{d}/inputs.scp") as wi, \
            ArkWriter(f"{d}/labels.scp") as wl:
        for i, n in enumerate((3, 8, 9, 30, 17, 1)):
            x = rng.normal(2.0, 3.0, size=(n, IN_DIM)).astype(np.float32)
            y = rng.normal(size=(n, OUT_DIM)).astype(np.float32)
            wi.write_next_utt(f"{d}/inputs.ark", f"u{i}", x,
                              compress=i % 2 == 0)
            wl.write_next_utt(f"{d}/labels.ark", f"u{i}", y)
            acc["inputs"].accumulate(x)
            acc["labels"].accumulate(y)
    for name, a in acc.items():
        write_kaldi_cmvn(f"{d}/{name}.cmvn", a.stats_matrix())
    assert port_prepare.main(["cmvn", f"--inputs={d}/inputs.cmvn",
                              f"--labels={d}/labels.cmvn",
                              f"--save_dir={d}"]) == 0
    rc, dirs = both(capsys, tmp_path, lambda o: [
        "make-store", f"--inputs={d}/inputs.scp", f"--labels={d}/labels.scp",
        f"--cmvn_dir={d}", f"--output_dir={o}", "--name=c"])
    assert rc == 0
    same_bytes(os.path.join(dirs["jax"], "c.rtu"),
               os.path.join(dirs["port"], "c.rtu"))


@pytest.mark.parametrize("nj", [1, 3, 4])
def test_split_scp(capsys, tmp_path, corpus, nj):
    def argv(d):
        for name in ("inputs.scp", "labels.scp"):
            shutil.copy(os.path.join(corpus, name), d)
        return ["split-scp", f"--nj={nj}", f"--data_dir={d}"]

    rc, dirs = both(capsys, tmp_path, argv)
    assert rc == 0
    for name in ("inputs", "labels"):
        for j in range(1, nj + 1):
            same_bytes(os.path.join(dirs["jax"], f"split{nj}",
                                    f"{name}{j}.scp"),
                       os.path.join(dirs["port"], f"split{nj}",
                                    f"{name}{j}.scp"))


def test_split_scp_without_inputs_exits_1(capsys, tmp_path):
    rc, _ = both(capsys, tmp_path, lambda d: ["split-scp", "--nj=2",
                                              f"--data_dir={d}"])
    assert rc == 1


def small_store(path, rng, n=3):
    with StoreWriter(path) as w:
        for i in range(n):
            t = int(rng.integers(2, 9))
            w.add(f"s{i}", rng.normal(size=(t, 5)), rng.normal(size=(t, 2)))


def test_verify_store_verdicts(capsys, tmp_path):
    """Good stores: rc 0 and one OK line each; a truncated footer is
    CORRUPT, an entry past the end is BAD, either makes rc 1; the same
    lines from both CLIs."""
    import json
    rng = np.random.default_rng(6)
    good = [str(tmp_path / f"g{i}.rtu") for i in range(2)]
    for path in good:
        small_store(path, rng)
    rc, _ = both(capsys, tmp_path, lambda d: ["verify-store", *good])
    assert rc == 0
    blob = open(good[0], "rb").read()
    truncated = str(tmp_path / "truncated.rtu")
    with open(truncated, "wb") as f:
        f.write(blob[:-3])
    n = struct.unpack("<Q", blob[-12:-4])[0]
    index = json.loads(blob[-12 - n:-12])
    index[2]["ir"] += 500
    new = json.dumps(index).encode()
    bad = str(tmp_path / "bad.rtu")
    with open(bad, "wb") as f:
        f.write(blob[:-12 - n] + new + struct.pack("<Q", len(new)) + b"RTU1")
    rc, _ = both(capsys, tmp_path,
                 lambda d: ["verify-store", good[1], truncated, bad])
    assert rc == 1
    out = run(capsys, port_prepare.main,
              ["verify-store", good[1], truncated, bad], "x", str(tmp_path))
    assert [ln.split(": ", 1)[1][:7] for ln in out[1]] == [
        "3 utter", "CORRUPT", "3 utter"]
    assert out[1][2].endswith("1 BAD ENTRIES")


def test_select_data(capsys, tmp_path, corpus):
    keys = str(tmp_path / "keys")
    with open(keys, "w") as f:
        f.write("utt0003 x\n\nutt0007\nnot_there 1\n")
    rc, dirs = both(capsys, tmp_path, lambda d: [
        "select-data", f"--key_list={keys}",
        f"--raw_text={corpus}/labels.scp", f"--output={d}/selected"])
    assert rc == 0
    same_bytes(os.path.join(dirs["jax"], "selected"),
               os.path.join(dirs["port"], "selected"))
    with open(os.path.join(dirs["port"], "selected")) as f:
        assert [ln.split()[0] for ln in f] == ["utt0003", "utt0007"]


# ---------------------------------------------------------------------------
# from-tfrecords: SequenceExamples serialized by hand in the wire format
# io_funcs/tfrecords_io.py writes with TensorFlow
# ---------------------------------------------------------------------------

def feature_floats(row) -> bytes:
    """Feature{float_list (2): FloatList{value (1): packed floats}}."""
    return _bytes_field(2, _bytes_field(1, np.asarray(row, "<f4").tobytes()))


def sequence_example(utt_id: str, inputs, labels) -> bytes:
    bytes_feature = _bytes_field(1, _bytes_field(1, utt_id.encode()))
    context = _bytes_field(1, _bytes_field(1, b"utt_id")
                           + _bytes_field(2, bytes_feature))
    lists = b""
    for key, mat in (("inputs", inputs), ("labels", labels)):
        if mat is None:
            continue
        feature_list = b"".join(_bytes_field(1, feature_floats(r))
                                for r in mat)
        lists += _bytes_field(1, _bytes_field(1, key.encode())
                              + _bytes_field(2, feature_list))
    return _bytes_field(1, context) + _bytes_field(2, lists)


@pytest.mark.parametrize("with_labels", [True, False])
def test_from_tfrecords(capsys, tmp_path, with_labels):
    rng = np.random.default_rng(8)
    paths = []
    for k in range(2):
        paths.append(str(tmp_path / f"part{k}.tfrecords"))
        with open(paths[-1], "wb") as f:
            for i in range(3):
                t = int(rng.integers(2, 12))
                x = rng.normal(size=(t, 5)).astype(np.float32)
                y = (rng.normal(size=(t, 3)).astype(np.float32)
                     if with_labels else None)
                f.write(tfrecord_frame(sequence_example(f"p{k}u{i}", x, y)))
    rc, dirs = both(capsys, tmp_path, lambda d: [
        "from-tfrecords", "--tfrecords", *paths, f"--output_dir={d}",
        "--name=conv"])
    assert rc == 0
    same_bytes(os.path.join(dirs["jax"], "conv.rtu"),
               os.path.join(dirs["port"], "conv.rtu"))
    from rsrgan_tpu_torch.data import UtteranceStore
    store = UtteranceStore(os.path.join(dirs["port"], "conv.rtu"))
    assert len(store) == 6 and store.has_labels == with_labels
    assert store.utt_ids[4] == "p1u1"


def test_port_clis_import_no_jax_package():
    """python -m rsrgan_tpu_torch.cli.prepare and .train import neither
    jax, flax, msgpack nor any rsrgan_tpu module (they are not made
    unimportable here: the check is of what got loaded)."""
    code = (
        "import sys\n"
        "import rsrgan_tpu_torch.cli.prepare, rsrgan_tpu_torch.cli.train\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'flax', 'msgpack', 'rsrgan_tpu'))\n"
        "print(bad)\n"
        "assert not bad, bad\n"
        "assert 'torch' in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_prepare_runs_as_a_module_without_torch(tmp_path, corpus):
    """``python -m rsrgan_tpu_torch.cli.prepare`` as a process: its exit
    code, and it loads no torch (data preparation needs numpy alone)."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['prepare'] + sys.argv[1:]\n"
        "try:\n"
        "    runpy.run_module('rsrgan_tpu_torch.cli.prepare',\n"
        "                     run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert 'torch' not in sys.modules\n"
        "    raise\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code, "cmvn",
         f"--inputs={corpus}/inputs.cmvn", f"--labels={corpus}/labels.cmvn",
         f"--save_dir={tmp_path}"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f"Write to {tmp_path}/train_cmvn.npz"
