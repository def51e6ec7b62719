"""The decode slice end to end: the JAX ``cli.train --decode`` and the
port's, from one JAX-written res_lstm_l checkpoint of a synthetic corpus,
write arks that agree; plus the port's import and device contracts."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsrgan_tpu.cli import prepare as prepare_cli
from rsrgan_tpu.cli import train as jax_train
from rsrgan_tpu.data.synthetic import make_synthetic_corpus
from rsrgan_tpu.training import save_checkpoint
from rsrgan_tpu_torch.cli import train as port_train
from rsrgan_tpu_torch.data import ScpReader

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IN_DIM, OUT_DIM = 16, 6
FLAGS = ["--decode", "--trainer=gan_rnn", "--g_type=res_lstm_l",
         f"--input_dim={IN_DIM}", f"--output_dim={OUT_DIM}", "--bf16=false"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Test store + CMVN of a synthetic corpus, and a JAX-initialised
    gan_rnn res_lstm_l checkpoint (G: 4 x LSTM(760, proj 16))."""
    data_dir = str(tmp_path_factory.mktemp("corpus"))
    make_synthetic_corpus(data_dir, num_utts=6, input_dim=IN_DIM,
                          output_dim=OUT_DIM, min_len=30, max_len=60)
    assert prepare_cli.main(["cmvn", f"--inputs={data_dir}/inputs.cmvn",
                             f"--labels={data_dir}/labels.cmvn",
                             f"--save_dir={data_dir}"]) == 0
    stores = os.path.join(data_dir, "stores")
    assert prepare_cli.main([
        "make-store", f"--inputs={data_dir}/inputs.scp",
        f"--cmvn_dir={data_dir}", f"--output_dir={stores}", "--name=test",
        "--test"]) == 0
    test_list = os.path.join(data_dir, "test.list")
    with open(test_list, "w") as f:
        f.write(os.path.join(stores, "test.rtu") + "\n")

    args = jax_train.build_parser().parse_args(FLAGS[1:] +
                                               ["--lstm_impl=scan"])
    trainer = jax_train.build_trainer(args, jnp.float32)
    x = jnp.zeros((1, 128, IN_DIM), jnp.float32)
    state = trainer.init_state(jax.random.PRNGKey(3), x,
                               jnp.asarray([100], jnp.int32))
    # non-zero biases exercise the bias and forget-bias paths
    rng = np.random.default_rng(5)
    g = jax.tree.map(np.asarray, state.g.params)
    for node in g.values():
        node["bias"] = rng.normal(0, 0.2, node["bias"].shape).astype(
            np.float32)
    state = state.replace(g=state.g.replace(params=g))
    ckpt_dir = os.path.join(data_dir, "ckpt")
    save_checkpoint(ckpt_dir, "GAN_RNN", state, 1,
                    meta=jax_train.ckpt_meta(args))
    return data_dir, test_list, ckpt_dir


def decode(main, corpus, tag, *flags):
    data_dir, test_list, ckpt_dir = corpus
    save_dir = os.path.join(data_dir, tag)
    shutil.copytree(ckpt_dir, save_dir)
    rc = main(FLAGS + [f"--data_dir={data_dir}",
                       f"--test_list_file={test_list}",
                       f"--save_dir={save_dir}", *flags])
    assert rc == 0
    return dict(iter(ScpReader(os.path.join(save_dir, "test",
                                            "feats.scp"))))


@pytest.fixture(scope="module")
def jax_arks(corpus):
    return {b: decode(jax_train.main, corpus, f"jax_b{b}",
                      "--lstm_impl=scan", f"--decode_batch_size={b}")
            for b in (1, 3)}


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("impl", ["auto", "scan", "pallas"])
def test_port_decode_matches_jax_decode(corpus, jax_arks, batch, impl):
    got = decode(port_train.main, corpus, f"port_{impl}_b{batch}",
                 "--device=cpu", f"--lstm_impl={impl}",
                 f"--decode_batch_size={batch}")
    want = jax_arks[batch]
    assert list(got) == list(want) and len(got) == 6
    for utt, mat in want.items():
        assert got[utt].shape == mat.shape
        np.testing.assert_allclose(got[utt], mat, atol=1e-4)


def test_cuda_device_without_gpu_raises(corpus, monkeypatch):
    """--device=cuda (the default) never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data_dir, test_list, ckpt_dir = corpus
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.main(FLAGS + [f"--data_dir={data_dir}",
                                 f"--test_list_file={test_list}",
                                 f"--save_dir={ckpt_dir}"])


@pytest.mark.parametrize("flags,ranks", [
    pytest.param(["--trainer=segan", "--num_gpu=2"], 2,
                 id="flags0-Parallel"),
    pytest.param(["--decode", "--trainer=segan", "--num_gpu=2"], 1,
                 id="flags1-Parallel"),
    pytest.param(["--decode", "--num_gpu=2"], 1, id="flags2-Parallel"),
])
def test_unported_paths_name_their_roadmap_item(corpus, flags, ranks):
    """The rank count of each path that raised NotImplementedError naming
    ROADMAP.md's item 'Parallel' (hence the name) before data parallelism
    was ported: ``spawned_ranks`` gives 2 for --num_gpu=2 SEGAN training
    (trained over two ranks in tests/test_torch_cli_frame.py) and 1 for
    the decodes JAX does not spread over its mesh (SEGAN's, a sequence
    decode at batch 1); the batch-1 decode also runs here and writes the
    one-process ark."""
    data_dir, test_list, ckpt_dir = corpus
    save_dir = os.path.join(data_dir, "unported")
    shutil.rmtree(save_dir, ignore_errors=True)
    shutil.copytree(ckpt_dir, save_dir)
    argv = flags + [
        "--g_type=res_lstm_l", f"--input_dim={IN_DIM}",
        f"--output_dim={OUT_DIM}", "--device=cpu",
        f"--data_dir={data_dir}", f"--test_list_file={test_list}",
        f"--save_dir={save_dir}"]
    assert port_train.spawned_ranks(port_train.parse_args(argv)[0]) == ranks
    if flags == ["--decode", "--num_gpu=2"]:
        assert port_train.main(argv + ["--bf16=false"]) == 0
        got = dict(iter(ScpReader(os.path.join(save_dir, "test",
                                                "feats.scp"))))
        want = decode(port_train.main, corpus, "unported_one",
                      "--device=cpu")
        assert list(got) == list(want) and len(want) == 6
        for utt, mat in want.items():
            np.testing.assert_array_equal(got[utt], mat)


def test_checkpoint_config_mismatch_is_legible(corpus):
    data_dir, test_list, ckpt_dir = corpus
    with pytest.raises(SystemExit, match="g_type"):
        port_train.main(["--decode", "--trainer=gan_rnn",
                         "--g_type=res_lstm_base", f"--input_dim={IN_DIM}",
                         f"--output_dim={OUT_DIM}", "--device=cpu",
                         f"--data_dir={data_dir}",
                         f"--test_list_file={test_list}",
                         f"--save_dir={ckpt_dir}"])


def test_port_imports_without_jax_flax_msgpack():
    """Every module of the port (and chip_smoke.py) imports with jax,
    flax and msgpack made unimportable, and the CLI runs --help."""
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'msgpack'):\n"
        "    sys.modules[name] = None\n"
        "import importlib, pkgutil, rsrgan_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    rsrgan_tpu_torch.__path__, 'rsrgan_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert not any(n.startswith('rsrgan_tpu.') or n == 'rsrgan_tpu'\n"
        "               for n in sys.modules), 'JAX package imported'\n"
        "print(len(mods))\n"
        "sys.argv = ['train', '--help']\n"
        "from rsrgan_tpu_torch.cli import train\n"
        "try:\n"
        "    train.main()\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[0]) >= 15
    assert "--device" in proc.stdout


def test_no_jax_import_lines_in_port():
    pkg = os.path.join(REPO, "rsrgan_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    for line in f:
                        words = line.split()
                        assert not (words[:1] in (["import"], ["from"])
                                    and words[1].split(".")[0]
                                    in ("jax", "flax", "msgpack")), line


def test_chip_smoke_fails_without_cuda_or_repo(tmp_path):
    """chip_smoke.py prints no result and exits non-zero where there is no
    CUDA device, and where it stands alone without the repository."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((REPO, os.path.join(REPO, "chip_smoke.py")),
                        (str(tmp_path), str(tmp_path / "chip_smoke.py"))):
        if cwd != REPO:
            shutil.copy(os.path.join(REPO, "chip_smoke.py"), script)
        proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
