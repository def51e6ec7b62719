"""SEGAN and bnlstm through both CLIs on the CPU, on one micro corpus.

* ``--trainer=segan`` at toy depth (``--g_enc_depths=8,16,32``): the
  port's CLI trains two epochs (the auto-encoder G with ``--g_nl=prelu``
  and the bias flags, and the WaveNet-style G of ``--g_type=wave``), its
  metrics rows carry SEGAN's losses, finite; its checkpoint restores into
  the JAX CLI's own state byte for byte; and each package decodes it to
  the same ark (G with z = 0).
* The JAX CLI's SEGAN checkpoint decoded by the port to the JAX decode's
  ark.
* ``--trainer=rnn --g_type=bnlstm`` (the recipes' widths, a few frames):
  the port's CLI trains an epoch on the host feed and on the device feed
  (the same checkpoint bytes), and both packages decode its checkpoint,
  the cells' moving statistics from it, to the same ark.

z and D's noise come from torch's generators in the port and from
jax.random in JAX, so training runs are compared by what they write, not
number for number (the steps are: ``tests/test_torch_segan.py``).
Decodes agree to 1e-5.
"""

import json
import os
import shutil

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsrgan_tpu.cli import prepare as prepare_cli
from rsrgan_tpu.cli import train as jax_train
from rsrgan_tpu.data.synthetic import make_synthetic_corpus
from rsrgan_tpu_torch.cli import train as port_train
from rsrgan_tpu_torch.data import ScpReader
from rsrgan_tpu_torch.training import checkpoints as ckpt

torch.set_num_threads(2)

IN, OUT = 16, 6
SEGAN = ["--trainer=segan", "--g_enc_depths=8,16,32", "--left_context=1",
         "--right_context=1", "--batch_size=32", "--disc_updates=1",
         "--gen_updates=1", "--g_learning_rate=0.0005",
         "--d_learning_rate=0.0005", "--init_l1_weight=10.0",
         "--init_disc_noise_std=0.1", "--min_epoches=1", "--max_epoches=2"]
BNLSTM = ["--trainer=rnn", "--g_type=bnlstm", "--batch_size=4",
          "--g_learning_rate=0.0005", "--min_epoches=1", "--max_epoches=1",
          "--bf16=false"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tr/cv stores with labels, a test store and the CMVN of a synthetic
    corpus (12 utterances of 20-40 frames: 10 train, 2 cv)."""
    data_dir = str(tmp_path_factory.mktemp("segan_corpus"))
    make_synthetic_corpus(data_dir, num_utts=12, input_dim=IN,
                          output_dim=OUT, min_len=20, max_len=40)
    assert prepare_cli.main(["cmvn", f"--inputs={data_dir}/inputs.cmvn",
                             f"--labels={data_dir}/labels.cmvn",
                             f"--save_dir={data_dir}"]) == 0
    assert prepare_cli.main(["split", "--val_size=2",
                             f"--data_dir={data_dir}", "--seed=1"]) == 0
    stores = os.path.join(data_dir, "stores")
    for sub in ("tr", "cv"):
        assert prepare_cli.main([
            "make-store", f"--inputs={data_dir}/{sub}/inputs.scp",
            f"--labels={data_dir}/{sub}/labels.scp",
            f"--cmvn_dir={data_dir}", f"--output_dir={stores}",
            f"--name={sub}"]) == 0
        with open(os.path.join(data_dir, f"{sub}.list"), "w") as f:
            f.write(os.path.join(stores, f"{sub}.rtu") + "\n")
    assert prepare_cli.main([
        "make-store", f"--inputs={data_dir}/cv/inputs.scp",
        f"--cmvn_dir={data_dir}", f"--output_dir={stores}",
        "--name=test", "--test"]) == 0
    with open(os.path.join(data_dir, "test.list"), "w") as f:
        f.write(os.path.join(stores, "test.rtu") + "\n")
    return data_dir


def common(data_dir):
    return [f"--input_dim={IN}", f"--output_dim={OUT}", "--seed=3",
            f"--data_dir={data_dir}", f"--tr_list_file={data_dir}/tr.list",
            f"--cv_list_file={data_dir}/cv.list",
            f"--test_list_file={data_dir}/test.list", "--tensorboard=false"]


def rows(save_dir, split):
    with open(os.path.join(save_dir, f"metrics_{split}.jsonl")) as f:
        return [json.loads(line) for line in f]


def read_ark(save_dir):
    return dict(iter(ScpReader(os.path.join(save_dir, "test",
                                            "feats.scp"))))


def decode_both(src, argv, tmp_path, tag):
    """{package: ark} of each CLI's --decode of the checkpoint in src (a
    copy each)."""
    arks = {}
    for name, main, extra in (("jax", jax_train.main, []),
                              ("port", port_train.main, ["--device=cpu"])):
        d = str(tmp_path / f"{tag}_by_{name}")
        shutil.copytree(src, d)
        assert main(["--decode", *argv, f"--save_dir={d}", *extra]) == 0
        arks[name] = read_ark(d)
    return arks


def assert_same_arks(got, want, utts=2):
    assert list(got) == list(want) and len(want) == utts
    for utt, mat in want.items():
        assert got[utt].shape == mat.shape and mat.shape[1] == OUT
        assert np.isfinite(mat).all()
        np.testing.assert_allclose(got[utt], mat, atol=1e-5, err_msg=utt)


def jax_state_of(argv, data_dir):
    """The JAX CLI's own state for these flags (build_trainer and
    init_state on the first train batch, as its frame loop does)."""
    from rsrgan_tpu.data import FrameBatcher, UtteranceStore, read_list_file
    args, _ = jax_train.build_parser().parse_known_args(argv)
    trainer = jax_train.build_trainer(args, jnp.float32)
    x0, _ = next(iter(FrameBatcher(
        UtteranceStore(read_list_file(f"{data_dir}/tr.list")),
        args.batch_size, args.left_context, args.right_context)))
    return jax.jit(trainer.init_state)(jax.random.PRNGKey(0),
                                       jnp.asarray(x0))


@pytest.mark.parametrize("g_flags", [
    ["--g_type=ae", "--g_nl=prelu", "--bias_downconv=true",
     "--bias_deconv=false", "--bias_d_conv=false"],
    ["--g_type=wave"],
])
def test_port_segan_cli_trains_and_both_decode(corpus, tmp_path, g_flags):
    """Two epochs through the port's CLI: SEGAN's metrics rows, finite; a
    checkpoint that flax restores into the JAX CLI's state and writes
    back byte for byte; both packages' decodes of it equal."""
    save = str(tmp_path / "port")
    argv = [*SEGAN, *g_flags, *common(corpus)]
    assert port_train.main([*argv, f"--save_dir={save}", "--device=cpu"]) \
        == 0
    for split, n in (("train", 2), ("eval", 2)):
        got = rows(save, split)
        assert len(got) == n
        for row in got:
            for k in port_train.SEGAN_METRICS:
                assert np.isfinite(row[k]), (split, k)
    path = ckpt.latest_checkpoint(save, "SEGAN")
    assert path is not None
    with open(path, "rb") as f:
        port_bytes = f.read()
    tree = ckpt.msgpack_restore(port_bytes)
    assert tree["g"]["extra"] is None
    assert list(tree["d"]["extra"]) == ["vbn_stats"]
    assert list(tree["g"]["opt_state"]["1"]) == ["nu"]   # RMSProp
    restored = flax.serialization.from_bytes(jax_state_of(argv, corpus),
                                             port_bytes)
    assert flax.serialization.to_bytes(restored) == port_bytes
    arks = decode_both(save, argv, tmp_path, "segan")
    assert_same_arks(arks["port"], arks["jax"])


def test_port_decodes_jax_segan_checkpoint(corpus, tmp_path):
    """The JAX CLI trains an epoch; the port decodes its checkpoint to the
    JAX decode's ark."""
    save = str(tmp_path / "jax")
    argv = [*SEGAN[:-1], "--max_epoches=1", "--g_type=ae", *common(corpus)]
    assert jax_train.main([*argv, f"--save_dir={save}"]) == 0
    arks = decode_both(save, argv, tmp_path, "jax_segan")
    assert_same_arks(arks["port"], arks["jax"])


def test_port_bnlstm_cli_trains_and_both_decode(corpus, tmp_path):
    """--trainer=rnn --g_type=bnlstm on both feeds (the same checkpoint
    bytes and metrics), batch_stats in the checkpoint, and both packages'
    decodes of it equal (batched, --decode_batch_size=4)."""
    saved = {}
    for feed in ("off", "on"):
        save = str(tmp_path / f"bnlstm_{feed}")
        assert port_train.main([*BNLSTM, f"--device_feed={feed}",
                                *common(corpus), f"--save_dir={save}",
                                "--device=cpu"]) == 0
        with open(ckpt.latest_checkpoint(save, "RNNTrainer"), "rb") as f:
            saved[feed] = (f.read(), rows(save, "train"), rows(save, "eval"))
        assert np.isfinite(saved[feed][1][0]["g_loss"])
    assert saved["on"][0] == saved["off"][0]
    drop = ("train_frames_per_sec", "train_secs")
    assert ([{k: v for k, v in r.items() if k not in drop}
             for r in saved["on"][1]]
            == [{k: v for k, v in r.items() if k not in drop}
                for r in saved["off"][1]])
    tree = ckpt.msgpack_restore(saved["off"][0])
    assert sorted(tree["net"]["extra"]["batch_stats"]) == [
        "cell_0", "cell_1", "cell_2"]
    arks = decode_both(str(tmp_path / "bnlstm_off"),
                       [*BNLSTM, "--decode_batch_size=4", *common(corpus)],
                       tmp_path, "bnlstm")
    assert_same_arks(arks["port"], arks["jax"])
