"""The training slice end to end on the CPU: the port's ``cli.train``
trains the flagship gan_rnn res_lstm_l on a micro corpus with
``--device=cpu`` (every kernel replaced by its plain twin), writes a
JAX-format checkpoint, and both packages decode it to arks that agree;
the JAX package resumes the port's checkpoint. ``--keep_prob`` reaches G
and D, ``--g_type=lstm`` trains and decodes alike in both packages,
``--tensorboard`` writes event files that match the JSONL metrics,
``--checkpoint_every_secs`` writes snapshots that a resume takes, and
``--decode --compress`` writes the JAX encoder's bytes, and
``--profile_dir`` writes one trace, of the second iteration. Without
``--device=cpu`` and without a card, training raises."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from rsrgan_tpu.cli import prepare as prepare_cli
from rsrgan_tpu.cli import train as jax_train
from rsrgan_tpu.data.synthetic import make_synthetic_corpus
from rsrgan_tpu_torch.cli import train as port_train
from rsrgan_tpu_torch.data import ScpReader

torch.set_num_threads(2)

IN_DIM, OUT_DIM = 16, 6
MODEL = ["--trainer=gan_rnn", "--g_type=res_lstm_l",
         f"--input_dim={IN_DIM}", f"--output_dim={OUT_DIM}"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tr/cv stores with labels, a test store and CMVN of a synthetic
    corpus (12 utterances of 30-60 frames)."""
    data_dir = str(tmp_path_factory.mktemp("corpus"))
    make_synthetic_corpus(data_dir, num_utts=12, input_dim=IN_DIM,
                          output_dim=OUT_DIM, min_len=30, max_len=60)
    assert prepare_cli.main(["cmvn", f"--inputs={data_dir}/inputs.cmvn",
                             f"--labels={data_dir}/labels.cmvn",
                             f"--save_dir={data_dir}"]) == 0
    assert prepare_cli.main(["split", "--val_size=4",
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


def train_flags(data_dir, save_dir, *extra):
    return MODEL + ["--batch_size=4", "--min_epoches=1", "--max_epoches=1",
                    f"--data_dir={data_dir}",
                    f"--tr_list_file={data_dir}/tr.list",
                    f"--cv_list_file={data_dir}/cv.list",
                    f"--save_dir={save_dir}", "--init_disc_noise_std=0.05",
                    *extra]


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    """One iteration of the port's training on the CPU, default flags
    (bf16 operands, the kernels' twins)."""
    save_dir = str(tmp_path_factory.mktemp("port_train"))
    assert port_train.main(train_flags(corpus, save_dir,
                                       "--device=cpu")) == 0
    return save_dir


def read_ark(save_dir):
    return dict(iter(ScpReader(os.path.join(save_dir, "test",
                                            "feats.scp"))))


def test_port_trains_and_writes_jax_checkpoint(trained):
    files = sorted(os.listdir(trained))
    assert "GAN_RNN-1.ckpt" in files and "GAN_RNN.meta.json" in files
    assert "checkpoint" in files and "metrics_train.jsonl" in files
    import json
    with open(os.path.join(trained, "metrics_train.jsonl")) as f:
        row = json.loads(f.readline())
    assert row["iteration"] == 1 and row["train_steps"] >= 1
    assert all(np.isfinite(row[k]) for k in port_train.GAN_METRICS)


def test_checkpoint_decodes_alike_in_both_packages(corpus, trained,
                                                   tmp_path):
    """f32 decode of the port-trained checkpoint: the JAX package (eager
    scan) and the port (kernel twins) write arks within 1e-4."""
    arks = {}
    for tag, main, extra in (("jax", jax_train.main, ["--lstm_impl=scan"]),
                             ("port", port_train.main, ["--device=cpu"])):
        save_dir = str(tmp_path / tag)
        shutil.copytree(trained, save_dir)
        assert main(["--decode", *MODEL, "--bf16=false",
                     "--decode_batch_size=2", f"--data_dir={corpus}",
                     f"--test_list_file={corpus}/test.list",
                     f"--save_dir={save_dir}", *extra]) == 0
        arks[tag] = read_ark(save_dir)
    assert list(arks["port"]) == list(arks["jax"]) and len(arks["jax"]) == 4
    for utt, mat in arks["jax"].items():
        np.testing.assert_allclose(arks["port"][utt], mat, atol=1e-4)


def test_jax_resumes_port_checkpoint(corpus, trained, tmp_path):
    """The JAX trainer loads the port's whole GanState (params, EMA,
    optimizer state, step) and trains on from it."""
    save_dir = str(tmp_path / "jax_resume")
    shutil.copytree(trained, save_dir)
    flags = train_flags(corpus, save_dir, "--lstm_impl=scan",
                        "--bf16=false", "--device_feed=off")
    flags = [f for f in flags if not f.startswith("--max_epoches")]
    assert jax_train.main(flags + ["--max_epoches=2", "--min_epoches=2",
                                   "--tensorboard=false"]) == 0
    assert os.path.isfile(os.path.join(save_dir, "GAN_RNN-2.ckpt"))


def test_training_without_card_raises(corpus, tmp_path, monkeypatch):
    """--device=cuda (the default) never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.main(train_flags(corpus, str(tmp_path / "x")))


TRACE_SUFFIX = ".pt.trace.json"


@pytest.mark.parametrize("loop", ["sequence", "frame"])
def test_profile_dir_traces_the_second_iteration(corpus, trained, tmp_path,
                                                 capsys, loop):
    """--profile_dir: two iterations (epochs of the frame loop) write one
    torch.profiler trace there, of the second, as the JAX CLI traces its
    second; a run without the flag writes none. The trace carries the
    program's spans: the step and the optimizer's update, and on the
    sequence loop's device feed its plans."""
    prof_dir = str(tmp_path / "prof")
    flags = train_flags(corpus, str(tmp_path / "run"), "--device=cpu",
                        "--tensorboard=false", f"--profile_dir={prof_dir}")
    want = {"train.step", "opt.update"}
    if loop == "sequence":
        flags += ["--device_feed=on"]
        want.add("feed.plan")
    flags = [f for f in flags if not f.startswith(("--max_epoches",
                                                    "--min_epoches"))]
    flags += ["--max_epoches=2", "--min_epoches=2"]
    if loop == "frame":
        flags = [f for f in flags if not f.startswith(("--trainer",
                                                        "--g_type",
                                                        "--batch_size"))]
        flags += ["--trainer=dnn", "--g_type=dnn", "--batch_size=32",
                  "--left_context=1", "--right_context=1"]
    assert port_train.main(flags) == 0
    out = capsys.readouterr().out
    traces = [n for n in os.listdir(prof_dir) if n.endswith(TRACE_SUFFIX)]
    assert len(traces) == 1
    with open(os.path.join(prof_dir, traces[0])) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert want <= names
    assert out.count("Wrote profiler trace to") == 1
    second = "2/2 (INFO)" if loop == "sequence" else "Epoch 2 (TRAIN"
    assert (out.index("1/2 (INFO)" if loop == "sequence" else "Epoch 1 (")
            < out.index(second) < out.index("Wrote profiler trace to"))
    assert not [n for _, _, names in os.walk(trained) for n in names
                if n.endswith(TRACE_SUFFIX)]


def events_of(save_dir, split):
    from rsrgan_tpu_torch.training.tensorboard import read_scalar_events
    d = os.path.join(save_dir, split)
    (name,) = os.listdir(d)
    return read_scalar_events(os.path.join(d, name))


def test_tensorboard_events_match_jsonl_metrics(trained):
    """The default --tensorboard: one events file each under train/ and
    eval/, a version record then one record per JSONL line, with its
    iteration as the step and its values as float32 scalars."""
    import json
    for split in ("train", "eval"):
        with open(os.path.join(trained, f"metrics_{split}.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        events = events_of(trained, split)
        assert events[0]["file_version"] == "brain.Event:2"
        assert len(events) == 1 + len(rows) == 2
        for e, row in zip(events[1:], rows):
            assert e["step"] == row.pop("iteration")
            assert list(e["scalars"]) == list(row)
            for k, v in row.items():
                assert e["scalars"][k] == np.float32(v), k


def test_tensorboard_off_writes_jsonl_only(corpus, tmp_path):
    save_dir = str(tmp_path / "no_tb")
    assert port_train.main(train_flags(corpus, save_dir, "--device=cpu",
                                       "--tensorboard=false")) == 0
    assert not os.path.exists(os.path.join(save_dir, "train"))
    assert os.path.isfile(os.path.join(save_dir, "metrics_eval.jsonl"))


def test_periodic_snapshots_and_resume(corpus, tmp_path, capsys):
    """--checkpoint_every_secs: a snapshot after the first update past the
    interval (here every update), readable by both packages'
    load_newest_state; a second run resumes from it where it is newer
    than the accepted checkpoint."""
    from rsrgan_tpu.training import checkpoints as jax_ckpt
    from rsrgan_tpu_torch.training import checkpoints as ckpt
    save_dir = str(tmp_path / "snap")
    flags = train_flags(corpus, save_dir, "--device=cpu",
                        "--checkpoint_every_secs=1e-9")
    assert port_train.main(flags) == 0
    out = capsys.readouterr().out
    assert "Periodic snapshot saved (GAN_RNN.periodic.ckpt)" in out
    snap = ckpt.periodic_snapshot_path(save_dir, "GAN_RNN")
    accepted = ckpt.latest_checkpoint(save_dir, "GAN_RNN")
    os.utime(snap, (os.path.getmtime(accepted) + 5,) * 2)
    tree = ckpt.read_checkpoint(snap)
    assert int(tree["step"]) >= 1 and "opt_state" in tree["g"]
    # the JAX trainer's state for these flags, restored from the snapshot
    import jax
    import jax.numpy as jnp
    args = jax_train.build_parser().parse_args(
        [f for f in flags if f != "--device=cpu"] + ["--lstm_impl=scan"])
    trainer = jax_train.build_trainer(args, jnp.float32)
    target = trainer.init_state(jax.random.PRNGKey(0),
                                jnp.zeros((1, 64, IN_DIM)),
                                jnp.asarray([64], jnp.int32))
    restored, src = jax_ckpt.load_newest_state(save_dir, "GAN_RNN", target)
    assert src == "periodic" and int(restored.step) == int(tree["step"])
    assert port_train.main(flags) == 0
    assert "[*] Load SUCCESS (periodic)" in capsys.readouterr().out


def test_keep_prob_reaches_g_and_d(corpus, tmp_path):
    """--keep_prob goes to G as well as D (as the JAX CLI passes it), G's
    and D's masks come from generators of their own, and the epoch
    trains to finite losses, unlike the same flags at keep_prob 1."""
    import json
    args = port_train.build_parser().parse_args(
        train_flags(corpus, "x", "--device=cpu", "--keep_prob=0.8"))
    trainer = port_train.build_trainer(args, torch.device("cpu"),
                                       torch.float32)
    assert trainer.generator.keep_prob == 0.8
    assert trainer.discriminator.StackedLstm_0.keep_prob == 0.8
    assert not trainer._share_g_forward()
    assert trainer.g_masks is not trainer.d_masks
    rows = {}
    for keep in ("0.8", "1.0"):
        save_dir = str(tmp_path / keep)
        assert port_train.main(train_flags(
            corpus, save_dir, "--device=cpu", f"--keep_prob={keep}",
            "--tensorboard=false")) == 0
        with open(os.path.join(save_dir, "metrics_train.jsonl")) as f:
            rows[keep] = json.loads(f.readline())
    assert all(np.isfinite(rows["0.8"][k]) for k in port_train.GAN_METRICS)
    assert rows["0.8"]["g_loss"] != rows["1.0"]["g_loss"]


def test_lstm_g_type_trains_and_decodes_alike(corpus, tmp_path):
    """--g_type=lstm: the port trains it (the wavefront stack at P=280,
    residual off, its twin here) and both packages decode the port's
    checkpoint to arks within 1e-4 (f32)."""
    save_dir = str(tmp_path / "lstm")
    assert port_train.main(train_flags(corpus, save_dir, "--device=cpu",
                                       "--g_type=lstm")) == 0
    arks = {}
    for tag, main, extra in (("jax", jax_train.main, ["--lstm_impl=scan"]),
                             ("port", port_train.main, ["--device=cpu"])):
        d = str(tmp_path / tag)
        shutil.copytree(save_dir, d)
        assert main(["--decode", *MODEL, "--g_type=lstm", "--bf16=false",
                     "--decode_batch_size=2", f"--data_dir={corpus}",
                     f"--test_list_file={corpus}/test.list",
                     f"--save_dir={d}", *extra]) == 0
        arks[tag] = read_ark(d)
    assert list(arks["port"]) == list(arks["jax"]) and len(arks["jax"]) == 4
    for utt, mat in arks["jax"].items():
        np.testing.assert_allclose(arks["port"][utt], mat, atol=1e-4)


def test_decode_compress_writes_the_jax_encoding(corpus, trained, tmp_path):
    """--decode --compress: every utterance of feats.ark is the JAX
    encoder's compressed bytes of what the same decode writes
    uncompressed (formats 1 and 2 by rows)."""
    import io

    from rsrgan_tpu.data import kaldi_ark as jax_ark
    from rsrgan_tpu_torch.data import read_scp
    arks = {}
    for tag, extra in (("plain", []), ("compressed", ["--compress"])):
        d = str(tmp_path / tag)
        shutil.copytree(trained, d)
        assert port_train.main(["--decode", *MODEL, "--device=cpu",
                                "--decode_batch_size=2",
                                f"--data_dir={corpus}",
                                f"--test_list_file={corpus}/test.list",
                                f"--save_dir={d}", *extra]) == 0
        arks[tag] = d
    plain = read_ark(arks["plain"])
    entries = read_scp(os.path.join(arks["compressed"], "test",
                                    "feats.scp"))
    blob = open(entries[0][1], "rb").read()
    for k, (utt, _, off) in enumerate(entries):
        buf = io.BytesIO()
        jax_ark.write_matrix(buf, plain[utt], compress=True)
        want = buf.getvalue()
        assert blob[off:off + len(want)] == want, utt
