"""The MSE and frame trainers through both CLIs on the CPU: the JAX CLI
and the port's (``--device=cpu``) train from the same initial checkpoint,
written by the JAX package into two save directories, on one micro
corpus, and must take the same decisions epoch by epoch.

* ``--trainer=dnn --g_type=dnn --batch_norm`` and ``--trainer=gan_dnn``
  (frame loop, three epochs). The DNN at a learning rate of 3e-4 is
  accepted after epoch 1 and rejected after epoch 2, whose CV loss rises:
  the whole state (params, Adam moments, EMA, batch statistics, step)
  rolls back to epoch 1's checkpoint, the staged decay (``--keep_lr=1``,
  ``--decay_factor=0.1``) cuts the rate, and epoch 3 is accepted. The
  frame GAN is accepted every epoch: on this corpus its D saturates at
  its clip (1.5) in the first epoch in both packages, so its CV loss
  follows the MSE down, and the rates that would turn it back up are
  chaotic (two correct runs part within an epoch). Equal: the
  Accepted/Rejected sequence, the learning rates the logs print, the
  metrics rows (1e-4), the final checkpoints (see the test).
* ``--trainer=rnn`` (res_lstm_l, ``--steps_per_call=2``, the sequence
  loop, never rolls back): the same, on the host feed.
* Decode across packages: the JAX CLI's DNNTrainer checkpoint decoded by
  the port, the port's by the JAX CLI, each against the other package's
  decode of the same checkpoint, to 1e-5.
* The CLI turns TF32 off itself; ``--trainer=gan_dnn --batch_norm``
  (which the JAX package cannot run) raises; ``--trainer=segan
  --num_gpu=2`` trains over two ranks.
"""

import json
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsrgan_tpu.cli import prepare as prepare_cli
from rsrgan_tpu.cli import train as jax_train
from rsrgan_tpu.data.synthetic import make_synthetic_corpus
from rsrgan_tpu.training import checkpoints as jax_ckpt
from rsrgan_tpu_torch.cli import train as port_train
from rsrgan_tpu_torch.data import ScpReader
from rsrgan_tpu_torch.models import flatten_tree
from rsrgan_tpu_torch.training import checkpoints as ckpt

torch.set_num_threads(2)

IN, OUT = 16, 6


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tr/cv stores with labels, a test store and the CMVN of a synthetic
    corpus (16 utterances of 30-60 frames: 12 train, 4 cv)."""
    data_dir = str(tmp_path_factory.mktemp("frame_corpus"))
    make_synthetic_corpus(data_dir, num_utts=16, input_dim=IN,
                          output_dim=OUT, min_len=30, max_len=60)
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


FRAME = ["--left_context=2", "--right_context=2", "--batch_size=32",
         "--d_learning_rate=0.001", "--min_epoches=2", "--max_epoches=3",
         "--keep_lr=1", "--decay_factor=0.1"]
RUNS = {
    "dnn": ["--trainer=dnn", "--g_type=dnn", "--batch_norm=true", *FRAME,
            "--g_learning_rate=0.0003"],
    "gan_dnn": ["--trainer=gan_dnn", "--g_type=dnn", *FRAME,
                "--g_learning_rate=0.001"],
    "rnn": ["--trainer=rnn", "--g_type=res_lstm_l", "--batch_size=2",
            "--steps_per_call=2", "--g_learning_rate=0.003",
            "--min_epoches=2", "--max_epoches=3", "--device_feed=off"],
}
NAMES = {"dnn": "DNNTrainer", "gan_dnn": "GAN", "rnn": "RNNTrainer"}


def flags(data_dir, save_dir, run, *extra):
    return [*RUNS[run], f"--input_dim={IN}", f"--output_dim={OUT}",
            "--bf16=false", "--seed=3", f"--data_dir={data_dir}",
            f"--tr_list_file={data_dir}/tr.list",
            f"--cv_list_file={data_dir}/cv.list",
            f"--save_dir={save_dir}", "--tensorboard=false", *extra]


HISTORY = 100


def with_adam_history(net, rng):
    """A NetState whose Adam moments are as after 100 earlier steps.

    From zero moments Adam's first steps move every parameter by about
    +-lr on the sign of its gradient, and a gradient that is zero but for
    rounding (a bias ahead of a BatchNorm, a unit that is all but dead)
    then moves on the sign of the rounding: two correct implementations
    part by lr there at every step. Moments far above rounding make the
    comparison well-conditioned without changing the update rule; at
    1e-6 they stay small beside the real gradients' (~1e-3), whose steps
    soon dominate, yet above rounding for the runs' few dozen steps."""
    clip, adam = net.opt_state
    adam = adam._replace(
        count=jnp.int32(HISTORY),
        mu=jax.tree.map(lambda a: jnp.asarray(
            rng.normal(size=a.shape) * 1e-6, jnp.float32), adam.mu),
        nu=jax.tree.map(lambda a: jnp.asarray(
            rng.uniform(1e-10, 1e-9, size=a.shape), jnp.float32), adam.nu))
    return net.replace(opt_state=(clip, adam))


def initial_checkpoint(data_dir, run, save_dirs):
    """The JAX trainer's initial state for ``run``'s flags, its Adam
    moments as after earlier steps (``with_adam_history``), saved as step
    0 (with its sidecar) into every save directory."""
    args = jax_train.build_parser().parse_args(flags(data_dir, "x", run))
    trainer = jax_train.build_trainer(args, jnp.float32)
    key = jax.random.PRNGKey(11)
    rng = np.random.default_rng(12)
    if run == "rnn":
        state = trainer.init_state(key, jnp.zeros((2, 64, IN)),
                                   jnp.asarray([64, 50], jnp.int32))
    else:
        state = trainer.init_state(key, jnp.zeros((4, 5 * IN)))
    if run == "gan_dnn":   # D's optimizer is Adam too
        state = state.replace(g=with_adam_history(state.g, rng),
                              d=with_adam_history(state.d, rng))
    else:
        state = state.replace(net=with_adam_history(state.net, rng))
    for d in save_dirs:
        jax_ckpt.save_checkpoint(d, NAMES[run], state, 0,
                                 meta=jax_train.ckpt_meta(args))


def decisions(out):
    return re.findall(r"(?:Epoch|Iteration) (\d+): Nnet (Accepted|Rejected)",
                      out)


def learning_rates(out):
    return re.findall(r"learning_rate= ?([0-9.e+-]+)", out)


def rows(save_dir, split):
    with open(os.path.join(save_dir, f"metrics_{split}.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    """Both CLIs' runs of each trainer from one initial checkpoint:
    {run: {tag: (save_dir, stdout)}}."""
    from _pytest.capture import MultiCapture, SysCapture
    out = {}
    for run in RUNS:
        base = tmp_path_factory.mktemp(run)
        dirs = {tag: str(base / tag) for tag in ("jax", "port")}
        initial_checkpoint(corpus, run, dirs.values())
        out[run] = {}
        for tag, main, extra in (
                ("jax", jax_train.main, ["--lstm_impl=scan"]),
                ("port", port_train.main, ["--device=cpu"])):
            cap = MultiCapture(in_=None, out=SysCapture(1), err=None)
            cap.start_capturing()
            try:
                rc = main(flags(corpus, dirs[tag], run, *extra))
            finally:
                text, _ = cap.readouterr()
                cap.stop_capturing()
            assert rc == 0, (run, tag, text[-2000:])
            out[run][tag] = (dirs[tag], text)
    return out


@pytest.mark.parametrize("run", list(RUNS))
def test_cli_runs_take_the_jax_decisions(trained, run):
    """The same Accepted/Rejected sequence (a rejected, rolled-back epoch
    among them for the frame trainers), the same learning rates, the
    metrics rows within 1e-4, the same checkpoint files, and the final
    checkpoints' params and batch statistics relative to the largest
    reference value: each tensor's RMS difference within 1e-4, each
    element within 1e-3. (Element-wise 1e-4 of the largest value
    fails by one element of the DNN's 3.2 M (1.07e-4): after ~30 Adam
    steps, rounding in a near-zero gradient moves one element by a
    fraction of the learning rate.)"""
    (jdir, jout), (pdir, pout) = trained[run]["jax"], trained[run]["port"]
    assert "[*] Load SUCCESS" in jout and "[*] Load SUCCESS" in pout
    want = decisions(jout)
    assert decisions(pout) == want and len(want) >= 3
    kinds = [k for _, k in want]
    if run != "rnn":
        assert learning_rates(pout) == learning_rates(jout)
        assert len(learning_rates(jout)) == len(want)
    if run == "dnn":   # a reject, rolled back, the staged decay, an accept
        assert "Rejected" in kinds and "Accepted" in kinds[
            kinds.index("Rejected"):], want
        assert "[*] Load previous model SUCCESS." in pout
        assert len(set(learning_rates(jout))) >= 2
    for split in ("train", "eval"):
        jr, pr = rows(jdir, split), rows(pdir, split)
        assert len(jr) == len(pr) == len(want)
        for a, b in zip(jr, pr):
            assert a["iteration"] == b["iteration"]
            keys = [k for k in a if k.endswith("loss") or k == "g_lr"]
            assert keys
            for k in keys:
                np.testing.assert_allclose(b[k], a[k], rtol=1e-4,
                                           atol=1e-6, err_msg=(split, k))
    files = sorted(f for f in os.listdir(jdir) if f.endswith(".ckpt"))
    assert sorted(f for f in os.listdir(pdir) if f.endswith(".ckpt")) \
        == files
    name = NAMES[run]
    got = ckpt.read_checkpoint(ckpt.latest_checkpoint(pdir, name))
    ref = ckpt.read_checkpoint(ckpt.latest_checkpoint(jdir, name))
    got, ref = flatten_tree(got), flatten_tree(ref)
    assert sorted(got) == sorted(ref)
    scale = max(float(np.abs(v).max()) for k, v in ref.items()
                if ".params." in f".{k}." and v is not None)
    for k, v in ref.items():
        if v is None:
            assert got[k] is None
        elif ".params." in f".{k}." or "batch_stats" in k:
            diff = np.asarray(got[k], np.float64) - v
            assert np.sqrt(np.mean(diff ** 2)) <= 1e-4 * scale, k
            assert np.abs(diff).max() <= 1e-3 * scale, k
    assert int(got["step"]) == int(ref["step"])


def test_rejected_epoch_rolls_back_the_whole_state(trained):
    """A reject reloads the last checkpoint in place, so every accepted
    checkpoint counts the steps of the accepted epochs alone (step and
    Adam's count; the frame GAN runs gen_updates = 2 G steps and one D
    step an iteration), in both packages; the DNN's epoch 3 checkpoint
    lacks epoch 2's steps."""
    for run in ("dnn", "gan_dnn"):
        pdir = trained[run]["port"][0]
        steps = [r["train_steps"] for r in rows(pdir, "train")]
        done = 0
        for (epoch, kind) in decisions(trained[run]["port"][1]):
            if kind == "Rejected":
                continue
            done += steps[int(epoch) - 1]
            for tag in ("jax", "port"):
                tree = ckpt.read_checkpoint(os.path.join(
                    trained[run][tag][0], f"{NAMES[run]}-{epoch}.ckpt"))
                counts = [int(tree[k]["opt_state"]["1"]["count"])
                          for k in ("net", "g", "d") if k in tree]
                # Adam's count starts at the initial checkpoint's 100
                want = ([HISTORY + done] if run == "dnn"
                        else [HISTORY + 2 * done, HISTORY + done])
                assert (int(tree["step"]), counts) == (done, want), \
                    (run, tag, epoch)
    assert [k for _, k in decisions(trained["dnn"]["port"][1])] == [
        "Accepted", "Rejected", "Accepted"]


def read_ark(save_dir):
    return dict(iter(ScpReader(os.path.join(save_dir, "test",
                                            "feats.scp"))))


def test_decode_across_packages(corpus, trained, tmp_path):
    """DNNTrainer (with BatchNorm): the JAX-written checkpoint decoded by
    the port and the port-written one by the JAX CLI, each against the
    other package's decode of the same checkpoint, to 1e-5; batch-1 over
    each utterance's frames, the running statistics from the
    checkpoint."""
    arks = {}
    for writer in ("jax", "port"):
        src = trained["dnn"][writer][0]
        for tag, main, extra in (("jax", jax_train.main, []),
                                 ("port", port_train.main,
                                  ["--device=cpu"])):
            d = str(tmp_path / f"{writer}_by_{tag}")
            shutil.copytree(src, d)
            assert main(["--decode", *RUNS["dnn"][:3], f"--input_dim={IN}",
                         f"--output_dim={OUT}", "--left_context=2",
                         "--right_context=2", f"--data_dir={corpus}",
                         f"--test_list_file={corpus}/test.list",
                         f"--save_dir={d}", *extra]) == 0
            arks[writer, tag] = read_ark(d)
    for writer in ("jax", "port"):
        want, got = arks[writer, "jax"], arks[writer, "port"]
        assert list(got) == list(want) and len(want) == 4
        for utt, mat in want.items():
            assert got[utt].shape == mat.shape and mat.shape[1] == OUT
            np.testing.assert_allclose(got[utt], mat, atol=1e-5)


def test_cli_turns_tf32_off(corpus, trained, tmp_path, monkeypatch):
    """The port's CLI sets its precision itself: TF32 off for matmuls and
    for cuDNN's convolutions, whatever the process had."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    d = str(tmp_path / "tf32")
    shutil.copytree(trained["dnn"]["port"][0], d)
    assert port_train.main(["--decode", *RUNS["dnn"][:3], "--device=cpu",
                            f"--input_dim={IN}", f"--output_dim={OUT}",
                            "--left_context=2", "--right_context=2",
                            f"--data_dir={corpus}",
                            f"--test_list_file={corpus}/test.list",
                            f"--save_dir={d}"]) == 0
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("extra,error,match", [
    (["--trainer=gan_dnn", "--batch_norm=true"], ValueError,
     "batch_stats"),
    pytest.param(["--trainer=segan", "--num_gpu=2"], None, "Parallel",
                 id="extra1-NotImplementedError-Parallel"),
])
def test_unrunnable_frame_flags_raise(corpus, tmp_path, extra, error,
                                      match):
    """--trainer=gan_dnn --batch_norm raises as the JAX package fails.
    --trainer=segan --num_gpu=2 raised NotImplementedError naming
    ROADMAP.md's item 'Parallel' (hence the name and the case's id) until
    that item was ported: the case now checks that it trains one epoch
    over two gloo ranks (a shallow G) and that rank 0 alone writes the
    metrics row."""
    save_dir = str(tmp_path / "x")
    argv = flags(corpus, save_dir, "dnn", "--device=cpu", *extra)
    if error is None:
        assert port_train.main(argv + ["--g_enc_depths=4,8",
                                       "--max_epoches=1"]) == 0
        assert len(rows(save_dir, "train")) == 1
        return
    with pytest.raises(error, match=match):
        port_train.main(argv)
