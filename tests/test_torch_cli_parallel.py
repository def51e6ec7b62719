"""Data-parallel runs of the port's ``cli.train`` on the CPU (gloo ranks):

* ``--device=cpu --num_gpu=2`` against the JAX CLI's ``--num_gpu=2`` (a
  mesh over two of tests/conftest.py's eight virtual devices,
  ``--lstm_impl=scan``) for ``--trainer=rnn`` (the sequence loop) and
  ``--trainer=dnn --batch_norm`` (the frame loop), from one JAX-written
  initial checkpoint: the metrics rows (the learning rates x 2 among
  them) within 1e-4, the same checkpoint files, and the final
  checkpoints' params and batch statistics as tests/test_torch_cli_frame
  .py holds the one-device runs;
* two processes (``--coordinator_address``) against the port's own
  single-process run at the global batch and learning rates x 2
  (tests/test_multihost.py's counterpart), the flagship LSGAN with D's
  noise and dropout on: metrics and checkpoints equal to 1e-5, and only
  rank 0 writes;
* ``--num_gpu=2`` against the single-process run for the frame GAN and
  SEGAN (z and D noise on; bnlstm's global statistics are held against
  JAX by tests/test_torch_parallel.py);
* ``--decode --num_gpu=2 --decode_batch_size=3`` (a batch padded to an
  even row count) and a two-process decode against the single-process
  decode and the JAX CLI's ``--num_gpu=2`` decode;
* a global batch whose rows do not divide over the ranks raises, as on
  JAX's mesh; ``--num_gpu`` above the cards raises.

Every spawned world and subprocess has a time limit and is ended on the
way out.
"""

import json
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
from rsrgan_tpu.training import checkpoints as jax_ckpt
from rsrgan_tpu_torch.cli import train as port_train
from rsrgan_tpu_torch.data import ScpReader, StoreWriter, UtteranceStore
from rsrgan_tpu_torch.models import flatten_tree
from rsrgan_tpu_torch.parallel import free_port
from rsrgan_tpu_torch.training import checkpoints as ckpt

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IN, OUT = 16, 6
PROCESS_TIMEOUT = 300


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A synthetic corpus of 16 utterances of 50-99 frames (one length
    bucket, so that the global batches are full): 12 train, 4 cv, a test
    store of the cv inputs, CMVN; and a cv store of 3 utterances."""
    data_dir = str(tmp_path_factory.mktemp("dp_corpus"))
    make_synthetic_corpus(data_dir, num_utts=16, input_dim=IN,
                          output_dim=OUT, min_len=50, max_len=99)
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
    cv = UtteranceStore(os.path.join(stores, "cv.rtu"))
    w = StoreWriter(os.path.join(stores, "cv3.rtu"))
    for i in range(3):
        w.add(cv.utt_ids[i], np.asarray(cv.inputs(i)),
              np.asarray(cv.labels(i)))
    w.close()
    with open(os.path.join(data_dir, "cv3.list"), "w") as f:
        f.write(os.path.join(stores, "cv3.rtu") + "\n")
    return data_dir


def flags(data_dir, save_dir, *extra):
    return [f"--input_dim={IN}", f"--output_dim={OUT}", "--bf16=false",
            "--seed=3", f"--data_dir={data_dir}",
            f"--tr_list_file={data_dir}/tr.list",
            f"--cv_list_file={data_dir}/cv.list", f"--save_dir={save_dir}",
            *extra]


def rows(save_dir, split):
    with open(os.path.join(save_dir, f"metrics_{split}.jsonl")) as f:
        return [json.loads(line) for line in f]


def ckpt_files(save_dir):
    return sorted(f for f in os.listdir(save_dir) if f.endswith(".ckpt"))


def latest(save_dir, name):
    return flatten_tree(ckpt.read_checkpoint(
        ckpt.latest_checkpoint(save_dir, name)))


def assert_ckpt_close(got, ref):
    """Params and batch statistics relative to the largest reference
    param: each tensor's RMS difference within 1e-4, each element within
    1e-3 (tests/test_torch_cli_frame.py's gate for runs of many steps)."""
    assert sorted(got) == sorted(ref)
    scale = max(float(np.abs(v).max()) for k, v in ref.items()
                if ".params." in f".{k}." and v is not None)
    for k, v in ref.items():
        if v is None:
            assert got[k] is None, k
        elif ".params." in f".{k}." or "_stats" in k:
            diff = np.asarray(got[k], np.float64) - v
            assert np.sqrt(np.mean(diff ** 2)) <= 1e-4 * scale, k
            assert np.abs(diff).max() <= 1e-3 * scale, k
    assert int(got["step"]) == int(ref["step"])


def assert_rows_close(got_dir, want_dir, rtol, keys=None):
    for split in ("train", "eval"):
        got, want = rows(got_dir, split), rows(want_dir, split)
        assert len(got) == len(want) >= 1
        for a, b in zip(want, got):
            assert a["iteration"] == b["iteration"]
            ks = [k for k in a if k.endswith("loss")
                  or k in (keys or ())]
            assert ks
            for k in ks:
                np.testing.assert_allclose(b[k], a[k], rtol=rtol,
                                           atol=1e-6, err_msg=(split, k))


# ---------------------------------------------------------------------------
# --num_gpu=2 against the JAX CLI's
# ---------------------------------------------------------------------------

RUNS = {
    "rnn": ["--trainer=rnn", "--g_type=res_lstm_l", "--batch_size=2",
            "--steps_per_call=2", "--g_learning_rate=0.003",
            "--min_epoches=2", "--max_epoches=2", "--device_feed=off"],
    "dnn": ["--trainer=dnn", "--g_type=dnn", "--batch_norm=true",
            "--left_context=2", "--right_context=2", "--batch_size=64",
            "--g_learning_rate=0.00015", "--min_epoches=2",
            "--max_epoches=2", "--keep_lr=1", "--decay_factor=0.1"],
}
NAMES = {"rnn": "RNNTrainer", "dnn": "DNNTrainer"}


def with_adam_history(net, rng):
    """Adam's moments as after 100 earlier steps, far above rounding (as
    tests/test_torch_cli_frame.py sets them, for the same reason)."""
    clip, adam = net.opt_state
    adam = adam._replace(
        count=jnp.int32(100),
        mu=jax.tree.map(lambda a: jnp.asarray(
            rng.normal(size=a.shape) * 1e-6, jnp.float32), adam.mu),
        nu=jax.tree.map(lambda a: jnp.asarray(
            rng.uniform(1e-10, 1e-9, size=a.shape), jnp.float32), adam.nu))
    return net.replace(opt_state=(clip, adam))


def initial_checkpoint(data_dir, run_flags, name, save_dirs):
    """The JAX trainer's initial state for ``run_flags``, Adam's moments
    as after earlier steps, saved as step 0 into every save directory."""
    args = jax_train.build_parser().parse_args(
        flags(data_dir, "x", *run_flags))
    trainer = jax_train.build_trainer(args, jnp.float32)
    key = jax.random.PRNGKey(11)
    if args.trainer in ("rnn", "gan_rnn"):
        state = trainer.init_state(key, jnp.zeros((2, 64, IN)),
                                   jnp.asarray([64, 50], jnp.int32))
    else:
        state = trainer.init_state(key, jnp.zeros((4, 5 * IN)))
    rng = np.random.default_rng(12)
    if hasattr(state, "net"):
        state = state.replace(net=with_adam_history(state.net, rng))
    else:
        state = state.replace(g=with_adam_history(state.g, rng),
                              d=with_adam_history(state.d, rng))
    for d in save_dirs:
        jax_ckpt.save_checkpoint(d, name, state, 0,
                                 meta=jax_train.ckpt_meta(args))


@pytest.mark.parametrize("run", list(RUNS))
def test_num_gpu_matches_jax_cli(corpus, tmp_path, run):
    """Two ranks of the port against JAX's two-device mesh: metrics rows
    (the learning rate, doubled, among them) within 1e-4, the same
    checkpoint files, and the final params and batch statistics relative
    to the largest reference value: each tensor's RMS difference within
    1e-4, each element within 1e-3."""
    dirs = {tag: str(tmp_path / tag) for tag in ("jax", "port")}
    initial_checkpoint(corpus, RUNS[run], NAMES[run], dirs.values())
    assert jax_train.main(flags(corpus, dirs["jax"], *RUNS[run],
                                "--num_gpu=2", "--lstm_impl=scan",
                                "--tensorboard=false")) == 0
    assert port_train.main(flags(corpus, dirs["port"], *RUNS[run],
                                 "--num_gpu=2", "--device=cpu",
                                 "--tensorboard=false")) == 0
    assert_rows_close(dirs["port"], dirs["jax"], 1e-4,
                      keys=("g_lr",) if run == "rnn" else ())
    if run == "rnn":
        assert rows(dirs["port"], "train")[0]["g_lr"] == pytest.approx(
            2 * 0.003)
    assert ckpt_files(dirs["port"]) == ckpt_files(dirs["jax"])
    assert_ckpt_close(latest(dirs["port"], NAMES[run]),
                      latest(dirs["jax"], NAMES[run]))


# ---------------------------------------------------------------------------
# multi-process and --num_gpu runs against the port's single process
# ---------------------------------------------------------------------------

GAN = ["--trainer=gan_rnn", "--g_type=res_lstm_l", "--min_epoches=2",
       "--max_epoches=2", "--init_disc_noise_std=0.05", "--keep_prob=0.8"]


def lr_flags(mult, g=0.0003, d=0.001):
    return [f"--g_learning_rate={g * mult}", f"--d_learning_rate={d * mult}"]


def run_processes(argv_of, count):
    """``count`` CLI processes (``argv_of(i)``), each with a time limit,
    every one ended on the way out; their exit codes and output."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rsrgan_tpu_torch.cli.train", *argv_of(i)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(count)]
    try:
        outs = [p.communicate(timeout=PROCESS_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def coordinator(port, i, count=2):
    return [f"--coordinator_address=127.0.0.1:{port}",
            f"--num_processes={count}", f"--process_id={i}"]


@pytest.fixture(scope="module")
def gan_runs(corpus, tmp_path_factory):
    """The flagship LSGAN (noise 0.05, dropout 0.8, f32, two iterations)
    in one process at --batch_size=4 and the learning rates x 2, and in
    two processes at --batch_size=2."""
    base = tmp_path_factory.mktemp("gan_runs")
    dirs = {tag: str(base / tag) for tag in ("single", "multi")}
    assert port_train.main(flags(corpus, dirs["single"], *GAN,
                                 "--batch_size=4", *lr_flags(2),
                                 "--device=cpu")) == 0
    port = free_port()
    codes, outs = run_processes(lambda i: flags(
        corpus, dirs["multi"], *GAN, "--batch_size=2", *lr_flags(1),
        "--device=cpu", *coordinator(port, i)), 2)
    assert codes == [0, 0], outs[0][-3000:] + outs[1][-3000:]
    return dirs, outs


def test_two_processes_match_one_process(gan_runs):
    """Same metrics rows and checkpoints: the global batch's noise and
    masks on both ranks, its gradient, LR x 2."""
    dirs, outs = gan_runs
    assert "LOG: data-parallel world of 2 ranks over gloo" in outs[0]
    assert_rows_close(dirs["multi"], dirs["single"], 1e-5,
                      keys=("g_lr", "d_lr"))
    got, ref = latest(dirs["multi"], "GAN_RNN"), latest(dirs["single"],
                                                        "GAN_RNN")
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        if v is not None:
            np.testing.assert_allclose(
                np.asarray(got[k], np.float64), v,
                atol=1e-5 * max(1.0, float(np.abs(v).max())), err_msg=k)


def test_only_rank_0_writes(gan_runs):
    """The two-process run's directory holds what the one-process run's
    does: one metrics row per iteration, one events file per split, the
    checkpoints once; rank 1 prints nothing of the loop."""
    dirs, outs = gan_runs
    assert sorted(os.listdir(dirs["multi"])) == sorted(
        os.listdir(dirs["single"]))
    for split in ("train", "eval"):
        assert len(rows(dirs["multi"], split)) == 2
        assert len(os.listdir(os.path.join(dirs["multi"], split))) == 1
    assert "Iteration 2:" in outs[0] and "Iteration" not in outs[1]


NUM_GPU_RUNS = {
    "gan_dnn": (["--trainer=gan_dnn", "--g_type=dnn", "--left_context=2",
                 "--right_context=2", "--max_epoches=1"], 64, "GAN",
                # its D saturates at the clip within the epoch, and a
                # near-zero G gradient then steps +-lr on rounding
                (0.00001, 0.00001)),
    "segan": (["--trainer=segan", "--g_type=ae", "--g_enc_depths=4,8",
               "--left_context=1", "--right_context=1",
               "--init_disc_noise_std=0.3", "--disc_updates=1",
               "--gen_updates=1", "--max_epoches=1"], 16, "SEGAN",
              (0.0002, 0.0002)),
}


@pytest.mark.parametrize("run", list(NUM_GPU_RUNS))
def test_num_gpu_matches_one_process(corpus, tmp_path, run):
    """--num_gpu=2 at --batch_size=B against one process at 2B and the
    learning rates x 2 (the frame GAN's masks, SEGAN's VBN, z and D
    noise of the global batch): the metrics rows within
    1e-4 and the checkpoints as ``assert_ckpt_close`` holds them, the
    CLI tests' gates for runs of many steps."""
    extra, b, name, (g_lr, d_lr) = NUM_GPU_RUNS[run]
    single, dp = str(tmp_path / "single"), str(tmp_path / "dp")
    if run != "segan":   # RMSProp has no first-step sign to flip
        initial_checkpoint(corpus, extra, name, (single, dp))
    assert port_train.main(flags(corpus, single, *extra, f"--batch_size="
                                 f"{2 * b}", *lr_flags(2, g_lr, d_lr),
                                 "--device=cpu")) == 0
    assert port_train.main(flags(corpus, dp, *extra, f"--batch_size={b}",
                                 *lr_flags(1, g_lr, d_lr), "--num_gpu=2",
                                 "--device=cpu")) == 0
    assert_rows_close(dp, single, 1e-4)
    assert ckpt_files(dp) == ckpt_files(single)
    assert_ckpt_close(latest(dp, name), latest(single, name))


# ---------------------------------------------------------------------------
# decode over the world
# ---------------------------------------------------------------------------

DECODE = ["--decode", "--trainer=gan_rnn", "--g_type=res_lstm_l",
          f"--input_dim={IN}", f"--output_dim={OUT}", "--bf16=false",
          "--decode_batch_size=3"]


def decode(corpus, src, dst, main, *extra):
    shutil.copytree(src, dst)
    assert main([*DECODE, f"--data_dir={corpus}",
                 f"--test_list_file={corpus}/test.list", f"--save_dir={dst}",
                 *extra]) == 0
    return read_ark(dst)


def read_ark(save_dir):
    return dict(iter(ScpReader(os.path.join(save_dir, "test",
                                            "feats.scp"))))


def test_decode_over_two_ranks(corpus, gan_runs, tmp_path):
    """--num_gpu=2 (3 rows padded to 4, then 1 to 2) and two processes
    against the one-process decode (1e-5) and JAX's --num_gpu=2 decode
    over its mesh (1e-4, as the one-device decodes agree)."""
    src = gan_runs[0]["single"]
    want = decode(corpus, src, str(tmp_path / "single"), port_train.main,
                  "--device=cpu")
    arks = {"num_gpu": decode(corpus, src, str(tmp_path / "num_gpu"),
                              port_train.main, "--device=cpu",
                              "--num_gpu=2")}
    dst = str(tmp_path / "multi")
    shutil.copytree(src, dst)
    port = free_port()
    codes, outs = run_processes(lambda i: [
        *DECODE, f"--data_dir={corpus}",
        f"--test_list_file={corpus}/test.list", f"--save_dir={dst}",
        "--device=cpu", *coordinator(port, i)], 2)
    assert codes == [0, 0], outs[0][-3000:] + outs[1][-3000:]
    arks["multi"] = read_ark(dst)
    jax_ark = decode(corpus, src, str(tmp_path / "jax"), jax_train.main,
                     "--num_gpu=2", "--lstm_impl=scan")
    assert len(want) == 4
    for ark in arks.values():
        assert list(ark) == list(want)
        for utt, mat in want.items():
            np.testing.assert_allclose(ark[utt], mat, atol=1e-5)
    assert list(jax_ark) == list(want)
    for utt, mat in jax_ark.items():
        np.testing.assert_allclose(arks["num_gpu"][utt], mat, atol=1e-4)


# ---------------------------------------------------------------------------
# what raises
# ---------------------------------------------------------------------------

def test_indivisible_global_batch_raises_as_on_jax_mesh(corpus, tmp_path):
    """A cv store of 3 utterances makes one ragged global batch of 3 rows
    at --batch_size=2 --num_gpu=2: JAX's mesh refuses to place it, and
    the port's ranks raise (the run exits non-zero)."""
    extra = ["--trainer=rnn", "--g_type=res_lstm_l", "--batch_size=2",
             "--max_epoches=1", "--device_feed=off", "--num_gpu=2",
             f"--cv_list_file={corpus}/cv3.list"]
    with pytest.raises(ValueError):
        jax_train.main(flags(corpus, str(tmp_path / "jax"), *extra,
                             "--lstm_impl=scan"))
    assert port_train.main(flags(corpus, str(tmp_path / "port"), *extra,
                                 "--device=cpu")) != 0


def test_num_gpu_above_the_cards_raises(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 CUDA"):
        port_train.main(flags(corpus, str(tmp_path / "x"), *GAN,
                              "--num_gpu=2"))
