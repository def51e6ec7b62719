"""The port's serve CLI (rsrgan_tpu_torch/cli/serve.py) on the CPU, from
checkpoints written by the JAX package: feature mode against the JAX
package's StreamingEnhancer over the same chunks and against the port's
own --decode, chunk sizes bit-equal, --moving_average, wav mode single
against pooled, and the refusals. The JAX serve CLI itself cannot run
(ROADMAP.md, F1), so its library classes are the reference."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsrgan_tpu.cli import train as jax_train
from rsrgan_tpu.serving import StreamingEnhancer as JaxEnhancer
from rsrgan_tpu.training import save_checkpoint as jax_save_checkpoint
from rsrgan_tpu_torch.cli import serve as serve_cli
from rsrgan_tpu_torch.cli import train as port_train
from rsrgan_tpu_torch.data import (ScpReader, UtteranceStore,
                                   load_cmvn_npz, read_list_file)
from rsrgan_tpu_torch.data.synthetic import make_synthetic_corpus
from rsrgan_tpu_torch.sim.wavio import read_wav, write_wav
from test_torch_wav_stream import noisy_speech

torch.set_num_threads(2)

IN_DIM, OUT_DIM, BINS = 16, 6, 257
CHUNK = 13


def jax_checkpoint(save_dir, input_dim, output_dim, g_type="res_lstm_l",
                   ema_scale=None):
    """A fresh flagship GanState written by the JAX package (the train
    CLI's trainer for these flags) with its .meta.json; ``ema_scale``
    sets G's EMA shadow to that multiple of its params. Returns G's
    params and EMA as numpy trees."""
    args = jax_train.build_parser().parse_args(
        ["--trainer=gan_rnn", f"--g_type={g_type}", "--lstm_impl=scan",
         f"--input_dim={input_dim}", f"--output_dim={output_dim}"])
    trainer = jax_train.build_trainer(args, jnp.float32)
    state = trainer.init_state(jax.random.PRNGKey(3),
                               jnp.zeros((1, 8, input_dim)),
                               jnp.full((1,), 8, jnp.int32))
    if ema_scale is not None:
        state = state.replace(g=state.g.replace(ema=jax.tree.map(
            lambda p: p * ema_scale, state.g.params)))
    jax_save_checkpoint(save_dir, "GAN_RNN", state, step=1,
                        meta={"trainer": "gan_rnn", "g_type": g_type,
                              "input_dim": input_dim,
                              "output_dim": output_dim,
                              "left_context": 0, "right_context": 0})
    return [jax.tree.map(np.asarray, dict(t))
            for t in (state.g.params, state.g.ema)]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A synthetic corpus's test store (8 utterances of 20-45 frames) and
    train_cmvn.npz, and a JAX-written checkpoint whose EMA differs."""
    from rsrgan_tpu_torch.cli import prepare as prepare_cli
    data_dir = str(tmp_path_factory.mktemp("corpus"))
    make_synthetic_corpus(data_dir, num_utts=8, input_dim=IN_DIM,
                          output_dim=OUT_DIM, min_len=20, max_len=45)
    assert prepare_cli.main(["cmvn", f"--inputs={data_dir}/inputs.cmvn",
                             f"--labels={data_dir}/labels.cmvn",
                             f"--save_dir={data_dir}"]) == 0
    stores = os.path.join(data_dir, "stores")
    assert prepare_cli.main([
        "make-store", f"--inputs={data_dir}/inputs.scp",
        f"--cmvn_dir={data_dir}", f"--output_dir={stores}", "--name=test",
        "--test"]) == 0
    with open(os.path.join(data_dir, "test.list"), "w") as f:
        f.write(os.path.join(stores, "test.rtu") + "\n")
    save_dir = str(tmp_path_factory.mktemp("ckpt"))
    params, ema = jax_checkpoint(save_dir, IN_DIM, OUT_DIM, ema_scale=0.5)
    return {"data_dir": data_dir, "save_dir": save_dir, "params": params,
            "ema": ema, "test_list": os.path.join(data_dir, "test.list")}


def serve(c, out_dir, *extra):
    return serve_cli.main([
        f"--save_dir={c['save_dir']}", f"--data_dir={c['data_dir']}",
        f"--test_list_file={c['test_list']}", f"--input_dim={IN_DIM}",
        f"--output_dim={OUT_DIM}", f"--output_dir={out_dir}",
        "--device=cpu", *extra])


def read_ark(path):
    return dict(iter(ScpReader(os.path.join(path, "feats.scp"))))


def jax_stream(c, params, chunk):
    """JAX's StreamingEnhancer over the CLI's zero-padded chunks, then
    the labels CMVN undone."""
    _, labels_cmvn = load_cmvn_npz(os.path.join(c["data_dir"],
                                                "train_cmvn.npz"))
    store = UtteranceStore(read_list_file(c["test_list"]))
    enh = JaxEnhancer(params)
    out = {}
    for i, utt in enumerate(store.utt_ids):
        x = np.asarray(store.inputs(i), np.float32)
        state, ys = enh.init_state(1), []
        for lo in range(0, len(x), chunk):
            piece = np.zeros((1, chunk, x.shape[1]), np.float32)
            piece[0, :len(x[lo:lo + chunk])] = x[lo:lo + chunk]
            y, state = enh.step(jnp.asarray(piece), state)
            ys.append(np.asarray(y[0, :len(x[lo:lo + chunk])]))
        out[utt] = labels_cmvn.denormalize(np.concatenate(ys))
    return out


def test_feature_mode_matches_jax_streaming(corpus, tmp_path, capsys):
    assert serve(corpus, tmp_path / "a", f"--chunk_frames={CHUNK}") == 0
    log = capsys.readouterr().out
    assert "[*] Load SUCCESS" in log and "Streaming done:" in log
    got = read_ark(tmp_path / "a")
    want = jax_stream(corpus, corpus["params"], CHUNK)
    assert list(got) == list(want)
    for u in want:
        assert got[u].shape == want[u].shape
        np.testing.assert_allclose(got[u], want[u], rtol=0, atol=1e-5)


def test_feature_mode_matches_port_decode(corpus, tmp_path):
    """Against the port's offline --decode (the eager cell, f32), and the
    chunk sizes among themselves: bit-equal."""
    save_dir = str(tmp_path / "dec")
    import shutil
    shutil.copytree(corpus["save_dir"], save_dir)
    assert port_train.main([
        "--decode", "--trainer=gan_rnn", "--g_type=res_lstm_l",
        f"--data_dir={corpus['data_dir']}",
        f"--test_list_file={corpus['test_list']}", f"--save_dir={save_dir}",
        f"--input_dim={IN_DIM}", f"--output_dim={OUT_DIM}", "--bf16=false",
        "--lstm_impl=scan", "--device=cpu"]) == 0
    offline = dict(iter(ScpReader(os.path.join(save_dir, "test",
                                               "feats.scp"))))
    arks = {}
    for chunk in (CHUNK, 7, 64):   # 64 frames: longer than every utterance
        assert serve(corpus, tmp_path / str(chunk),
                     f"--chunk_frames={chunk}") == 0
        arks[chunk] = read_ark(tmp_path / str(chunk))
    assert list(arks[CHUNK]) == list(offline)
    for u in offline:
        np.testing.assert_allclose(arks[CHUNK][u], offline[u], rtol=0,
                                   atol=1e-5)
        assert np.array_equal(arks[7][u], arks[CHUNK][u])
        assert np.array_equal(arks[64][u], arks[CHUNK][u])


def test_moving_average_serves_the_ema(corpus, tmp_path):
    assert serve(corpus, tmp_path / "ema", f"--chunk_frames={CHUNK}",
                 "--moving_average") == 0
    got = read_ark(tmp_path / "ema")
    want = jax_stream(corpus, corpus["ema"], CHUNK)
    for u in want:
        np.testing.assert_allclose(got[u], want[u], rtol=0, atol=1e-5)
    plain = jax_stream(corpus, corpus["params"], CHUNK)
    assert not np.allclose(got[list(want)[0]], plain[list(want)[0]])


def test_wav_mode_single_against_pooled(tmp_path, capsys):
    """--wav_scp: single stream against --num_streams=3, the same wavs
    (int16 PCM) up to one quantization step; output lengths; wav.scp."""
    save_dir = str(tmp_path / "exp")
    jax_checkpoint(save_dir, BINS, BINS)
    data_dir = str(tmp_path / "data")
    os.makedirs(data_dir)
    rng = np.random.default_rng(7)
    np.savez(os.path.join(data_dir, "train_cmvn.npz"),
             mean_inputs=rng.normal(size=BINS) * 0.1 + 10.0,
             stddev_inputs=4.0 + 0.05 * rng.random(BINS),
             mean_labels=rng.normal(size=BINS) * 0.1,
             stddev_labels=1.0 + 0.05 * rng.random(BINS))
    lengths = (7000, 4200, 9800, 6100)
    with open(tmp_path / "noisy.scp", "w") as f:
        for i, n in enumerate(lengths):
            write_wav(str(tmp_path / f"u{i}.wav"), noisy_speech(n, 20 + i))
            f.write(f"u{i} {tmp_path / f'u{i}.wav'}\n")
    common = [f"--save_dir={save_dir}", f"--data_dir={data_dir}",
              f"--wav_scp={tmp_path / 'noisy.scp'}", "--input_dim=257",
              "--output_dim=257", "--chunk_frames=16", "--device=cpu"]
    assert serve_cli.main(common + [f"--output_dir={tmp_path}/single"]) == 0
    assert "x realtime host-synced, single stream" in capsys.readouterr().out
    assert serve_cli.main(common + [f"--output_dir={tmp_path}/pooled",
                                    "--num_streams=3"]) == 0
    log = capsys.readouterr().out
    assert "batched dispatches" in log and "3 pooled streams" in log
    W, S = 400, 160
    for i, n in enumerate(lengths):
        a, rate = read_wav(str(tmp_path / "single" / f"u{i}.wav"))
        b, _ = read_wav(str(tmp_path / "pooled" / f"u{i}.wav"))
        assert rate == 16000
        assert len(a) == len(b) == (((n - W) // S) * S + W)
        # the CMVN keeps the waves inside the int16 range (no clipping)
        assert np.abs(a - b).max() <= 1.0 and 10 < np.abs(a).max() < 32767
    with open(tmp_path / "pooled" / "wav.scp") as f:
        assert sorted(line.split()[0] for line in f) == [
            f"u{i}" for i in range(4)]


def test_refusals(corpus, tmp_path):
    """A g_type the sidecar contradicts and an unsupported one raise
    SystemExit; a missing checkpoint returns 1; both or neither input
    mode is a usage error; --device=cuda without a card raises before
    any work."""
    save_dir = str(tmp_path / "base")
    import shutil
    shutil.copytree(corpus["save_dir"], save_dir)
    with open(os.path.join(save_dir, "GAN_RNN.meta.json"), "w") as f:
        json.dump({"g_type": "res_lstm_base"}, f)
    flags = [f"--data_dir={corpus['data_dir']}",
             f"--test_list_file={corpus['test_list']}",
             f"--input_dim={IN_DIM}", f"--output_dim={OUT_DIM}",
             "--device=cpu"]
    with pytest.raises(SystemExit, match="res_lstm_base"):
        serve_cli.main([f"--save_dir={save_dir}", *flags])
    for g_type in ("bnlstm", "dnn"):
        with pytest.raises(SystemExit, match="serve supports"):
            serve_cli.main([f"--save_dir={save_dir}",
                            f"--g_type={g_type}", *flags])
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    assert serve_cli.main([f"--save_dir={empty}", *flags]) == 1
    with pytest.raises(SystemExit):
        serve_cli.main([f"--save_dir={save_dir}", "--wav_scp=x.scp",
                        *flags])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_cli.main([f"--save_dir={corpus['save_dir']}",
                            *flags[:-1]])
        assert not os.path.isdir(os.path.join(corpus["save_dir"], "stream"))


def test_wrong_tree_fails_to_load(corpus, tmp_path):
    """A checkpoint of another G width does not load into the generator
    the flags describe: an error, not garbage."""
    save_dir = str(tmp_path / "other")
    jax_checkpoint(save_dir, IN_DIM + 1, OUT_DIM)
    with pytest.raises((KeyError, ValueError)):
        serve(dict(corpus, save_dir=save_dir), tmp_path / "x")


def test_serves_a_generator_only_checkpoint(corpus, tmp_path):
    """G's tree alone, as ``cli.train --decode`` reads it, serves the
    same ark as the whole JAX-written train state it came from."""
    from rsrgan_tpu_torch.training import save_checkpoint
    save_dir = str(tmp_path / "g_only")
    save_checkpoint(save_dir, "GAN_RNN",
                    {"g": {"params": corpus["params"], "ema": corpus["ema"]},
                     "step": np.zeros((), np.int32)}, 1,
                    meta={"trainer": "gan_rnn", "g_type": "res_lstm_l"})
    assert serve(dict(corpus, save_dir=save_dir), tmp_path / "g",
                 f"--chunk_frames={CHUNK}") == 0
    assert serve(corpus, tmp_path / "whole", f"--chunk_frames={CHUNK}") == 0
    got, want = read_ark(tmp_path / "g"), read_ark(tmp_path / "whole")
    assert list(got) == list(want)
    for u in want:
        assert np.array_equal(got[u], want[u])
