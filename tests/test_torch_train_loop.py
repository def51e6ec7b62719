"""The port's training loop against the JAX CLI's, on the CPU: which
batch each update takes, in which order, for the host-fed, gathered
(--device_feed=on), rotating and graph-fed (--same_batch=false) loops,
for the LSGAN (--trainer=gan_rnn) and the MSE trainer (--trainer=rnn,
host-fed, gathered and rotating); and the device feed's run bit-equal to
the host feed's.

Both CLIs train the flagship gan_rnn res_lstm_l for one or two epochs of
a micro corpus with two length buckets (eight utterances of 30-44 frames
and four of 55-79, every length distinct, so a batch's lengths name its
utterances). At --batch_size=2 --steps_per_call=2 the JAX CLI groups
same-shape batches and so updates in another order than the batcher
yields them; the port must update in the JAX order. Each package's step
functions are wrapped here, in the test only, to record the lengths of
every batch an update takes.
"""

import json
import os

import numpy as np
import pytest
import torch

from rsrgan_tpu.cli import train as jax_train
from rsrgan_tpu.data import device_feed as jax_feed
from rsrgan_tpu.data.store import UtteranceStore as JaxStore
from rsrgan_tpu.training import gan as jax_gan
from rsrgan_tpu.training import mse as jax_mse
from rsrgan_tpu_torch.cli import train as port_train
from rsrgan_tpu_torch.data import (SequenceBatcher, StoreWriter,
                                   UtteranceStore)
from rsrgan_tpu_torch.data import device_feed as port_feed
from rsrgan_tpu_torch.training import gan as port_gan
from rsrgan_tpu_torch.training import mse as port_mse

torch.set_num_threads(2)

IN, OUT = 16, 6
TR_LENGTHS = list(range(30, 46, 2)) + [55, 63, 71, 79]
CV_LENGTHS = [33, 41, 60, 70]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tr/cv list files of a seeded two-bucket corpus."""
    data_dir = str(tmp_path_factory.mktemp("loop_corpus"))
    rng = np.random.default_rng(0)
    lists = {}
    for name, lens in (("tr", TR_LENGTHS), ("cv", CV_LENGTHS)):
        path = os.path.join(data_dir, f"{name}.rtu")
        with StoreWriter(path) as w:
            for i, n in enumerate(lens):
                w.add(f"{name}{i:02d}",
                      rng.normal(size=(n, IN)).astype(np.float32),
                      rng.normal(size=(n, OUT)).astype(np.float32))
        lists[name] = os.path.join(data_dir, f"{name}.list")
        with open(lists[name], "w") as f:
            f.write(path + "\n")
    return lists


def flags(corpus, save_dir, *extra):
    return ["--trainer=gan_rnn", "--g_type=res_lstm_l",
            f"--input_dim={IN}", f"--output_dim={OUT}", "--batch_size=2",
            "--min_epoches=1", "--max_epoches=1", "--bf16=false",
            "--lstm_impl=scan", "--steps_per_call=2", "--seed=5",
            f"--tr_list_file={corpus['tr']}",
            f"--cv_list_file={corpus['cv']}", f"--save_dir={save_dir}",
            *extra]


def rows(lengths) -> list:
    """[B] or [S, B] lengths -> one tuple of lengths per step."""
    a = np.asarray(lengths.cpu() if isinstance(lengths, torch.Tensor)
                   else lengths)
    return [tuple(int(v) for v in r) for r in a.reshape(-1, a.shape[-1])]


def record_jax(monkeypatch, names, cls=jax_gan.GanTrainer):
    """Wrap the step functions ``names`` of the JAX trainer ``cls``; each
    call adds (name, lengths) per step it runs."""
    log = []
    for name in names:
        orig = getattr(cls, name)
        # lengths is the 4th positional argument of every step function
        # but the gathered ones, where it is the 5th (after the tables)
        pos = 4 if "gathered" in name else 3

        def wrapped(self, *args, _orig=orig, _name=name, _pos=pos):
            kind = _name.split("_")[0]  # train / d / g
            log.extend((kind, r) for r in rows(args[_pos]))
            return _orig(self, *args)

        monkeypatch.setattr(cls, name, wrapped)
    return log


def record_port(monkeypatch, names, cls=port_gan.GanTrainer):
    log = []
    for name in names:
        orig = getattr(cls, name)

        def wrapped(self, state, inputs, labels, lengths, *args,
                    _orig=orig, _name=name):
            log.extend((_name.split("_")[0], r) for r in rows(lengths))
            return _orig(self, state, inputs, labels, lengths, *args)

        monkeypatch.setattr(cls, name, wrapped)
    return log


def batcher_order(corpus, seed=5):
    """The plans in the order the batcher yields them (one epoch)."""
    store = UtteranceStore([open(corpus["tr"]).read().strip()])
    b = SequenceBatcher(store, 2, seed=seed)
    return [tuple(int(store.lengths[i]) for i in ix)
            for ix in b.iter_index_batches()]


def read_rows(save_dir, split):
    with open(os.path.join(save_dir, f"metrics_{split}.jsonl")) as f:
        return [json.loads(line) for line in f]


def loss_values(save_dir):
    return [{k: v for k, v in r.items() if k.endswith("loss")}
            for split in ("train", "eval") for r in read_rows(save_dir,
                                                              split)]


# ---------------------------------------------------------------------------
# dispatch_order, the pure function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keys,spc,want", [
    # full groups run when full, leftovers in key-insertion order
    ("abab", 2, [0, 2, 1, 3]),
    ("aabb", 2, [0, 1, 2, 3]),
    ("abaab", 2, [0, 2, 1, 4, 3]),
    # a popped key inserted again goes behind the keys still waiting
    ("aabcab", 2, [0, 1, 2, 5, 3, 4]),
    ("abcabc", 8, [0, 3, 1, 4, 2, 5]),
    ("abcabc", 1, [0, 1, 2, 3, 4, 5]),
    ("", 8, []),
])
def test_dispatch_order(keys, spc, want):
    got = port_train.dispatch_order(list(keys), spc)
    assert got == want
    assert sorted(got) == list(range(len(keys)))


# ---------------------------------------------------------------------------
# F5: the update order of the three loops against the JAX CLI's
# ---------------------------------------------------------------------------

def test_host_fed_update_order_matches_jax(corpus, tmp_path, monkeypatch):
    """--device_feed=off: every train step takes the JAX CLI's batch, in
    its order (grouped at --steps_per_call=2), not the batcher's."""
    jlog = record_jax(monkeypatch, ["train_step", "train_multi_step"])
    assert jax_train.main(flags(corpus, str(tmp_path / "jax"),
                                "--device_feed=off",
                                "--tensorboard=false")) == 0
    plog = record_port(monkeypatch, ["train_step"])
    assert port_train.main(flags(corpus, str(tmp_path / "port"),
                                 "--device_feed=off", "--device=cpu")) == 0
    assert len(jlog) == len(TR_LENGTHS) // 2
    assert [r for _, r in jlog] != batcher_order(corpus)  # F5 shows here
    assert plog == jlog


def test_gathered_update_order_matches_jax(corpus, tmp_path, monkeypatch):
    """--device_feed=on: the gathered steps take the JAX CLI's plans in
    its order."""
    jlog = record_jax(monkeypatch, ["train_multi_step_gathered"])
    assert jax_train.main(flags(corpus, str(tmp_path / "jax"),
                                "--device_feed=on",
                                "--tensorboard=false")) == 0
    plog = record_port(monkeypatch, ["train_step"])
    assert port_train.main(flags(corpus, str(tmp_path / "port"),
                                 "--device_feed=on", "--device=cpu")) == 0
    assert len(jlog) == len(TR_LENGTHS) // 2
    assert plog == jlog


def test_graph_fed_update_order_matches_jax(corpus, tmp_path, monkeypatch):
    """--same_batch=false: D and G steps on successive batches of the
    batcher's stream; the epoch stops where the JAX one stops (6 batches:
    D, G, G, D, G, G)."""
    names = ["d_step", "g_step"]
    jlog = record_jax(monkeypatch, names)
    assert jax_train.main(flags(corpus, str(tmp_path / "jax"),
                                "--same_batch=false",
                                "--tensorboard=false")) == 0
    plog = record_port(monkeypatch, names)
    save = str(tmp_path / "port")
    assert port_train.main(flags(corpus, save, "--same_batch=false",
                                 "--device=cpu")) == 0
    assert [k for k, _ in jlog] == ["d", "g", "g", "d", "g", "g"]
    assert [r for _, r in jlog] == batcher_order(corpus)
    assert plog == jlog
    row = read_rows(save, "train")[0]
    assert row["train_steps"] == 6
    assert all(np.isfinite(row[k]) for k in port_train.GAN_METRICS)


def test_rotating_feed_order_matches_jax(corpus, tmp_path, monkeypatch):
    """A budget below the tables rotates resident shards with prefetch:
    the same shards in the same residencies, and every step on the same
    plan, as the JAX CLI at the same shard capacity (each package's
    budget converted by its bytes per frame: the JAX tables are padded
    to 128 lanes)."""
    rotating_orders_match(corpus, tmp_path, monkeypatch, [],
                          jax_gan.GanTrainer, port_gan.GanTrainer)


def rotating_orders_match(corpus, tmp_path, monkeypatch, trainer_flags,
                          jax_cls, port_cls):
    cap, n_buf = 150, 2
    budgets = {}
    for tag, mod, store_cls in (
            ("jax", jax_feed, JaxStore),
            ("port", port_feed, UtteranceStore)):
        cv = store_cls([open(corpus["cv"]).read().strip()])
        bpf = (mod.table_bytes(cv, 4) // (sum(CV_LENGTHS) + 1))
        budgets[tag] = mod.table_bytes(cv, 4) + (cap + 1) * bpf * n_buf
    extra = ["--device_feed=on", "--device_feed_dtype=float32",
             "--feed_prefetch=true", "--max_epoches=2", *trainer_flags]
    visits = {}
    for tag, main, cls, more in (
            ("jax", jax_train.main, jax_feed.RotatingDeviceFeed,
             ["--tensorboard=false"]),
            ("port", port_train.main, port_feed.RotatingDeviceFeed,
             ["--device=cpu"])):
        seen = visits[tag] = []
        orig = cls.ensure_resident

        def ensure(self, k, _orig=orig, _seen=seen):
            _seen.append(k)
            return _orig(self, k)

        monkeypatch.setattr(cls, "ensure_resident", ensure)
        monkeypatch.setenv("RSRGAN_FEED_HBM_BUDGET", str(budgets[tag]))
        if tag == "jax":
            log = jlog = record_jax(monkeypatch,
                                    ["train_multi_step_gathered"], jax_cls)
        else:
            log = plog = record_port(monkeypatch, ["train_step"], port_cls)
        save = str(tmp_path / tag)
        assert main(flags(corpus, save, *extra, *more)) == 0
        assert log and "eff_epoch" in read_rows(save, "train")[0]
    assert len(set(visits["jax"])) >= 3
    assert visits["port"] == visits["jax"]
    assert plog == jlog


# ---------------------------------------------------------------------------
# --trainer=rnn: the MSE trainer in the same loops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("feed", ["off", "on"])
def test_rnn_update_order_matches_jax(corpus, tmp_path, monkeypatch, feed):
    """--trainer=rnn, host-fed (--device_feed=off) and gathered
    (--device_feed=on): every MseTrainer step takes the JAX CLI's batch
    or plan, in its order (grouped at --steps_per_call=2), and the
    learning rate each epoch's steps take is hp["g_lr"]."""
    names = (["train_step", "train_multi_step"] if feed == "off"
             else ["train_multi_step_gathered"])
    jlog = record_jax(monkeypatch, names, jax_mse.MseTrainer)
    rnn = ["--trainer=rnn", f"--device_feed={feed}", "--max_epoches=2",
           "--min_epoches=3"]
    assert jax_train.main(flags(corpus, str(tmp_path / "jax"), *rnn,
                                "--tensorboard=false")) == 0
    lrs = []
    orig = port_mse.MseTrainer.train_step

    def lr_of(self, state, inputs, labels, lengths, lr):
        lrs.append(lr)
        return orig(self, state, inputs, labels, lengths, lr)

    monkeypatch.setattr(port_mse.MseTrainer, "train_step", lr_of)
    plog = record_port(monkeypatch, ["train_step"], port_mse.MseTrainer)
    save = str(tmp_path / "port")
    assert port_train.main(flags(corpus, save, *rnn, "--device=cpu")) == 0
    steps = len(TR_LENGTHS) // 2
    assert len(jlog) == 2 * steps
    assert [r for _, r in jlog[:steps]] != batcher_order(corpus)
    assert plog == jlog
    want = [r["g_lr"] for r in read_rows(save, "train")]
    assert want[0] == 3e-4 and want[1] < want[0]
    assert lrs == [want[0]] * steps + [want[1]] * steps
    assert all(np.isfinite(r[k]) for r in read_rows(save, "train")
               for k in port_train.MSE_METRICS)


def test_rnn_rotating_feed_order_matches_jax(corpus, tmp_path,
                                            monkeypatch):
    """--trainer=rnn on the rotating feed: the same residencies and every
    step on the JAX CLI's plan."""
    rotating_orders_match(corpus, tmp_path, monkeypatch, ["--trainer=rnn"],
                          jax_mse.MseTrainer, port_mse.MseTrainer)


# ---------------------------------------------------------------------------
# the device feed's epoch is the host feed's, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--d_conditioned=true"],
                                   ["--trainer=rnn"]])
def test_device_feed_on_equals_off(corpus, tmp_path, extra):
    """Two epochs with the tables resident (f32) and with the host feed:
    equal metrics rows and equal checkpoint bytes."""
    saves = {}
    for mode in ("off", "on"):
        saves[mode] = str(tmp_path / mode)
        assert port_train.main(flags(
            corpus, saves[mode], f"--device_feed={mode}", "--device=cpu",
            "--max_epoches=2", "--init_disc_noise_std=0.1",
            *extra)) == 0
    assert loss_values(saves["on"]) == loss_values(saves["off"])
    assert len(loss_values(saves["on"])) == 4
    ckpts = sorted(f for f in os.listdir(saves["off"])
                   if f.endswith(".ckpt"))
    assert ckpts and ckpts == sorted(f for f in os.listdir(saves["on"])
                                     if f.endswith(".ckpt"))
    for name in ckpts:
        with open(os.path.join(saves["off"], name), "rb") as a, \
                open(os.path.join(saves["on"], name), "rb") as b:
            assert a.read() == b.read(), name
