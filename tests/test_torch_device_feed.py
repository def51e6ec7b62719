"""The port's device feed against the JAX package's, on the CPU: the
on-device gather (``ops/gather.py``), the resident tables and plans
(``DeviceFeed``), shard rotation (``RotatingDeviceFeed``), the feed
decision of the CLI (``decide_device_feed``), and the gathered train and
eval steps.

The JAX tables are 128-lane padded and the port's are not, so tables are
compared as ``jax_table[:, :dim]``; everything the gather produces must be
bit-equal. The gathered steps are bit-equal to the host-fed steps of the
port on the same plans, and within the train-step state tolerance of
tests/test_torch_training.py (1e-5) of the JAX gathered step.
"""

import argparse

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rsrgan_tpu.data import device_feed as jfeed
from rsrgan_tpu.data.dataset import ThreadedPrefetcher as JaxPrefetcher
from rsrgan_tpu.data.store import StoreView as JaxStoreView
from rsrgan_tpu.data.store import UtteranceStore as JaxStore
from rsrgan_tpu.models.discriminators import LstmDiscriminator as JaxDisc
from rsrgan_tpu.models.recurrent import ResLstmGenerator as JaxGen
from rsrgan_tpu.ops import gather as jgather
from rsrgan_tpu.training import GanTrainer as JaxTrainer
from rsrgan_tpu_torch.cli import train as port_train
from rsrgan_tpu_torch.data import (SequenceBatcher, StoreView, StoreWriter,
                                   ThreadedPrefetcher, UtteranceStore)
from rsrgan_tpu_torch.data import device_feed as pfeed
from rsrgan_tpu_torch.models import flatten_tree
from rsrgan_tpu_torch.models.discriminators import LstmDiscriminator
from rsrgan_tpu_torch.models.recurrent import ResLstmGenerator
from rsrgan_tpu_torch.ops import gather as pgather
from rsrgan_tpu_torch.training import GanTrainer, checkpoints

torch.set_num_threads(1)

IN, OUT, GU, DU = 9, 4, 13, 10   # G: 4 x LSTM(13, proj 9); D: LSTM(10, 4)
LENS = [30, 45, 33, 60, 41, 30, 52, 38, 47, 55, 36, 44,
        29, 61, 40, 35, 58, 31, 49, 42, 37, 53, 34, 46]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("feed") / "corpus.rtu")
    rng = np.random.default_rng(7)
    with StoreWriter(p) as w:
        for i, n in enumerate(LENS):
            w.add(f"utt{i:02d}",
                  (rng.normal(size=(n, IN)) * 3).astype(np.float32),
                  rng.normal(size=(n, OUT)).astype(np.float32))
    return p


@pytest.fixture(scope="module")
def stores(path):
    return UtteranceStore(path), JaxStore(path)


def t_pad_of(lengths):
    return port_train.plan_key(np.asarray(lengths), 20)[0]


def jax_gather(feed, st, le, t_pad, left=0, right=0):
    x, y = jgather.assemble_sequence_batch(
        feed.inputs_tbl, feed.labels_tbl, jnp.asarray(st), jnp.asarray(le),
        t_pad, left, right, feed.in_dim, feed.out_dim)
    return np.asarray(x), np.asarray(y)


def port_gather(feed, st, le, t_pad, left=0, right=0):
    x, y = pgather.assemble_sequence_batch(
        feed.inputs_tbl, feed.labels_tbl, torch.from_numpy(st),
        torch.from_numpy(le), t_pad, left, right)
    return x.numpy(), y.numpy()


# ---------------------------------------------------------------------------
# the gather and the resident tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("left,right", [(0, 0), (2, 1)])
def test_gather_matches_jax_and_host_batcher(stores, left, right):
    """Every batch of an epoch: the port's gather, the JAX gather and the
    host batcher's batch are the same bits (a zero-length tail, edge-
    clamped splice, unspliced labels, float32)."""
    store, jstore = stores
    feed = pfeed.DeviceFeed(store, device=CPU)
    jf = jfeed.DeviceFeed(jstore)
    batcher = SequenceBatcher(store, 5, left, right, shuffle=False,
                              drop_remainder=False)
    plans = list(batcher.iter_index_batches())
    assert len(plans) >= 3
    for indices in plans:
        st, le = feed.plan(indices)
        t_pad = t_pad_of(le)
        x, y = port_gather(feed, st, le, t_pad, left, right)
        jx, jy = jax_gather(jf, *jf.plan(indices), t_pad, left, right)
        host = batcher._make_batch(indices)
        assert x.dtype == np.float32 and x.shape == host.inputs.shape
        one = pgather.gather_sequences(feed.inputs_tbl, torch.from_numpy(st),
                                       torch.from_numpy(le), t_pad, left,
                                       right)
        np.testing.assert_array_equal(one.numpy(), np.asarray(
            jgather.gather_sequences(jf.inputs_tbl, jnp.asarray(st),
                                     jnp.asarray(le), t_pad, left, right,
                                     dim=IN)))
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        np.testing.assert_array_equal(x, host.inputs)
        np.testing.assert_array_equal(y, host.labels)


@pytest.mark.parametrize("chunk_bytes", [1 << 26, 200])
def test_device_feed_tables_and_plans_match_jax(stores, chunk_bytes):
    """Plans equal; tables equal to the JAX tables' logical columns, the
    zero row included; 200-byte chunks (utterances straddling chunks)
    give the same table as one chunk."""
    store, jstore = stores
    feed = pfeed.DeviceFeed(store, device=CPU, chunk_bytes=chunk_bytes)
    jf = jfeed.DeviceFeed(jstore)
    np.testing.assert_array_equal(feed.starts, jf.starts)
    np.testing.assert_array_equal(feed.lengths, jf.lengths)
    assert feed.inputs_tbl.shape == (sum(LENS) + 1, IN)
    assert feed.labels_tbl.shape == (sum(LENS) + 1, OUT)
    np.testing.assert_array_equal(feed.inputs_tbl.numpy(),
                                  np.asarray(jf.inputs_tbl)[:, :IN])
    np.testing.assert_array_equal(feed.labels_tbl.numpy(),
                                  np.asarray(jf.labels_tbl)[:, :OUT])
    assert not feed.inputs_tbl[-1].any() and not feed.labels_tbl[-1].any()
    assert feed.num_bytes == pfeed.table_bytes(store, 4)
    for ix in ([0], [3, 1, 7], list(range(len(LENS)))):
        for got, want in zip(feed.plan(ix), jf.plan(ix)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk_bytes", [1 << 26, 200])
def test_bf16_tables_match_jax_f32_wire(stores, monkeypatch, chunk_bytes):
    """bfloat16 tables: the port casts f32 chunks on the device, the JAX
    package with RSRGAN_FEED_WIRE_DTYPE=float32 does too; both are the
    direct f32 -> bf16 rounding, bit for bit, and so are their gathers."""
    monkeypatch.setenv("RSRGAN_FEED_WIRE_DTYPE", "float32")
    store, jstore = stores
    feed = pfeed.DeviceFeed(store, torch.bfloat16, CPU, chunk_bytes)
    jf = jfeed.DeviceFeed(jstore, dtype=jnp.bfloat16)
    assert feed.inputs_tbl.dtype == torch.bfloat16
    assert feed.num_bytes == pfeed.table_bytes(store, 2)
    np.testing.assert_array_equal(
        feed.inputs_tbl.float().numpy(),
        np.asarray(jf.inputs_tbl[:, :IN]).astype(np.float32))
    np.testing.assert_array_equal(
        feed.labels_tbl.float().numpy(),
        np.asarray(jf.labels_tbl[:, :OUT]).astype(np.float32))
    ix = [2, 9, 13]
    st, le = feed.plan(ix)
    x, y = port_gather(feed, st, le, t_pad_of(le), 1, 1)
    jx, jy = jax_gather(jf, st, le, t_pad_of(le), 1, 1)
    assert x.dtype == np.float32
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)


# ---------------------------------------------------------------------------
# rotation
# ---------------------------------------------------------------------------

def budgets_for(cap_rows, n_buffers):
    """(port, JAX) budgets that give both packages ``cap_rows`` frames per
    shard buffer (each at its own bytes per frame: JAX pads to 128)."""
    port_bpf = (IN + OUT) * 4
    jax_bpf = (jfeed.pad_dim(IN) + jfeed.pad_dim(OUT)) * 4
    return ((cap_rows + 1) * port_bpf * n_buffers,
            (cap_rows + 1) * jax_bpf * n_buffers)


@pytest.mark.parametrize("prefetch", [False, True])
def test_rotating_feed_matches_jax(stores, prefetch):
    """Shards, max_rows, local plans and the residency schedule equal the
    JAX feed's at the same capacity; then two passes of the schedule,
    prefetching the next shard: every shard's gathered batches equal the
    JAX feed's and the host batches of that shard's StoreView."""
    store, jstore = stores
    n_buf = 2 if prefetch else 1
    budget, jbudget = budgets_for(200, n_buf)
    feed = pfeed.RotatingDeviceFeed(store, torch.float32, budget, CPU,
                                    chunk_bytes=300, seed=3,
                                    prefetch=prefetch)
    jf = jfeed.RotatingDeviceFeed(jstore, jnp.float32, jbudget, seed=3,
                                  prefetch=prefetch)
    assert feed.num_shards == jf.num_shards >= 3
    for a, b in zip(feed.shards, jf.shards):
        np.testing.assert_array_equal(a, b)
    assert feed.max_rows == jf.max_rows <= 200
    for (st, le), (jst, jle) in zip(feed._local, jf._local):
        np.testing.assert_array_equal(st, jst)
        np.testing.assert_array_equal(le, jle)
    visits = feed.schedule(2, 1, seed=5)
    assert visits == jf.schedule(2, 1, seed=5)
    assert feed.schedule(3, 2, seed=1) == jf.schedule(3, 2, seed=1)
    assert feed.num_bytes == n_buf * (feed.max_rows + 1) * (IN + OUT) * 4

    checked = set()
    for r, (k, _) in enumerate(visits):
        feed.ensure_resident(k)
        jf.ensure_resident(k)
        if prefetch and r + 1 < len(visits):
            feed.start_prefetch(visits[r + 1][0])
            jf.start_prefetch(visits[r + 1][0])
        batcher = SequenceBatcher(StoreView(store, feed.shards[k]), 2,
                                  shuffle=False, drop_remainder=False)
        for indices in batcher.iter_index_batches():
            st, le = feed.plan(indices)
            x, y = port_gather(feed, st, le, t_pad_of(le))
            jx, jy = jax_gather(jf, *jf.plan(indices), t_pad_of(le))
            host = batcher._make_batch(indices)
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(x, host.inputs)
            np.testing.assert_array_equal(y, host.labels)
            checked.add(k)
    assert checked == set(range(feed.num_shards))
    changes = 1 + sum(a[0] != b[0] for a, b in zip(visits, visits[1:]))
    assert feed.uploads == jf.uploads == changes


def test_store_view_matches_jax(stores):
    store, jstore = stores
    ix = [5, 0, 17, 3]
    view, jview = StoreView(store, ix), JaxStoreView(jstore, ix)
    assert len(view) == len(jview) == 4
    assert view.utt_ids == jview.utt_ids
    np.testing.assert_array_equal(view.lengths, jview.lengths)
    assert (view.input_dim, view.output_dim, view.has_labels) == \
        (jview.input_dim, jview.output_dim, jview.has_labels)
    for i in range(4):
        np.testing.assert_array_equal(view.inputs(i), jview.inputs(i))
        np.testing.assert_array_equal(view.labels(i), jview.labels(i))
        assert view[i][0] == jview[i][0]


@pytest.mark.parametrize("capacity", [1, 32])
def test_threaded_prefetcher_matches_jax(stores, capacity):
    """The same batches in the same order as the JAX prefetcher over the
    same batcher epoch, through a queue of 1 or 32."""
    store, jstore = stores
    from rsrgan_tpu.data.dataset import SequenceBatcher as JaxBatcher
    got = list(ThreadedPrefetcher(iter(SequenceBatcher(store, 3, seed=4)),
                                  capacity))
    want = list(JaxPrefetcher(iter(JaxBatcher(jstore, 3, seed=4)),
                              capacity))
    assert len(got) == len(want) >= 4
    for a, b in zip(got, want):
        assert a.utt_ids == b.utt_ids
        np.testing.assert_array_equal(a.inputs, b.inputs)
        np.testing.assert_array_equal(a.lengths, b.lengths)


def test_threaded_prefetcher_raises_the_producers_error():
    """Items before the failure arrive; then the producer's error, chained
    to a RuntimeError, where the stream would have gone on."""
    def produce():
        yield 1
        yield 2
        raise KeyError("bad utterance")

    it = iter(ThreadedPrefetcher(produce(), 4))
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(RuntimeError, match="producer failed") as err:
        next(it)
    assert isinstance(err.value.__cause__, KeyError)


def test_rotating_budget_below_longest_utterance_raises(stores):
    store, _ = stores
    budget, _ = budgets_for(max(LENS) - 1, 1)
    with pytest.raises(ValueError, match="longest utterance"):
        pfeed.RotatingDeviceFeed(store, torch.float32, budget, CPU)


def test_prefetch_error_reaches_ensure_resident(stores, monkeypatch):
    """An upload that fails on the prefetch thread fails the next
    ensure_resident instead of activating a half-filled buffer."""
    store, _ = stores
    budget, _ = budgets_for(200, 2)
    feed = pfeed.RotatingDeviceFeed(store, torch.float32, budget, CPU,
                                    prefetch=True)
    feed.ensure_resident(0)

    def broken(*args):
        raise OSError("disk gone")

    monkeypatch.setattr(pfeed, "_fill_table", broken)
    feed.start_prefetch(1)
    with pytest.raises(RuntimeError, match="prefetch failed"):
        feed.ensure_resident(1)


# ---------------------------------------------------------------------------
# decide_device_feed
# ---------------------------------------------------------------------------

def feed_args(*flags):
    return port_train.build_parser().parse_args(list(flags))


@pytest.mark.parametrize("flags,env,want", [
    (["--device_feed=auto"], None, None),   # auto on the CPU: host feed
    (["--device_feed=off"], None, None),
    (["--device_feed=on", "--same_batch=false"], None, None),  # graph-fed
    (["--device_feed=on"], None, (torch.float32, False)),
    # f32 tables over the budget, bf16 tables within it
    (["--device_feed=on"], "f32_over", (torch.bfloat16, False)),
    # bf16 tables over it too: rotate
    (["--device_feed=on"], "bf16_over", (torch.bfloat16, True)),
    (["--device_feed=on", "--device_feed_dtype=float32"], "f32_over",
     (torch.float32, True)),
])
def test_decide_device_feed(stores, monkeypatch, flags, env, want):
    store, _ = stores
    f32 = 2 * pfeed.table_bytes(store, 4)   # tr and cv: the same store
    budgets = {"f32_over": f32 - 1, "bf16_over": f32 // 2 - 1}
    if env:
        monkeypatch.setenv("RSRGAN_FEED_HBM_BUDGET", str(budgets[env]))
    else:
        monkeypatch.delenv("RSRGAN_FEED_HBM_BUDGET", raising=False)
    plan = port_train.decide_device_feed(feed_args(*flags), store, store,
                                         CPU)
    if want is None:
        assert plan is None
    else:
        assert (plan.dtype, plan.rotate) == want
        assert plan.budget == (budgets[env] if env else
                               port_train.default_feed_budget(CPU))


def test_default_budget_leaves_the_reserve():
    assert port_train.default_feed_budget(CPU) > 0
    assert port_train.FEED_RESERVE_BYTES > 0


# ---------------------------------------------------------------------------
# the gathered steps
# ---------------------------------------------------------------------------

HP = {"g_lr": 3e-3, "d_lr": 1e-2, "mse_lambda": 1.0,
      "disc_noise_std": 0.0, "d_real": 1.0, "d_fake": 0.0}


def port_trainer(seed=0):
    gen = torch.Generator().manual_seed(seed)
    g = ResLstmGenerator(IN, OUT, variant="l", cell_size=GU,
                         lstm_impl="wavefront", generator=gen)
    d = LstmDiscriminator(input_dim=OUT, cell_size=DU, num_projection=OUT,
                          lstm_impl="wavefront", generator=gen)
    return GanTrainer(g, d, output_dim=OUT, input_dim=IN, l2_scale=1e-3)


def state_tensors(state):
    return {k: np.asarray(v) for k, v in
            flatten_tree(checkpoints.state_tree(state)).items()}


def test_gathered_steps_equal_host_fed_steps(stores):
    """Three train steps and an eval step on plans, through the tables,
    against the same steps on the host batcher's batches: the same
    metrics and the same state, bit for bit (f32 tables gather the host
    batches exactly)."""
    store, _ = stores
    feed = pfeed.DeviceFeed(store, device=CPU)
    batcher = SequenceBatcher(store, 4, shuffle=True, seed=2)
    plans = list(batcher.iter_index_batches())[:3]
    runs = {}
    for mode in ("host", "gathered"):
        tr = port_trainer()
        st = tr.init_state()
        metrics = []
        for indices in plans:
            s, le = feed.plan(indices)
            if mode == "host":
                b = batcher._make_batch(indices)
                metrics.append(tr.train_step(
                    st, torch.from_numpy(b.inputs),
                    torch.from_numpy(b.labels), torch.from_numpy(b.lengths),
                    HP))
            else:
                metrics.append(tr.train_step_gathered(
                    st, feed.inputs_tbl, feed.labels_tbl,
                    torch.from_numpy(s), torch.from_numpy(le), HP, None,
                    t_pad_of(le), 0, 0))
        s, le = feed.plan(plans[0])
        if mode == "host":
            b = batcher._make_batch(plans[0])
            ev = tr.eval_step(st, torch.from_numpy(b.inputs),
                              torch.from_numpy(b.labels),
                              torch.from_numpy(b.lengths), HP)
        else:
            ev = tr.eval_step_gathered(st, feed.inputs_tbl, feed.labels_tbl,
                                       torch.from_numpy(s),
                                       torch.from_numpy(le), HP, None,
                                       t_pad_of(le), 0, 0)
        runs[mode] = ([{k: float(v) for k, v in m.items()}
                       for m in metrics + [ev]], state_tensors(st))
    assert runs["gathered"][0] == runs["host"][0]
    for k, v in runs["host"][1].items():
        np.testing.assert_array_equal(runs["gathered"][1][k], v, err_msg=k)


def test_train_step_gathered_matches_jax(stores):
    """One gathered train step from a bridged state against JAX's
    train_multi_step_gathered with S=1 (Pallas in interpreter mode): the
    whole state within 1e-5, as test_train_step_matches_jax holds the
    host-fed step."""
    store, jstore = stores
    jf = jfeed.DeviceFeed(jstore)
    feed = pfeed.DeviceFeed(store, device=CPU)
    indices = [3, 8, 14, 20]
    st, le = feed.plan(indices)
    t_pad = t_pad_of(le)
    tr = JaxTrainer(JaxGen(output_dim=OUT, cell_size=GU,
                           lstm_impl="wavefront"),
                    JaxDisc(cell_size=DU, num_projection=OUT,
                            lstm_impl="wavefront"),
                    output_dim=OUT, input_dim=IN, l2_scale=1e-3)
    jhp = {k: jnp.float32(v) for k, v in HP.items()}
    x0, _ = jax_gather(jf, st, le, t_pad)
    with pltpu.force_tpu_interpret_mode():
        s0 = tr.init_state(jax.random.PRNGKey(1), jnp.asarray(x0),
                           jnp.asarray(le))
        s0 = s0.replace(g=s0.g.replace(params=jax.tree.map(
            lambda a: a + 0.05, s0.g.params)))
        port_state_tree = flax.serialization.to_state_dict(
            jax.tree.map(np.asarray, s0))
        s1, m = tr.train_multi_step_gathered(
            s0, jf.inputs_tbl, jf.labels_tbl, jnp.asarray(st)[None],
            jnp.asarray(le)[None], jhp, jax.random.PRNGKey(2), t_pad, 0, 0,
            jf.in_dim, jf.out_dim)
    ptr = port_trainer()
    pst = ptr.init_state()
    checkpoints.load_state_tree(pst, port_state_tree)
    pm = ptr.train_step_gathered(pst, feed.inputs_tbl, feed.labels_tbl,
                                 torch.from_numpy(st), torch.from_numpy(le),
                                 HP, None, t_pad, 0, 0)
    for k in m:
        np.testing.assert_allclose(float(pm[k]), float(m[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    want = flatten_tree(flax.serialization.to_state_dict(
        jax.tree.map(np.asarray, s1)))
    got = flatten_tree(checkpoints.state_tree(pst))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   atol=1e-5, err_msg=k)


def test_multi_step_scans_name_their_reason():
    tr = port_trainer()
    for name in ("train_multi_step", "train_multi_step_gathered",
                 "eval_multi_step_gathered"):
        with pytest.raises(NotImplementedError, match="jit dispatch"):
            getattr(tr, name)()


def test_feed_args_parse():
    args = feed_args("--device_feed=on", "--feed_prefetch",
                     "--feed_rotation_block=2", "--same_batch=false",
                     "--d_conditioned=true")
    assert isinstance(args, argparse.Namespace)
    assert (args.device_feed, args.feed_prefetch, args.feed_rotation_block,
            args.same_batch, args.d_conditioned) == ("on", True, 2, False,
                                                     True)
