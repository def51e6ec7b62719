"""The port's data parallelism (``rsrgan_tpu_torch/parallel``) against the
JAX package, on the CPU in spawned gloo worlds.

* The host-sharded views: the port's blocks are the JAX views' for every
  process, and in process order they are the global batch
  (tests/test_data_io.py's counterpart); their errors alike.
* The collectives against their one-process meaning: the world's mean of
  a dict, the global moments and their gradients, gathered rows,
  replicated tensors, the global batch's draws; a world of one is the
  identity; a failing or stuck rank ends the launch.
* One data-parallel step at 2 and 4 ranks, each rank on its rows, from
  one bridged state, against the JAX trainer's single-device step on the
  full batch (tests/test_parallel.py's equivalence, held against JAX):
  the flagship GAN, the MSE trainer, the DNN with BatchNorm, bnlstm and
  SEGAN (VBN; JAX's z and noise handed in, each rank its rows). Gated:
  the metrics at tests/test_parallel.py's 1e-4 x (1 + |ref|), every
  tensor of the state after the step at the port's own single-process
  step tolerance against JAX (1e-5 at unit scale; bnlstm and SEGAN
  2e-4), the first update's gradients at 2e-4, and every rank holding
  the same state, bit for bit (batch statistics included).
* The GAN step with D's noise and dropout on, against the port's own
  one-process step at the global batch: the draws are the global
  batch's on every rank.

f32; the JAX side on its scan cell (its Pallas kernels agree with it to
1e-5 and run for minutes in interpreter mode), the ranks on the port's
kernel twins.
"""

import functools
import os
import pickle
from unittest import mock

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from rsrgan_tpu.data import (FrameBatcher as JaxFrameBatcher,
                             HostShardedFrameBatches as JaxFrameView,
                             HostShardedSequenceBatches as JaxSeqView,
                             SequenceBatcher as JaxSeqBatcher,
                             StoreWriter as JaxStoreWriter,
                             UtteranceStore as JaxStore)
from rsrgan_tpu.models.discriminators import LstmDiscriminator as JaxDisc
from rsrgan_tpu.models.feedforward import DnnGenerator as JaxDnn
from rsrgan_tpu.models.recurrent import BnLstmGenerator as JaxBnGen
from rsrgan_tpu.models.recurrent import ResLstmGenerator as JaxResGen
from rsrgan_tpu.models.segan import SeganAEGenerator as JaxAE
from rsrgan_tpu.models.segan import SeganDiscriminator as JaxSeganD
from rsrgan_tpu.training import GanTrainer as JaxGanTrainer
from rsrgan_tpu.training import MseTrainer as JaxMseTrainer
from rsrgan_tpu.training.segan import SeganTrainer as JaxSeganTrainer
from rsrgan_tpu_torch.data import (FrameBatcher, HostShardedFrameBatches,
                                   HostShardedSequenceBatches,
                                   SequenceBatcher, UtteranceStore)
from rsrgan_tpu_torch.models import flatten_tree, unflatten_tree
from rsrgan_tpu_torch.parallel import (DataWorld, all_reduce_mean,
                                       backend_for, current_world,
                                       gather_rows, global_moments, launch,
                                       local_draws, replicate, shard_batch)
from rsrgan_tpu_torch.training import checkpoints

torch.set_num_threads(1)

IN, OUT, T = ranks.IN, ranks.OUT, ranks.T
SPAWN_TIMEOUT = 240


def run_world(fn, world, *args):
    """``fn`` on ``world`` spawned gloo ranks; each must exit 0."""
    assert launch(fn, world, args=args, timeout=SPAWN_TIMEOUT) == 0


def read_ranks(out_dir, world):
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# ---------------------------------------------------------------------------
# the host-sharded views
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def store_path(tmp_path_factory):
    """A store of 17 utterances of 20-90 frames (both packages read it)."""
    path = str(tmp_path_factory.mktemp("views") / "s.rtu")
    rng = np.random.default_rng(0)
    w = JaxStoreWriter(path)
    for i in range(17):
        t = int(rng.integers(20, 90))
        w.add(f"u{i}", rng.normal(size=(t, 5)).astype(np.float32),
              rng.normal(size=(t, 3)).astype(np.float32))
    w.close()
    return path


@pytest.mark.parametrize("count", [2, 4])
def test_sequence_views_match_jax(store_path, count):
    """Every process's blocks: the JAX view's, shapes equal across
    processes, and in process order the global batch (ragged global
    batches skipped by both)."""
    def port_batcher():
        return SequenceBatcher(UtteranceStore(store_path), 4, shuffle=True,
                               seed=3, drop_remainder=False)

    def jax_batcher():
        return JaxSeqBatcher(JaxStore(store_path), 4, shuffle=True, seed=3,
                             drop_remainder=False)

    globals_ = [b for b in port_batcher() if len(b.utt_ids) == 4]
    views = [list(HostShardedSequenceBatches(port_batcher(), p, count))
             for p in range(count)]
    for p, view in enumerate(views):
        jview = list(JaxSeqView(jax_batcher(), p, count))
        assert HostShardedSequenceBatches(port_batcher(), p, count) \
            .num_batches() == JaxSeqView(jax_batcher(), p,
                                         count).num_batches()
        assert len(view) == len(jview) == len(globals_)
        for got, want in zip(view, jview):
            assert got.utt_ids == want.utt_ids
            for field in ("inputs", "labels", "lengths"):
                np.testing.assert_array_equal(getattr(got, field),
                                              getattr(want, field))
    for g, blocks in zip(globals_, zip(*views)):
        assert len({b.inputs.shape for b in blocks}) == 1
        assert blocks[0].inputs.shape[1] == g.inputs.shape[1]
        assert sum((b.utt_ids for b in blocks), []) == g.utt_ids
        for field in ("inputs", "labels", "lengths"):
            np.testing.assert_array_equal(
                np.concatenate([getattr(b, field) for b in blocks]),
                getattr(g, field))


@pytest.mark.parametrize("count", [2, 4])
def test_frame_views_match_jax(store_path, count):
    globals_ = list(FrameBatcher(UtteranceStore(store_path), 8, seed=5))
    views = [list(HostShardedFrameBatches(
        FrameBatcher(UtteranceStore(store_path), 8, seed=5), p, count))
        for p in range(count)]
    for p, view in enumerate(views):
        jview = list(JaxFrameView(JaxFrameBatcher(JaxStore(store_path), 8,
                                                  seed=5), p, count))
        assert len(view) == len(jview) == len(globals_)
        for (x, y), (jx, jy) in zip(view, jview):
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)
    for (gx, gy), blocks in zip(globals_, zip(*views)):
        np.testing.assert_array_equal(np.concatenate([b[0] for b in blocks]),
                                      gx)
        np.testing.assert_array_equal(np.concatenate([b[1] for b in blocks]),
                                      gy)


def test_views_raise_as_jax(store_path, tmp_path):
    """An indivisible global batch, and a plan with no full global batch,
    raise ValueError in both packages."""
    store = UtteranceStore(store_path)
    for view, batcher in ((HostShardedSequenceBatches,
                           SequenceBatcher(store, 3)),
                          (HostShardedFrameBatches, FrameBatcher(store, 3)),
                          (HostShardedSequenceBatches,
                           SequenceBatcher(store, 64)),
                          (HostShardedFrameBatches,
                           FrameBatcher(store, 4096))):
        with pytest.raises(ValueError):
            view(batcher, 0, 2)
    with pytest.raises(ValueError):
        JaxSeqView(JaxSeqBatcher(JaxStore(store_path), 64), 0, 2)


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def test_world_of_one_is_the_identity():
    """No process group: every collective returns its input and launches
    nothing."""
    w = current_world()
    assert (w.rank, w.world) == (0, 1)
    x = torch.arange(6.0).reshape(3, 2)
    tree = {"a": x}
    assert all_reduce_mean(w, tree) is tree
    assert shard_batch(w, x) is x and gather_rows(w, x) is x
    gen = torch.Generator()
    assert local_draws(gen) is gen
    replicate(w, [x])
    assert w.collectives == 0


def test_backend_follows_the_layout():
    """nccl only where every rank has a card of its own."""
    assert backend_for(["cpu", "cpu"]) == "gloo"
    assert backend_for(["GPU-a", "GPU-a"]) == "gloo"
    assert backend_for(["GPU-a", "GPU-b", "GPU-a"]) == "gloo"
    assert backend_for(["GPU-a", "GPU-b"]) == "nccl"


def test_shard_batch_blocks_and_raises():
    w = DataWorld(rank=1, world=3)
    x = np.arange(12).reshape(6, 2)
    np.testing.assert_array_equal(shard_batch(w, x), x[2:4])
    np.testing.assert_array_equal(shard_batch(w, [7, 8, 9, 10, 11, 12]),
                                  [9, 10])
    got = shard_batch(w, (x, {"k": 2 * x}), axis=0)
    np.testing.assert_array_equal(got[0], x[2:4])
    np.testing.assert_array_equal(got[1]["k"], 2 * x[2:4])
    np.testing.assert_array_equal(shard_batch(w, x.T, axis=1), x.T[:, 2:4])
    with pytest.raises(ValueError, match="do not divide"):
        shard_batch(w, np.zeros((4, 2)))


@pytest.mark.parametrize("world", [2, 3])
def test_collectives_match_one_process(tmp_path, world):
    """Moments of the global batch and their gradient (gathered, per
    rank's share of the loss: divided by the world), the world's mean,
    rank 0's replicated tensor, and the draws: each rank's rows of the
    one-process draws at the global batch."""
    run_world(ranks.collectives_rank, world, str(tmp_path))
    outs = read_ranks(tmp_path, world)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4 * world, 3, 5))
                         .astype(np.float32)).requires_grad_(True)
    mean, mean_sq = x.mean((0, 1)), torch.square(x).mean((0, 1))
    c_mean, c_var = x.mean(0), x.var(0, correction=0)
    loss = (mean * torch.arange(5.0)).sum() + mean_sq.sum() \
        + (c_var * c_mean).sum()
    (grad,) = torch.autograd.grad(loss, x)
    gen = torch.Generator().manual_seed(9)
    rand = torch.rand((2 * 3 * world, 2), generator=gen).numpy()
    randn = torch.randn((2 * 3 * world, 2), generator=gen).numpy()
    for r, out in enumerate(outs):
        for got, want in zip(out["moments"], (mean, mean_sq, c_mean, c_var)):
            np.testing.assert_allclose(got, want.detach().numpy(),
                                       rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out["grad"] / world, grad.numpy(),
                                   rtol=1e-5, atol=1e-7)
        assert out["mean"]["a"].dtype == torch.float32
        np.testing.assert_allclose(out["mean"]["a"].numpy(),
                                   np.full((2, 2), (world - 1) / 2))
        assert out["mean"]["b"].dtype == torch.int32
        assert int(out["mean"]["b"]) == world - 1
        np.testing.assert_array_equal(out["replicated"], np.ones(3))
        for got, full in ((out["rand"], rand), (out["randn"], randn)):
            blocks = full.reshape(2, world, 3, 2)[:, r].reshape(6, 2)
            np.testing.assert_array_equal(got, blocks)
        # the moments' three all-reduces forward and three backward,
        # the gather, the mean and one broadcast
        assert out["collectives"] == 3 + 3 + 1 + 1 + 1


def test_a_failing_rank_ends_the_launch():
    """Rank 1 raises while rank 0 waits in a collective: the launch
    returns non-zero at once and ends rank 0; a launch past its time
    raises."""
    assert launch(ranks.failing_rank, 2, timeout=SPAWN_TIMEOUT) != 0
    with pytest.raises(TimeoutError):
        launch(ranks.sleeping_rank, 2, timeout=3)


# ---------------------------------------------------------------------------
# one data-parallel step against the JAX trainer's full-batch step
# ---------------------------------------------------------------------------

def with_adam_history(net, rng):
    """Adam's moments as after three earlier steps (from zero moments the
    first step moves a parameter by +-lr on its gradient's sign, which
    rounding can flip for a gradient near zero)."""
    clip, adam = net.opt_state
    adam = adam._replace(
        count=jnp.int32(3),
        mu=jax.tree.map(lambda a: jnp.asarray(
            rng.normal(size=a.shape) * 1e-2, jnp.float32), adam.mu),
        nu=jax.tree.map(lambda a: jnp.asarray(
            rng.uniform(1e-5, 1e-4, size=a.shape), jnp.float32), adam.nu))
    return net.replace(opt_state=(clip, adam))


def gan_case():
    rng = np.random.default_rng(42)
    lens = np.asarray([T, T - 1, 5, T, 3, T, T - 2, 1, T, 4, T, 6, T, 2, T,
                       7], np.int32)
    x = rng.normal(size=(16, T, IN)).astype(np.float32)
    y = rng.normal(size=(16, T, OUT)).astype(np.float32)
    # JAX's scan cell (its Pallas kernels agree with it to 1e-5 and take
    # a minute a step in interpreter mode); the ranks run the port's
    # kernel twins
    tr = JaxGanTrainer(JaxResGen(output_dim=OUT, cell_size=ranks.GU,
                                 lstm_impl="scan"),
                       JaxDisc(cell_size=ranks.DU, num_projection=OUT,
                               lstm_impl="scan"),
                       output_dim=OUT, input_dim=IN, l2_scale=1e-3)
    hp = {"g_lr": 3e-3, "d_lr": 1e-2, "mse_lambda": 1.0,
          "disc_noise_std": 0.0, "d_real": 1.0, "d_fake": 0.0}
    s0 = tr.init_state(jax.random.PRNGKey(1), jnp.asarray(x),
                       jnp.asarray(lens))
    s0 = s0.replace(g=s0.g.replace(params=jax.tree.map(
        lambda a: a + 0.05, s0.g.params)))
    s1, m = jax.jit(tr._train_step_impl)(
        s0, jnp.asarray(x), jnp.asarray(y), jnp.asarray(lens),
        {k: jnp.float32(v) for k, v in hp.items()}, jax.random.PRNGKey(2))
    return {"kind": "gan", "batch": (x, y, lens), "hp": hp}, s0, s1, m, None


def mse_case(kind):
    """The MSE trainer's step: res_lstm_l (sequence), the DNN with
    BatchNorm (frames) or bnlstm, from a state with perturbed params (and
    batch statistics) and Adam's moments as after earlier steps."""
    rng = np.random.default_rng(7)
    if kind == "mse":
        g = JaxResGen(output_dim=OUT, cell_size=ranks.GU, lstm_impl="scan")
        x = rng.normal(size=(16, T, IN)).astype(np.float32)
        y = rng.normal(size=(16, T, OUT)).astype(np.float32)
        lens = np.asarray([T - (i * 5) % T for i in range(16)], np.int32)
    elif kind == "dnn_bn":
        g = JaxDnn(output_dim=OUT, units=8, hidden_layers=2, batch_norm=True)
        x = rng.normal(size=(24, IN * ranks.SPLICE)).astype(np.float32)
        y = rng.normal(size=(24, OUT)).astype(np.float32)
        lens = None
    else:
        g = JaxBnGen(output_dim=OUT, cell_size=ranks.BN_U,
                     num_projection=ranks.BN_P, num_layers=ranks.BN_LAYERS)
        x = rng.normal(size=(8, 8, IN)).astype(np.float32)
        y = rng.normal(size=(8, 8, OUT)).astype(np.float32)
        # a zero-length row, a rank whose rows end at step 2 of 4 ranks,
        # and steps 6 and 7 where every row is masked
        lens = np.asarray([6, 4, 0, 2, 6, 3, 1, 5], np.int32)
    sequence = lens is not None
    tr = JaxMseTrainer(g, output_dim=OUT, l2_scale=1e-3,
                       max_grad_norm=15.0 if sequence else None,
                       sequence_mode=sequence)
    jl = jnp.asarray(lens) if sequence else None
    s0 = tr.init_state(jax.random.PRNGKey(1), jnp.asarray(x), jl)
    net = s0.net.replace(params=jax.tree.map(lambda a: a + 0.05,
                                             s0.net.params))
    if net.extra is not None:
        net = net.replace(extra=jax.tree.map(lambda a: a * 1.5 + 0.1,
                                             net.extra))
    s0 = s0.replace(net=with_adam_history(net, rng))
    lr = 3e-3
    (_, (m, _)), grads = jax.jit(jax.value_and_grad(
        tr._loss_fn, has_aux=True))(s0.net.params, s0.net.extra,
                                    jnp.asarray(x), jnp.asarray(y), jl, None)
    s1, _ = jax.jit(tr._train_step_impl)(s0, jnp.asarray(x), jnp.asarray(y),
                                         jl, jnp.float32(lr),
                                         jax.random.PRNGKey(2))
    return ({"kind": kind, "batch": (x, y, lens), "lr": lr}, s0, s1, m,
            grads)


def segan_case():
    """SEGAN's step (1 D + 1 G, RMSProp, VBN D) from a state with every
    leaf drawn, JAX's z and D noise recorded (numpy draws in place of
    ``jax.random.normal``) and handed to each rank as its rows."""
    draws = []
    rng = np.random.default_rng(123)

    def normal(key, shape=(), dtype=jnp.float32):
        a = rng.normal(size=shape).astype(np.float32)
        draws.append(a)
        return jnp.asarray(a, dtype)

    with mock.patch.object(jax.random, "normal", normal):
        return _segan_case(draws)


def _segan_case(draws):
    kw = dict(enc_depths=ranks.SEGAN_ENC, kwidth=5, bias_deconv=True)
    tr = JaxSeganTrainer(JaxAE(units=ranks.SEGAN_W_OUT, **kw),
                         JaxSeganD(num_fmaps=ranks.SEGAN_ENC, kwidth=5),
                         disc_updates=1, gen_updates=1)
    data = np.random.default_rng(1)
    x = data.normal(size=(8, ranks.SEGAN_W_IN)).astype(np.float32)
    y = data.normal(size=(8, ranks.SEGAN_W_OUT)).astype(np.float32)
    shapes = jax.eval_shape(tr.init_state, jax.random.PRNGKey(0),
                            jnp.asarray(x))
    leaves = np.random.default_rng(5)

    def drawn(tree):
        flat = {}
        for k, v in flatten_tree(tree).items():
            scale = (0.2 if len(v.shape) < 2
                     else 1.0 / np.sqrt(np.prod(v.shape[:-1])))
            flat[k] = (leaves.normal(size=v.shape) * scale).astype(
                np.float32)
        return unflatten_tree(flat)

    def net(ns):
        params = drawn(ns.params)
        nu = jax.tree.map(lambda a: leaves.uniform(1e-4, 1e-3, a.shape)
                          .astype(np.float32), ns.opt_state[1].nu)
        extra = None
        if ns.extra is not None:
            extra = {"vbn_stats": {}}
            for name, leaf in ns.extra["vbn_stats"].items():
                mean = leaves.normal(0, 0.3, leaf["ref_mean"].shape)
                extra["vbn_stats"][name] = {
                    "ref_mean": mean.astype(np.float32),
                    "ref_meansq": (mean ** 2 + leaves.uniform(
                        0.5, 1.5, mean.shape)).astype(np.float32)}
        return ns.replace(params=params,
                          ema=jax.tree.map(lambda a: a * 0.9, params),
                          opt_state=(ns.opt_state[0],
                                     ns.opt_state[1]._replace(nu=nu)),
                          extra=extra)

    s0 = jax.tree.map(jnp.asarray, shapes.replace(
        g=net(shapes.g), d=net(shapes.d), step=np.zeros((), np.int32)))
    hp = {"g_lr": 5e-4, "d_lr": 1e-3, "l1_lambda": 3.0,
          "disc_noise_std": 0.3}
    fn = tr.train_step.__wrapped__
    draws.clear()   # init_state's shapes drew too
    s1, m = jax.jit(lambda *a: fn(tr, *a))(s0, jnp.asarray(x),
                                           jnp.asarray(y), hp,
                                           jax.random.PRNGKey(7))
    assert len(draws) == 5   # z, real and fake noise; z, fake noise
    return ({"kind": "segan", "batch": (x, y, None), "hp": hp,
             "draws": draws}, s0, s1, m, None)


STATE_TOL = {"gan": 1e-5, "mse": 1e-5, "dnn_bn": 1e-5, "bnlstm": 2e-4,
             "segan": 2e-4}


def state_dict(state):
    return flax.serialization.to_state_dict(jax.tree.map(np.asarray, state))


@functools.lru_cache(maxsize=None)
def jax_step(kind):
    """The JAX step of ``kind`` on the host, computed once for both world
    sizes: (the case, the state before and after as state dicts, the
    metrics, the gradients as a flat dict or None)."""
    if kind == "gan":
        case, s0, s1, m, g = gan_case()
    elif kind == "segan":
        case, s0, s1, m, g = segan_case()
    else:
        case, s0, s1, m, g = mse_case(kind)
    return (case, state_dict(s0), state_dict(s1),
            {k: float(v) for k, v in m.items()},
            None if g is None
            else flatten_tree(jax.tree.map(np.asarray, g)))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["gan", "mse", "dnn_bn", "bnlstm",
                                  "segan"])
def test_dp_step_matches_jax_full_batch(tmp_path, kind, world):
    """One step on ``world`` gloo ranks, each on its rows of the batch,
    against the JAX trainer's one-device step on the whole batch, from
    one bridged state: the metrics, the first update's gradients (the
    world's mean), the whole state after the step; every rank's state
    the same bits."""
    case, s0, s1, m_want, g_want = jax_step(kind)
    case = dict(case, state=s0)
    case_path = str(tmp_path / "case.pkl")
    with open(case_path, "wb") as f:
        pickle.dump(case, f)
    run_world(ranks.step_rank, world, case_path, str(tmp_path))
    outs = read_ranks(tmp_path, world)
    got = outs[0]
    for k, a in m_want.items():
        assert abs(got["metrics"][k] - a) < 1e-4 * (1 + abs(a)), \
            (k, got["metrics"][k], a)
    if g_want is not None:
        assert sorted(got["grads"]) == sorted(g_want)
        for k, g in got["grads"].items():
            np.testing.assert_allclose(
                g, g_want[k], atol=2e-4 * max(1.0, np.abs(g_want[k]).max()),
                err_msg=k)
    want = flatten_tree(s1)
    flat = flatten_tree(got["state"])
    assert sorted(flat) == sorted(want)
    for k, w in want.items():
        if w is None:
            assert flat[k] is None, k
            continue
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(
            np.asarray(flat[k], np.float64), w,
            atol=STATE_TOL[kind] * max(1.0, np.abs(w).max()), err_msg=k)
    for other in outs[1:]:
        for k, v in flatten_tree(other["state"]).items():
            if v is not None:
                np.testing.assert_array_equal(v, flat[k], err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_dp_draws_match_one_process_step(tmp_path, world):
    """The GAN step with D's input noise (std 0.3) and dropout
    (keep_prob 0.8 in G and D) on ``world`` ranks against the port's
    one-process step at the global batch: every rank draws the global
    batch's noise and masks and keeps its rows (D's 2B rows as a real and
    a fake block), so the two steps see the same numbers."""
    case = {"kind": "gan", "keep_prob": 0.8, "noise_seed": 5,
            "hp": {"g_lr": 3e-3, "d_lr": 1e-2, "mse_lambda": 1.0,
                   "disc_noise_std": 0.3, "d_real": 1.0, "d_fake": 0.0}}
    rng = np.random.default_rng(3)
    case["batch"] = (rng.normal(size=(8, T, IN)).astype(np.float32),
                     rng.normal(size=(8, T, OUT)).astype(np.float32),
                     np.asarray([T, 5, T, 3, T, 7, 2, T], np.int32))
    tr = ranks.port_trainer("gan", keep_prob=0.8)
    st = ranks.init_state(tr, "gan")
    m_want, g_want = ranks.run_step(case, tr, st)
    want = flatten_tree(checkpoints.state_tree(st))
    case_path = str(tmp_path / "case.pkl")
    with open(case_path, "wb") as f:
        pickle.dump(case, f)
    run_world(ranks.step_rank, world, case_path, str(tmp_path))
    got = read_ranks(tmp_path, world)[0]
    for k, v in m_want.items():
        assert abs(got["metrics"][k] - v) < 1e-5 * (1 + abs(v)), k
    for k, g in got["grads"].items():
        np.testing.assert_allclose(g, g_want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    for k, v in flatten_tree(got["state"]).items():
        np.testing.assert_allclose(np.asarray(v, np.float64),
                                   np.asarray(want[k], np.float64),
                                   atol=1e-5, err_msg=k)


def test_global_moments_in_a_world_of_one():
    """Without a process group the moments are x's own, and nothing is
    launched."""
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(6, 4, 3))
                         .astype(np.float32))
    mean, mean_sq = global_moments(x, (0, 1))
    np.testing.assert_array_equal(mean.numpy(), x.mean((0, 1)).numpy())
    np.testing.assert_array_equal(mean_sq.numpy(),
                                  torch.square(x).mean((0, 1)).numpy())
    c_mean, c_var = global_moments(x, (0,), centred=True)
    np.testing.assert_array_equal(c_mean.numpy(), x.mean(0).numpy())
    np.testing.assert_allclose(c_var.numpy(),
                               x.var(0, correction=0).numpy(), rtol=1e-6)
    assert current_world().collectives == 0
