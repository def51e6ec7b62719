"""The port's recurrent-batch-norm LSTM against the JAX package:
``BnLstmCell`` and ``BnLstmGenerator`` forward in train and eval mode
(ragged lengths with a zero-length row and steps where every row is
masked, whose fold must stay frozen), the folded moving statistics, the
gradients, bf16; the flax trees both ways; ``--trainer=rnn
--g_type=bnlstm``'s ``MseTrainer`` step (loss, gradients, params, Adam
moments, EMA, batch_stats), eval and infer, the gathered step against the
host batch, the ``MseState`` checkpoint byte-equal to flax's; and
``--trainer=gan_rnn --g_type=bnlstm``, which the JAX package cannot train
and the port refuses.

Small widths: 3 layers of BnLstm(U=12, proj 5) on 9-dim inputs, 4 out.
Tolerances: f32 forwards and statistics 1e-5, gradients and the state
after a step 2e-4, each at unit scale (times max(1, max |reference|));
bf16 2e-2.
"""

import functools

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsrgan_tpu.models.discriminators import LstmDiscriminator as JaxLstmD
from rsrgan_tpu.models.recurrent import BnLstmGenerator as JaxBnGen
from rsrgan_tpu.ops.bnlstm import BnLstmCell as JaxBnCell
from rsrgan_tpu.training import GanTrainer as JaxGanTrainer
from rsrgan_tpu.training import MseTrainer as JaxMseTrainer
from rsrgan_tpu.training import checkpoints as jax_ckpt
from rsrgan_tpu_torch.data import SequenceBatcher, StoreWriter, UtteranceStore
from rsrgan_tpu_torch.data import device_feed as pfeed
from rsrgan_tpu_torch.models import (collections_tree, flatten_tree,
                                     get_discriminator, get_generator,
                                     load_collections, load_flax_params,
                                     module_tree)
from rsrgan_tpu_torch.models.recurrent import BnLstmGenerator
from rsrgan_tpu_torch.ops.bnlstm import BnLstmCell
from rsrgan_tpu_torch.training import GanTrainer, MseTrainer, checkpoints

torch.set_num_threads(2)

IN, OUT, U, P, LAYERS = 9, 4, 12, 5, 3
B, T = 5, 8
# a zero-length row, and steps 6 and 7 where every row is masked
LENS = np.asarray([6, 4, 0, 2, 6], np.int32)
LR = 3e-3


def t(a):
    return torch.from_numpy(np.array(a))


def inputs(seed=0, width=IN, rows=B):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(rows, T, width)).astype(np.float32),
            rng.normal(size=(rows, T, OUT)).astype(np.float32))


def perturbed(variables, seed=1):
    """Flax variables with the BN scales, offsets, biases and moving
    statistics moved off their initial values (0.1, 0, 0, and 0/1)."""
    rng = np.random.default_rng(seed)
    variables = jax.tree.map(np.array, variables)
    for path, leaf in flatten_tree(variables).items():
        if path.endswith(("_scale", "_offset", "bias")):
            leaf[...] = rng.uniform(-0.5, 0.5, leaf.shape)
        elif path.endswith("_mean"):
            leaf[...] = rng.normal(0, 0.3, leaf.shape)
        elif path.endswith("_var"):
            leaf[...] = rng.uniform(0.5, 2.0, leaf.shape)
    return variables


def cell_pair(dtype=jnp.float32):
    jc = JaxBnCell(U, P, compute_dtype=dtype)
    pc = BnLstmCell(IN, U, P, compute_dtype=(torch.bfloat16
                                             if dtype == jnp.bfloat16
                                             else torch.float32))
    x, _ = inputs()
    v = perturbed(jc.init(jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(LENS)))
    load_flax_params(pc, v["params"])
    load_collections(pc, {"batch_stats": v["batch_stats"]})
    return jc, pc, v, x


def jax_cell(jc, v, x, train):
    if train:
        out, upd = jc.apply(v, jnp.asarray(x), jnp.asarray(LENS), True,
                            mutable=["batch_stats"])
        return np.asarray(out), jax.tree.map(np.asarray, upd)
    return np.asarray(jc.apply(v, jnp.asarray(x), jnp.asarray(LENS),
                               False)), None


def assert_close(got, want, atol, what=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               atol=atol * max(1.0, np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("train", [True, False])
def test_cell_matches_jax(train):
    """Outputs (zero past each row's length) and, in train mode, the
    folded moving statistics; eval mode leaves them as they were."""
    jc, pc, v, x = cell_pair()
    want, upd = jax_cell(jc, v, x, train)
    got = pc(t(x), t(LENS), train)
    assert got.shape == (B, T, P)
    assert_close(got.detach().numpy(), want, 1e-5)
    assert not got[2].any() and not got[:, 6:].any()
    stats = flatten_tree(collections_tree(pc)["batch_stats"])
    ref = flatten_tree(upd["batch_stats"] if train else v["batch_stats"])
    assert sorted(stats) == sorted(ref)
    for k in ref:
        assert_close(stats[k], ref[k], 1e-5, k)
    if train:   # the fold moved every statistic
        for k, before in flatten_tree(v["batch_stats"]).items():
            assert not np.allclose(stats[k], before), k


def test_fold_is_frozen_where_every_row_is_masked():
    """Steps 6 and 7 hold no valid row: the statistics after T=8 steps
    are those after the first 6, bit for bit."""
    _, pc, v, x = cell_pair()
    pc(t(x), t(LENS), True)
    full = flatten_tree(collections_tree(pc)["batch_stats"])
    load_collections(pc, {"batch_stats": v["batch_stats"]})
    pc(t(x[:, :6]), t(LENS), True)
    short = flatten_tree(collections_tree(pc)["batch_stats"])
    for k in full:
        np.testing.assert_array_equal(full[k], short[k], err_msg=k)


def test_cell_gradients_match_jax():
    """d(sum(out * w)) / d(every parameter and the inputs), train mode:
    through the batch statistics, not the moving ones."""
    jc, pc, v, x = cell_pair()
    w = np.random.default_rng(5).normal(size=(B, T, P)).astype(np.float32)

    def loss(params, xs):
        out, _ = jc.apply({"params": params,
                           "batch_stats": v["batch_stats"]}, xs,
                          jnp.asarray(LENS), True, mutable=["batch_stats"])
        return jnp.sum(out * w)

    g_params, g_x = jax.grad(loss, argnums=(0, 1))(v["params"],
                                                   jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    (pc(xt, t(LENS), True) * t(w)).sum().backward()
    want = flatten_tree(jax.tree.map(np.asarray, g_params))
    got = {k: p.grad.numpy() for k, p in pc.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert_close(got[k], want[k], 2e-4, k)
    assert_close(xt.grad.numpy(), g_x, 2e-4, "inputs")


@pytest.mark.parametrize("train", [True, False])
def test_cell_bf16_at_bf16_scale(train):
    """bf16 products (f32 state and statistics) against JAX's."""
    jc, pc, v, x = cell_pair(jnp.bfloat16)
    want, upd = jax_cell(jc, v, x, train)
    assert_close(pc(t(x), t(LENS), train).detach().numpy(), want, 2e-2)
    if train:
        stats = flatten_tree(collections_tree(pc)["batch_stats"])
        for k, ref in flatten_tree(upd["batch_stats"]).items():
            assert_close(stats[k], ref, 2e-2, k)


def gen_pair(seed=0):
    jg = JaxBnGen(output_dim=OUT, cell_size=U, num_projection=P,
                  num_layers=LAYERS)
    pg = BnLstmGenerator(IN, OUT, cell_size=U, num_projection=P,
                         num_layers=LAYERS)
    x, y = inputs(seed)
    v = perturbed(jg.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                          jnp.asarray(LENS)))
    load_flax_params(pg, v["params"])
    load_collections(pg, {"batch_stats": v["batch_stats"]})
    return jg, pg, v, x, y


@pytest.mark.parametrize("train", [True, False])
def test_generator_matches_jax(train):
    """Dense_0 (relu), cell_0..2, Dense_1: output and updated statistics;
    the port's trees read back as flax's."""
    jg, pg, v, x, _ = gen_pair()
    if train:
        want, upd = jg.apply(v, jnp.asarray(x), jnp.asarray(LENS), True,
                             mutable=["batch_stats"])
    else:
        want, upd = jg.apply(v, jnp.asarray(x), jnp.asarray(LENS)), v
    got = pg(t(x), t(LENS), train)
    assert_close(got.detach().numpy(), np.asarray(want), 1e-5)
    tree = module_tree(pg)
    assert jax.tree.structure(tree) == jax.tree.structure(
        jax.tree.map(np.asarray, v["params"]))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(v["params"])):
        np.testing.assert_array_equal(a, b)
    stats = collections_tree(pg)
    assert list(stats) == ["batch_stats"]
    for a, b in zip(jax.tree.leaves(stats),
                    jax.tree.leaves(jax.tree.map(np.asarray,
                                                 upd["batch_stats"]))):
        assert_close(a, b, 1e-5)


def test_registry_builds_bnlstm():
    """get_generator("bnlstm") (its ``lstm_impl`` and ``keep_prob``
    ignored, as in JAX) has the JAX tree at the recipes' widths."""
    g = get_generator("bnlstm", input_dim=257, output_dim=40,
                      keep_prob=0.5, lstm_impl="scan")
    assert isinstance(g, BnLstmGenerator)
    shapes = {k: tuple(p.shape) for k, p in g.named_parameters()}
    assert shapes["Dense_0.kernel"] == (257, 280)
    assert shapes["cell_2.input_kernel"] == (280, 3040)
    assert shapes["cell_0.projection_kernel"] == (760, 280)
    assert shapes["Dense_1.kernel"] == (280, 40)
    assert flatten_tree(collections_tree(g)["batch_stats"])[
        "cell_1.cell_var"].shape == (760,)


# ---------------------------------------------------------------------------
# --trainer=rnn --g_type=bnlstm
# ---------------------------------------------------------------------------

def jax_mse_state(seed=0):
    """A JAX MseTrainer on BnLstmGenerator and a state with perturbed
    params and statistics, and Adam's moments as after earlier steps."""
    jg, _, v, x, y = gen_pair(seed)
    tr = JaxMseTrainer(jg, output_dim=OUT, l2_scale=1e-3, max_grad_norm=15.0)
    s0 = tr.init_state(jax.random.PRNGKey(1), jnp.asarray(x),
                       jnp.asarray(LENS))
    rng = np.random.default_rng(11)
    clip, adam = s0.net.opt_state
    adam = adam._replace(
        count=jnp.int32(3),
        mu=jax.tree.map(lambda a: jnp.asarray(
            rng.normal(size=a.shape) * 1e-2, jnp.float32), adam.mu),
        nu=jax.tree.map(lambda a: jnp.asarray(
            rng.uniform(1e-5, 1e-4, size=a.shape), jnp.float32), adam.nu))
    s0 = s0.replace(net=s0.net.replace(
        params=jax.tree.map(jnp.asarray, v["params"]),
        ema=jax.tree.map(lambda a: jnp.asarray(a) * 0.9, v["params"]),
        extra={"batch_stats": jax.tree.map(jnp.asarray,
                                           v["batch_stats"])},
        opt_state=(clip, adam)))
    return tr, s0, x, y


def port_mse(s0):
    pg = BnLstmGenerator(IN, OUT, cell_size=U, num_projection=P,
                         num_layers=LAYERS)
    tr = MseTrainer(pg, output_dim=OUT, l2_scale=1e-3, max_grad_norm=15.0)
    st = tr.init_state()
    checkpoints.load_state_tree(st, flax.serialization.to_state_dict(
        jax.tree.map(np.asarray, s0)))
    return tr, st


def assert_state_matches(st, jstate, atol):
    got = flatten_tree(checkpoints.state_tree(st))
    want = flatten_tree(flax.serialization.to_state_dict(
        jax.tree.map(np.asarray, jstate)))
    assert sorted(got) == sorted(want)
    for k in want:
        assert_close(got[k], want[k], atol, k)


@functools.lru_cache(maxsize=None)
def jax_mse_step():
    """The JAX step from ``jax_mse_state()``, jitted: (trainer, state
    before, batch, metrics, gradients, state after)."""
    tr, s0, x, y = jax_mse_state()
    args = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(LENS))
    (_, (m_want, _)), g_want = jax.jit(jax.value_and_grad(
        tr._loss_fn, has_aux=True))(s0.net.params, s0.net.extra, *args,
                                    None)
    s1, _ = jax.jit(tr._train_step_impl)(s0, *args, jnp.float32(LR),
                                         jax.random.PRNGKey(2))
    return tr, s0, x, y, m_want, g_want, s1


def test_mse_step_matches_jax():
    """One step: the losses, every gradient before clipping, and the whole
    MseState after it (params, Adam count/mu/nu, EMA, the batch_stats the
    train-mode forward folded, step)."""
    tr, s0, x, y, m_want, g_want, s1 = jax_mse_step()
    ptr, st = port_mse(s0)
    ptr.grad_log = []
    m = ptr.train_step(st, t(x), t(y), t(LENS), LR)
    for k, val in m_want.items():
        np.testing.assert_allclose(float(m[k]), float(val), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    want = flatten_tree(jax.tree.map(np.asarray, g_want))
    (grads,) = ptr.grad_log
    assert sorted(grads) == sorted(want)
    for k, g in grads.items():
        assert_close(g.numpy(), want[k], 2e-4, k)
    assert st.step == int(s1.step) == 1
    assert_state_matches(st, s1, 2e-4)
    assert not np.allclose(
        st.net.extra()["batch_stats"]["cell_0"]["state_mean"],
        np.asarray(s0.net.extra["batch_stats"]["cell_0"]["state_mean"]))


def test_mse_eval_and_infer_match_jax():
    """eval_step and infer_step run G in eval mode, on the moving
    statistics, and change no state."""
    tr, s0, x, y = jax_mse_state(seed=3)
    want = jax.jit(tr._eval_step_impl)(s0, jnp.asarray(x), jnp.asarray(y),
                                       jnp.asarray(LENS))
    out = tr.infer_with_params(s0.net.params, s0.net.extra, jnp.asarray(x),
                               jnp.asarray(LENS))
    ptr, st = port_mse(s0)
    before = flatten_tree(checkpoints.state_tree(st))
    got = ptr.eval_step(st, t(x), t(y), t(LENS))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert_close(ptr.infer_step(st, t(x), t(LENS)).numpy(), out, 1e-5)
    after = flatten_tree(checkpoints.state_tree(st))
    for k, val in before.items():
        np.testing.assert_array_equal(after[k], val, err_msg=k)


def test_mse_state_checkpoint_bytes_equal_flax(tmp_path):
    """The JAX MseState after a step (extra = the cells' batch_stats) ->
    the port -> the bytes flax writes; the port's file restores in both
    packages; decode reads G's params and batch_stats from it."""
    s1 = jax_mse_step()[-1]
    jpath = jax_ckpt.save_checkpoint(str(tmp_path / "jax"), "RNNTrainer",
                                     s1, 1)
    with open(jpath, "rb") as f:
        jax_bytes = f.read()
    ptr, st = port_mse(s1)
    ppath = checkpoints.save_checkpoint(str(tmp_path / "port"), "RNNTrainer",
                                        checkpoints.state_tree(st), 1)
    with open(ppath, "rb") as f:
        port_bytes = f.read()
    assert port_bytes == jax_bytes
    st2 = ptr.init_state()
    checkpoints.load_checkpoint(str(tmp_path / "port"), "RNNTrainer", st2)
    assert checkpoints.msgpack_serialize(checkpoints.state_tree(st2)) \
        == jax_bytes
    restored = flax.serialization.from_bytes(s1, port_bytes)
    assert flax.serialization.to_bytes(restored) == port_bytes
    _, extra = checkpoints.load_generator_state(str(tmp_path / "port"),
                                                "RNNTrainer")
    assert list(extra) == ["batch_stats"]
    for a, b in zip(jax.tree.leaves(extra), jax.tree.leaves(s1.net.extra)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_gathered_steps_equal_host_batch(tmp_path):
    """The device feed's train_step_gathered and eval_step_gathered
    against train_step and eval_step on the host batcher's batches: the
    same metrics and state (batch_stats included), bit for bit."""
    rng = np.random.default_rng(3)
    path = str(tmp_path / "tr.rtu")
    with StoreWriter(path) as w:
        for i, n in enumerate((5, 9, 7, 3, 8, 6)):
            w.add(f"u{i}", rng.normal(size=(n, 3)).astype(np.float32),
                  rng.normal(size=(n, OUT)).astype(np.float32))
    store = UtteranceStore([path])
    feed = pfeed.DeviceFeed(store, device=torch.device("cpu"))
    batcher = SequenceBatcher(store, 3, 1, 1, shuffle=True, seed=2)
    plans = list(batcher.iter_index_batches())
    runs = {}
    for mode in ("host", "gathered"):
        g = BnLstmGenerator(9, OUT, cell_size=U, num_projection=P,
                            num_layers=2,
                            generator=torch.Generator().manual_seed(0))
        tr = MseTrainer(g, output_dim=OUT, l2_scale=1e-3, max_grad_norm=15.0)
        st = tr.init_state()
        metrics = []
        for indices in plans:
            b = batcher._make_batch(indices)
            s, le = (torch.from_numpy(a) for a in feed.plan(indices))
            t_pad = b.inputs.shape[1]
            if mode == "host":
                args = (t(b.inputs), t(b.labels), t(b.lengths))
                metrics.append(tr.train_step(st, *args, LR))
                metrics.append(tr.eval_step(st, *args))
            else:
                metrics.append(tr.train_step_gathered(
                    st, feed.inputs_tbl, feed.labels_tbl, s, le, LR, t_pad,
                    1, 1))
                metrics.append(tr.eval_step_gathered(
                    st, feed.inputs_tbl, feed.labels_tbl, s, le, t_pad, 1,
                    1))
        runs[mode] = ([{k: float(v) for k, v in m.items()} for m in metrics],
                      flatten_tree(checkpoints.state_tree(st)))
    assert runs["gathered"][0] == runs["host"][0]
    assert any("batch_stats" in k for k in runs["host"][1])
    for k, v in runs["host"][1].items():
        np.testing.assert_array_equal(runs["gathered"][1][k], v, err_msg=k)


def test_gan_rnn_refuses_bnlstm_as_jax_fails():
    """--trainer=gan_rnn --g_type=bnlstm: the JAX GanTrainer applies G
    with its params alone, so init succeeds and the first step raises
    flax's ScopeCollectionNotFound on cell_0's batch_stats; the port
    refuses the generator at construction, saying so."""
    import flax.errors
    jg = JaxBnGen(output_dim=OUT, cell_size=U, num_projection=P,
                  num_layers=LAYERS)
    jtr = JaxGanTrainer(jg, JaxLstmD(), output_dim=OUT, input_dim=IN)
    x, y = inputs()
    s0 = jtr.init_state(jax.random.PRNGKey(0), jnp.asarray(x),
                        jnp.asarray(LENS))
    hp = {"g_lr": 1e-3, "d_lr": 1e-3, "mse_lambda": 1.0,
          "disc_noise_std": 0.0, "d_real": 1.0, "d_fake": 0.0}
    with pytest.raises(flax.errors.ScopeCollectionNotFound,
                       match="input_mean"):
        jtr._train_step_impl(s0, jnp.asarray(x), jnp.asarray(y),
                             jnp.asarray(LENS), hp, jax.random.PRNGKey(1))
    with pytest.raises(ValueError, match="bnlstm"):
        GanTrainer(BnLstmGenerator(IN, OUT, cell_size=U, num_projection=P),
                   get_discriminator("lstm", input_dim=OUT), output_dim=OUT,
                   input_dim=IN)


def test_state_tree_is_a_snapshot():
    """state_tree copies the tensors: CPU steps after it leave the tree
    (params, Adam moments, EMA, batch_stats) as it was."""
    g = BnLstmGenerator(IN, OUT, cell_size=U, num_projection=P, num_layers=1,
                        generator=torch.Generator().manual_seed(0))
    tr = MseTrainer(g, output_dim=OUT, max_grad_norm=15.0)
    st = tr.init_state()
    x, y = inputs()
    tr.train_step(st, t(x), t(y), t(LENS), LR)
    tree = flatten_tree(checkpoints.state_tree(st))
    kept = {k: np.array(v) for k, v in tree.items()}
    tr.train_step(st, t(x), t(y), t(LENS), LR)
    moved = flatten_tree(checkpoints.state_tree(st))
    for k, v in kept.items():
        np.testing.assert_array_equal(tree[k], v, err_msg=k)
    for k in ("net.params.cell_0.state_kernel", "net.ema.Dense_0.kernel",
              "net.opt_state.1.mu.cell_0.bias",
              "net.extra.batch_stats.cell_0.cell_mean"):
        assert not np.array_equal(moved[k], kept[k]), k
