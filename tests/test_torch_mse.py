"""The port's MSE trainer and frame LSGAN against the JAX package: one
``MseTrainer.train_step`` from a bridged state in sequence mode
(res_lstm_l, 4 narrow layers, on the kernel path's twins and on the eager
cell) and in frame mode (DNN with BatchNorm, R-CED with and without, CNN):
the loss, every gradient, the post-step params, Adam moments, EMA and
batch_stats; ``eval_step``; the gathered steps against the host batch;
the ``MseState`` checkpoint byte-equal to flax's (``extra`` None and
``batch_stats``); one frame-mode ``GanTrainer.train_step`` (conditioned
DNN-D) against JAX's ``frame_mode=True`` step; the kernels the G-only
step reaches at B=16 and B=32.

f32; JAX Pallas kernels in interpreter mode. Tolerances: forwards and
losses 1e-5, gradients 2e-4, post-step state 1e-5, each at unit scale
(times max(1, max |reference|) per tensor: a conv kernel's gradient, a
sum over every pixel of the batch, reaches thousands, and Adam's second
moments tens, where 1e-5 is a few float32 ulps).
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rsrgan_tpu.models.discriminators import DnnDiscriminator as JaxDnnD
from rsrgan_tpu.models.feedforward import (CnnGenerator as JaxCnn,
                                           DnnGenerator as JaxDnn,
                                           RcedGenerator as JaxRced)
from rsrgan_tpu.models.recurrent import ResLstmGenerator as JaxResGen
from rsrgan_tpu.training import GanTrainer as JaxGanTrainer
from rsrgan_tpu.training import MseTrainer as JaxMseTrainer
from rsrgan_tpu.training import checkpoints as jax_ckpt
from rsrgan_tpu_torch.data import SequenceBatcher, StoreWriter, UtteranceStore
from rsrgan_tpu_torch.data import device_feed as pfeed
from rsrgan_tpu_torch.models import flatten_tree
from rsrgan_tpu_torch.models.discriminators import DnnDiscriminator
from rsrgan_tpu_torch.models.feedforward import (CnnGenerator, DnnGenerator,
                                                 RcedGenerator)
from rsrgan_tpu_torch.models.recurrent import ResLstmGenerator
from rsrgan_tpu_torch.ops import lstm_seq as tls
from rsrgan_tpu_torch.ops import wavefront_stack as tws
from rsrgan_tpu_torch.training import (GanTrainer, MseTrainer, checkpoints)

torch.set_num_threads(2)

IN, OUT, GU, T = 9, 4, 13, 9     # G: 4 x LSTM(13, proj 9)
SPLICE_LR = (2, 2)               # frame models: splice 5
B_SEQ, B_FRAME = 16, 24
CPU = torch.device("cpu")


def t(a):
    return torch.from_numpy(np.array(a))


def seq_lengths(rows):
    return np.asarray([T - (i * 5) % T for i in range(rows)], np.int32)


def models(kind, impl="wavefront"):
    """(JAX generator, port generator, sequence_mode, input width)."""
    splice = SPLICE_LR[0] + 1 + SPLICE_LR[1]
    if kind == "seq":
        return (JaxResGen(output_dim=OUT, cell_size=GU, lstm_impl="wavefront"),
                ResLstmGenerator(IN, OUT, variant="l", cell_size=GU,
                                 lstm_impl=impl), True, IN)
    if kind == "dnn_bn":
        return (JaxDnn(output_dim=OUT, units=8, hidden_layers=2,
                       batch_norm=True),
                DnnGenerator(IN * splice, OUT, units=8, hidden_layers=2,
                             batch_norm=True), False, IN * splice)
    if kind.startswith("rced"):
        bn = kind.endswith("_bn")
        kw = dict(filters_num=(3, 5, 2), filters_width=(3, 4, 5),
                  batch_norm=bn)
        s = 4 if bn else splice   # the even splice with BN
        return (JaxRced(output_dim=OUT, input_dim=IN, splice=s, **kw),
                RcedGenerator(IN, s, OUT, **kw), False, IN * s)
    return (JaxCnn(output_dim=OUT, input_dim=IN, splice=splice,
                   filters_num=(3, 2), filters_width=3),
            CnnGenerator(IN, splice, OUT, filters_num=(3, 2),
                         filters_width=3), False, IN * splice)


def batch(kind, rows=None, seed=42):
    rng = np.random.default_rng(seed)
    _, _, seq, width = models(kind)
    if seq:
        rows = rows or B_SEQ
        return (rng.normal(size=(rows, T, width)).astype(np.float32),
                rng.normal(size=(rows, T, OUT)).astype(np.float32),
                seq_lengths(rows))
    rows = rows or B_FRAME
    return (rng.normal(size=(rows, width)).astype(np.float32),
            rng.normal(size=(rows, OUT)).astype(np.float32), None)


def jax_state(kind, x, lens):
    """A JAX trainer and an MseState with its params and BatchNorm
    statistics moved off their initial values, and Adam's moments as
    after three earlier steps. (A bias ahead of a BatchNorm has a zero
    gradient but for rounding; from zero moments Adam's first step would
    move it by +-lr on the sign of that rounding.)"""
    jg, _, seq, _ = models(kind)
    tr = JaxMseTrainer(jg, output_dim=OUT, l2_scale=1e-3,
                       max_grad_norm=15.0 if seq else None,
                       sequence_mode=seq)
    with pltpu.force_tpu_interpret_mode():
        s0 = tr.init_state(jax.random.PRNGKey(1), jnp.asarray(x),
                           None if lens is None else jnp.asarray(lens))
    s0 = s0.replace(net=s0.net.replace(params=jax.tree.map(
        lambda a: a + 0.05, s0.net.params)))
    if s0.net.extra is not None:
        s0 = s0.replace(net=s0.net.replace(extra=jax.tree.map(
            lambda a: a * 1.5 + 0.1, s0.net.extra)))
    rng = np.random.default_rng(11)
    clip, adam = s0.net.opt_state
    adam = adam._replace(
        count=jnp.int32(3),
        mu=jax.tree.map(lambda a: jnp.asarray(
            rng.normal(size=a.shape) * 1e-2, jnp.float32), adam.mu),
        nu=jax.tree.map(lambda a: jnp.asarray(
            rng.uniform(1e-5, 1e-4, size=a.shape), jnp.float32), adam.nu))
    s0 = s0.replace(net=s0.net.replace(opt_state=(clip, adam)))
    return tr, s0


def bridged(kind, s0, impl="wavefront"):
    _, pg, seq, _ = models(kind, impl)
    tr = MseTrainer(pg, output_dim=OUT, l2_scale=1e-3,
                    max_grad_norm=15.0 if seq else None, sequence_mode=seq)
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
        if want[k] is None:
            assert got[k] is None, k
            continue
        w = np.asarray(want[k], np.float64)
        np.testing.assert_allclose(np.asarray(got[k], np.float64), w,
                                   atol=atol * max(1.0, np.abs(w).max()),
                                   err_msg=k)


LR = 3e-3
STEP_CASES = [("seq", "wavefront"), ("seq", "scan"), ("dnn_bn", None),
              ("rced", None), ("rced_bn", None), ("cnn", None)]


@pytest.mark.parametrize("kind,impl", STEP_CASES)
def test_train_step_matches_jax(kind, impl):
    """One step from one bridged state: the three losses, every gradient
    (before clipping), and the whole MseState after the step (params,
    Adam count/mu/nu, EMA, batch_stats, step)."""
    x, y, lens = batch(kind)
    tr, s0 = jax_state(kind, x, lens)
    jl = None if lens is None else jnp.asarray(lens)
    # the frame models' steps jitted (faster on the CPU than op by op)
    jit = (lambda f: f) if kind == "seq" else jax.jit
    with pltpu.force_tpu_interpret_mode():
        (_, (m_want, _)), g_want = jit(jax.value_and_grad(
            tr._loss_fn, has_aux=True))(s0.net.params, s0.net.extra,
                                        jnp.asarray(x), jnp.asarray(y), jl,
                                        None)
        s1, _ = jit(tr._train_step_impl)(
            s0, jnp.asarray(x), jnp.asarray(y), jl, jnp.float32(LR),
            jax.random.PRNGKey(2))
    ptr, st = bridged(kind, s0, impl or "wavefront")
    ptr.grad_log = []
    m = ptr.train_step(st, t(x), t(y), None if lens is None else t(lens),
                       LR)
    for k, v in m_want.items():
        np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    want = flatten_tree(jax.tree.map(np.asarray, g_want))
    (grads,) = ptr.grad_log
    assert sorted(grads) == sorted(want)
    for k, g in grads.items():
        np.testing.assert_allclose(
            g.numpy(), want[k], atol=2e-4 * max(1.0, np.abs(want[k]).max()),
            err_msg=k)
    assert st.step == int(s1.step) == 1
    assert_state_matches(st, s1, atol=1e-5)
    if s1.net.extra is not None:   # the step moved the running statistics
        assert not np.allclose(
            jax.tree.leaves(s1.net.extra)[0],
            jax.tree.leaves(s0.net.extra)[0])


@pytest.mark.parametrize("kind", ["seq", "dnn_bn"])
def test_eval_and_infer_match_jax(kind):
    """eval_step (G in eval mode: BatchNorm on its running statistics, no
    L2) and infer_step on a bridged state; eval changes no state."""
    x, y, lens = batch(kind, seed=7)
    tr, s0 = jax_state(kind, x, lens)
    jl = None if lens is None else jnp.asarray(lens)
    with pltpu.force_tpu_interpret_mode():
        want = tr._eval_step_impl(s0, jnp.asarray(x), jnp.asarray(y), jl)
        out = tr.infer_with_params(s0.net.params, s0.net.extra,
                                   jnp.asarray(x), jl)
    ptr, st = bridged(kind, s0)
    before = checkpoints.state_tree(st)
    pl = None if lens is None else t(lens)
    got = ptr.eval_step(st, t(x), t(y), pl)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(ptr.infer_step(st, t(x), pl).numpy(),
                               np.asarray(out), atol=1e-5)
    after = flatten_tree(checkpoints.state_tree(st))
    for k, v in flatten_tree(before).items():
        np.testing.assert_array_equal(after[k], v, err_msg=k)


def test_gathered_steps_equal_host_batch(tmp_path):
    """train_step_gathered and eval_step_gathered on plans through the
    resident tables (a spliced input, left 1, right 1) against
    train_step and eval_step on the host batcher's batches: the same
    metrics and the same state, bit for bit."""
    rng = np.random.default_rng(3)
    path = str(tmp_path / "tr.rtu")
    with StoreWriter(path) as w:
        for i, n in enumerate((5, 9, 7, 3, 8, 6, 9, 4)):
            w.add(f"u{i}", rng.normal(size=(n, 3)).astype(np.float32),
                  rng.normal(size=(n, OUT)).astype(np.float32))
    store = UtteranceStore([path])
    feed = pfeed.DeviceFeed(store, device=CPU)
    batcher = SequenceBatcher(store, 4, 1, 1, shuffle=True, seed=2)
    plans = list(batcher.iter_index_batches())
    runs = {}
    for mode in ("host", "gathered"):
        g = ResLstmGenerator(9, OUT, variant="l", cell_size=GU,
                             generator=torch.Generator().manual_seed(0))
        tr = MseTrainer(g, output_dim=OUT, l2_scale=1e-3, max_grad_norm=15.0)
        st = tr.init_state()
        metrics = []
        for indices in plans + plans[:1]:
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
    for k, v in runs["host"][1].items():
        np.testing.assert_array_equal(runs["gathered"][1][k], v, err_msg=k)


@pytest.mark.parametrize("kind", ["seq", "dnn_bn"])
def test_mse_state_checkpoint_bytes_equal_flax(tmp_path, kind):
    """JAX MseState after a step (extra None for res_lstm_l, batch_stats
    for the DNN with BatchNorm) -> the port -> bytes equal to flax's
    to_bytes; the port's checkpoint resumes in the port, and flax restores
    it and writes the same bytes; decode reads its params and
    batch_stats."""
    x, y, lens = batch(kind)
    tr, s0 = jax_state(kind, x, lens)
    with pltpu.force_tpu_interpret_mode():
        s1, _ = tr._train_step_impl(
            s0, jnp.asarray(x), jnp.asarray(y),
            None if lens is None else jnp.asarray(lens), jnp.float32(LR),
            jax.random.PRNGKey(2))
    assert (s1.net.extra is None) == (kind == "seq")
    name = "RNNTrainer" if kind == "seq" else "DNNTrainer"
    jpath = jax_ckpt.save_checkpoint(str(tmp_path / "jax"), name, s1, 1)
    with open(jpath, "rb") as f:
        jax_bytes = f.read()
    ptr, st = bridged(kind, s1)
    ppath = checkpoints.save_checkpoint(str(tmp_path / "port"), name,
                                        checkpoints.state_tree(st), 1)
    with open(ppath, "rb") as f:
        port_bytes = f.read()
    assert port_bytes == jax_bytes
    st2 = ptr.init_state()
    assert checkpoints.load_checkpoint(str(tmp_path / "port"), name,
                                       st2) == ppath
    assert st2.step == 1 and int(st2.net.opt_state["count"]) == 4
    assert checkpoints.msgpack_serialize(checkpoints.state_tree(st2)) \
        == jax_bytes
    restored = flax.serialization.from_bytes(s1, port_bytes)
    assert flax.serialization.to_bytes(restored) == port_bytes
    params, extra = checkpoints.load_generator_state(str(tmp_path / "port"),
                                                     name)
    assert (extra is None) == (kind == "seq")
    if extra is not None:
        for a, b in zip(jax.tree.leaves(extra),
                        jax.tree.leaves(s1.net.extra)):
            np.testing.assert_array_equal(a, np.asarray(b))


# ---------------------------------------------------------------------------
# the frame LSGAN
# ---------------------------------------------------------------------------

LEFT = 2


def frame_gan_pair():
    kw = dict(output_dim=OUT, input_dim=IN, left_context=LEFT,
              l2_scale=1e-3, max_grad_norm=None, g_optimizer="adam",
              d_optimizer="adam", d_conditioned=True, frame_mode=True)
    jtr = JaxGanTrainer(JaxDnn(output_dim=OUT, units=8, hidden_layers=2),
                        JaxDnnD(units=8, hidden_layers=2), **kw)
    width = IN * (LEFT + 1 + LEFT)
    ptr = GanTrainer(DnnGenerator(width, OUT, units=8, hidden_layers=2),
                     DnnDiscriminator(IN + OUT, units=8, hidden_layers=2),
                     **kw)
    return jtr, ptr, width


def test_frame_gan_train_step_matches_jax():
    """One frame-mode iteration (1 D step on the stacked real and fake
    rows, 2 G steps, the first sharing the G forward; D conditioned on the
    center input frame; Adam for both, no clipping) from one bridged
    state: every metric and the whole GanState within 1e-5; then eval."""
    jtr, ptr, width = frame_gan_pair()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B_FRAME, width)).astype(np.float32)
    y = rng.normal(size=(B_FRAME, OUT)).astype(np.float32)
    hp = {"g_lr": 3e-3, "d_lr": 1e-2, "mse_lambda": 1.0,
          "disc_noise_std": 0.0, "d_real": 1.0, "d_fake": 0.0}
    jhp = {k: jnp.float32(v) for k, v in hp.items()}
    s0 = jtr.init_state(jax.random.PRNGKey(1), jnp.asarray(x))
    s0 = s0.replace(g=s0.g.replace(params=jax.tree.map(
        lambda a: a + 0.05, s0.g.params)))
    s1, m_want = jax.jit(jtr._train_step_impl)(
        s0, jnp.asarray(x), jnp.asarray(y), None, jhp,
        jax.random.PRNGKey(2))
    st = ptr.init_state()
    checkpoints.load_state_tree(st, flax.serialization.to_state_dict(
        jax.tree.map(np.asarray, s0)))
    assert ptr._share_g_forward()
    m = ptr.train_step(st, t(x), t(y), None, hp)
    for k, v in m_want.items():
        np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert_state_matches(st, s1, atol=1e-5)
    want = jtr._eval_step_impl(s1, jnp.asarray(x), jnp.asarray(y), None,
                               jhp, jax.random.PRNGKey(0))
    got = ptr.eval_step(st, t(x), t(y), None, hp)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_frame_gan_refuses_batch_norm_as_jax_fails():
    """--trainer=gan_dnn --batch_norm: the JAX GanTrainer keeps no
    batch_stats, so its step fails; the port refuses the generator at
    construction with an error that says so."""
    import flax.errors
    x = jnp.ones((4, IN))
    jtr = JaxGanTrainer(JaxDnn(output_dim=OUT, units=8, batch_norm=True),
                        JaxDnnD(units=8), output_dim=OUT, input_dim=IN,
                        max_grad_norm=None, d_optimizer="adam",
                        d_conditioned=True, frame_mode=True)
    s0 = jtr.init_state(jax.random.PRNGKey(0), x)
    hp = {"g_lr": 1e-3, "d_lr": 1e-3, "mse_lambda": 1.0,
          "disc_noise_std": 0.0, "d_real": 1.0, "d_fake": 0.0}
    with pytest.raises(flax.errors.ScopeCollectionNotFound):
        jtr._train_step_impl(s0, x, jnp.ones((4, OUT)), None, hp,
                             jax.random.PRNGKey(1))
    with pytest.raises(ValueError, match="batch_stats"):
        GanTrainer(DnnGenerator(IN, OUT, units=8, batch_norm=True),
                   DnnDiscriminator(IN + OUT, units=8), output_dim=OUT,
                   input_dim=IN, frame_mode=True, d_conditioned=True)


# ---------------------------------------------------------------------------
# the kernels the G-only step reaches
# ---------------------------------------------------------------------------

@pytest.fixture
def calls(monkeypatch):
    """Names of the kernel wrappers called, in order (on the CPU each
    wrapper runs its twin; the route is what this records)."""
    seen = []
    for mod, name in ((tls, "lstm_fwd"), (tls, "lstm_bwd"),
                      (tls, "lstm_bwd_acc"), (tws, "lstm_wavefront_fwd"),
                      (tws, "lstm_wavefront_fwd_train")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k:
                            seen.append(_n) or _f(*a, **k))
    return seen


@pytest.mark.parametrize("rows,bwd", [(16, "lstm_bwd"), (31, "lstm_bwd"),
                                      (32, "lstm_bwd_acc"),
                                      (48, "lstm_bwd_acc")])
@pytest.mark.parametrize("keep", [1.0, 0.8])
def test_g_only_step_routes(calls, rows, bwd, keep):
    """The MSE step runs G alone: K4 in train mode once (K1 per layer
    with dropout), then one backward per layer, on K2 below 32 rows and
    on K3 (lstm_bwd_acc) from 32 rows; no D launch; eval and infer on
    K4's decode mode."""
    x, y, lens = batch("seq", rows=rows)
    g = ResLstmGenerator(IN, OUT, variant="l", cell_size=GU,
                         keep_prob=keep)
    tr = MseTrainer(g, output_dim=OUT, l2_scale=1e-3, max_grad_norm=15.0)
    tr.seed_dropout(0, CPU)
    st = tr.init_state()
    tr.train_step(st, t(x), t(y), t(lens), LR)
    fwd = (["lstm_wavefront_fwd_train"] if keep == 1.0
           else ["lstm_fwd"] * 4)
    assert calls == fwd + [bwd] * 4
    calls.clear()
    tr.eval_step(st, t(x), t(y), t(lens))
    tr.infer_step(st, t(x), t(lens))
    assert calls == ["lstm_wavefront_fwd"] * 2
