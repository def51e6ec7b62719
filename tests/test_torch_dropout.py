"""Dropout in the port (``--keep_prob < 1``) against the JAX package.

torch cannot draw jax.random's masks, so the masks are injected: on the
JAX side ``flax.linen.intercept_methods`` replaces every ``nn.Dropout``
call with ``where(mask, x / keep_prob, 0)`` on a mask drawn from a seeded
numpy generator and recorded (nothing in ``rsrgan_tpu/`` changes); the
port replays the recorded masks, G's and D's from sources of their own,
through its ``masks`` argument. Then: forwards and gradients of
res_lstm_l, res_lstm_base, res_lstm_i, lstm and D; the train step with
dropout (res_lstm_l and lstm) against the JAX trainer's from one bridged
state; the masks' statistics; and the kernel route dropout takes.

f32; the JAX Pallas kernels in interpreter mode. Tolerances: forward
1e-5, gradients 2e-4 (the JAX ladder, tests/test_pallas_lstm.py); after a
train step, state 1e-5 (tests/test_torch_training.py).
"""

import flax.linen as nn
import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rsrgan_tpu.models.discriminators import LstmDiscriminator as JaxDisc
from rsrgan_tpu.models.recurrent import LstmGenerator as JaxLstmGen
from rsrgan_tpu.models.recurrent import ResLstmGenerator as JaxResGen
from rsrgan_tpu.training import GanTrainer as JaxTrainer
from rsrgan_tpu_torch.models import flatten_tree, load_flax_params
from rsrgan_tpu_torch.models.discriminators import LstmDiscriminator
from rsrgan_tpu_torch.models.recurrent import (LstmGenerator,
                                               ResLstmGenerator)
from rsrgan_tpu_torch.ops import lstm_seq as tls
from rsrgan_tpu_torch.ops import wavefront_stack as tws
from rsrgan_tpu_torch.ops.common import dropout
from rsrgan_tpu_torch.training import GanTrainer, checkpoints

torch.set_num_threads(1)

IN, OUT, GU, DU, LP = 9, 4, 13, 10, 7   # LP: LstmGenerator's projection
T, KEEP = 9, 0.8
FWD_TOL, GRAD_TOL, STATE_TOL = 1e-5, 2e-4, 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


class JaxMasks:
    """A flax method interceptor: each ``nn.Dropout`` call draws its keep
    mask from a seeded numpy generator (probability 1 - rate), records it
    under "G" or "D" by the module tree it sits in, and returns
    ``where(mask, x / keep_prob, 0)``, flax's own formula."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.drawn = {"G": [], "D": []}

    def __call__(self, next_fun, args, kwargs, context):
        if not (isinstance(context.module, nn.Dropout)
                and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        root = context.module
        while isinstance(root.parent, nn.Module):
            root = root.parent
        net = "D" if isinstance(root, JaxDisc) else "G"
        x = args[0]
        keep = 1.0 - context.module.rate
        mask = self.rng.random(x.shape) < keep
        self.drawn[net].append(mask)
        return jnp.where(mask, x / keep, jnp.zeros_like(x))


class Replay:
    """The port's mask source for recorded masks, in call order."""

    def __init__(self, masks):
        self.masks = list(masks)

    def __call__(self, shape):
        mask = self.masks.pop(0)
        assert mask.shape == shape, (mask.shape, shape)
        return torch.from_numpy(mask)


def lens_for(rows):
    return np.asarray([T - (i % T) for i in range(rows)], np.int32)


# ---------------------------------------------------------------------------
# the modules under given masks
# ---------------------------------------------------------------------------

def jax_module(kind):
    if kind == "lstm":
        return JaxLstmGen(output_dim=OUT, cell_size=GU, num_projection=LP,
                          keep_prob=KEEP, lstm_impl="scan")
    return JaxResGen(output_dim=OUT, variant=kind, cell_size=GU,
                     keep_prob=KEEP, lstm_impl="scan")


def port_module(kind, impl):
    if kind == "lstm":
        return LstmGenerator(IN, OUT, cell_size=GU, num_projection=LP,
                             keep_prob=KEEP, lstm_impl=impl)
    return ResLstmGenerator(IN, OUT, variant=kind, cell_size=GU,
                            keep_prob=KEEP, lstm_impl=impl)


def jax_forward_and_grads(module, x, lens, w, masks, *extra):
    """(output, grads of sum(out * w) by param tree and by input) of a
    flax module in train mode with the interceptor's masks."""
    with pltpu.force_tpu_interpret_mode():
        variables = module.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                jnp.asarray(lens))
        params = jax.tree.map(np.asarray, variables)
        rng = np.random.default_rng(1)   # non-zero biases among the rest
        params = jax.tree.map(
            lambda a: a + rng.normal(0, 0.05, a.shape).astype(np.float32),
            params)

        def loss(p, xx):
            y = module.apply(p, xx, jnp.asarray(lens), *extra, True,
                             rngs={"dropout": jax.random.PRNGKey(9)})
            return jnp.sum(y * w), y

        with nn.intercept_methods(masks):
            (_, y), (gp, gx) = jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    return params["params"], np.asarray(y), gp["params"], np.asarray(gx)


def assert_port_matches(net, params, y_j, gp, gx, x, lens, w, call):
    load_flax_params(net, params)
    xt = t(x).requires_grad_(True)
    y = call(net, xt, t(lens))
    np.testing.assert_allclose(y.detach().numpy(), y_j, atol=FWD_TOL)
    (y * t(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), gx, atol=GRAD_TOL)
    want = flatten_tree(jax.tree.map(np.asarray, gp))
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name],
                                   atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("kind", ["l", "base", "i", "lstm"])
@pytest.mark.parametrize("impl", ["wavefront", "scan"])
def test_generator_dropout_matches_jax(kind, impl):
    """Forward and gradients of G in train mode with the same masks: the
    port's kernel route (per layer, the kernels' twins here) and its
    eager cell, against the JAX scan module."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, T, IN)).astype(np.float32)
    lens = np.asarray([T, 6, 2], np.int32)
    width = LP if kind == "lstm" else IN
    w = rng.normal(size=(3, T, OUT)).astype(np.float32)
    masks = JaxMasks(3)
    params, y_j, gp, gx = jax_forward_and_grads(jax_module(kind), x, lens,
                                                w, masks)
    n_layers = {"i": 2, "lstm": 3}.get(kind, 4)
    assert [m.shape for m in masks.drawn["G"]] == [(3, T, width)] * n_layers
    replay = Replay(masks.drawn["G"])
    assert_port_matches(port_module(kind, impl), params, y_j, gp, gx, x,
                        lens, w,
                        lambda net, xt, lt: net(xt, lt, True, masks=replay))
    assert replay.masks == []


@pytest.mark.parametrize("rows", [16, 32, 64])
def test_discriminator_dropout_matches_jax(rows):
    """D in train mode with dropout after each of its two layers: per
    layer at every row count (64 rows too, where it would otherwise take
    the wavefront stack), the JAX module on its Pallas kernels."""
    rng = np.random.default_rng(rows)
    x = rng.normal(size=(rows, T, OUT)).astype(np.float32)
    lens = lens_for(rows)
    w = rng.normal(size=(rows, T, 1)).astype(np.float32)
    masks = JaxMasks(4)
    jd = JaxDisc(cell_size=DU, num_projection=OUT, keep_prob=0.7,
                 lstm_impl="wavefront")
    params, y_j, gp, gx = jax_forward_and_grads(jd, x, lens, w, masks, 0.0)
    assert len(masks.drawn["D"]) == 2 and not masks.drawn["G"]
    replay = Replay(masks.drawn["D"])
    d = LstmDiscriminator(input_dim=OUT, cell_size=DU, num_projection=OUT,
                          keep_prob=0.7, lstm_impl="wavefront")
    assert_port_matches(d, params, y_j, gp, gx, x, lens, w,
                        lambda net, xt, lt: net(xt, lt, 0.0, True,
                                                masks=replay))
    assert replay.masks == []


def test_eval_mode_has_no_dropout():
    """train=False: no masks drawn, none needed, and the same output as
    the module without dropout."""
    rng = np.random.default_rng(5)
    x = t(rng.normal(size=(2, T, IN)).astype(np.float32))
    lens = t(np.asarray([T, 4], np.int32))
    for kind in ("l", "lstm"):
        torch.manual_seed(0)
        net = port_module(kind, "wavefront")
        torch.manual_seed(0)
        plain = port_module(kind, "wavefront")
        plain.keep_prob = 1.0
        plain.load_state_dict(net.state_dict())
        np.testing.assert_array_equal(net(x, lens).numpy(),
                                      plain(x, lens).numpy())


def test_train_mode_dropout_without_mask_source_raises():
    net = port_module("l", "wavefront")
    x = torch.zeros((2, T, IN))
    with pytest.raises(ValueError, match="mask source"):
        net(x, None, True)
    with pytest.raises(ValueError, match="keep mask"):
        net(x, None, True, masks=lambda shape: torch.ones(shape))


# ---------------------------------------------------------------------------
# the masks' statistics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keep", [0.5, 0.8, 0.95])
def test_keep_share_within_five_sigma(keep):
    gen = torch.Generator().manual_seed(11)
    x = torch.ones((64, 100, 50))
    y = dropout(x, keep, gen)
    kept = y != 0
    n = x.numel()
    share = float(kept.float().mean())
    assert abs(share - keep) <= 5 * np.sqrt(keep * (1 - keep) / n)
    # what is kept is divided by keep_prob (flax's formula), the rest 0
    assert torch.equal(y[kept], torch.full_like(y[kept], 1.0) / keep)
    assert bool((y[~kept] == 0).all())


def test_same_seed_same_masks_successive_draws_differ():
    x = torch.randn((4, 30, 20), generator=torch.Generator().manual_seed(1))
    a = torch.Generator().manual_seed(7)
    b = torch.Generator().manual_seed(7)
    first, again = dropout(x, KEEP, a), dropout(x, KEEP, b)
    assert torch.equal(first, again)
    second = dropout(x, KEEP, a)
    assert not torch.equal(first != 0, second != 0)


def test_trainer_keeps_g_and_d_streams_apart():
    """seed_dropout: G's and D's generators are seeded apart, so their
    first masks differ; the same seed gives the same train step."""
    tr = port_trainer("l")
    tr.seed_dropout(5, "cpu")
    x = torch.ones((1000,))
    assert not torch.equal(dropout(x, KEEP, tr.g_masks),
                           dropout(x, KEEP, tr.d_masks))
    rng = np.random.default_rng(3)
    batch = (t(rng.normal(size=(4, T, IN)).astype(np.float32)),
             t(rng.normal(size=(4, T, OUT)).astype(np.float32)),
             t(np.asarray([T, 5, 3, 1], np.int32)))
    hp = {"g_lr": 1e-3, "d_lr": 1e-2, "mse_lambda": 1.0,
          "disc_noise_std": 0.0, "d_real": 1.0, "d_fake": 0.0}
    runs = []
    for _ in range(2):
        torch.manual_seed(0)
        tr = port_trainer("l")
        tr.seed_dropout(5, "cpu")
        st = tr.init_state()
        m1 = tr.train_step(st, *batch, hp)
        m2 = tr.train_step(st, *batch, hp)
        runs.append((float(m1["g_loss"]), float(m2["g_loss"])))
    assert runs[0] == runs[1]
    assert runs[0][0] != runs[0][1]


# ---------------------------------------------------------------------------
# the kernel route
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


@pytest.mark.parametrize("kind,layers", [("l", 4), ("base", 4),
                                         ("lstm", 3)])
def test_dropout_takes_the_per_layer_route(calls, kind, layers):
    """Train mode with dropout: K1 per layer forward, K2 per layer
    backward (B=3 < 32 rows), no wavefront; without dropout the
    wavefront's train mode; decode the wavefront either way."""
    rng = np.random.default_rng(6)
    x = t(rng.normal(size=(3, T, IN)).astype(np.float32))
    lens = t(np.asarray([T, 6, 0], np.int32))
    net = port_module(kind, "wavefront")
    out = net(x, lens, True, masks=torch.Generator().manual_seed(0))
    out.sum().backward()
    assert calls == ["lstm_fwd"] * layers + ["lstm_bwd"] * layers
    calls.clear()
    net.keep_prob = 1.0
    if kind == "lstm":
        net.StackedLstm_0.keep_prob = 1.0
    net(x, lens, True).sum().backward()
    assert calls == ["lstm_wavefront_fwd_train"] + ["lstm_bwd"] * layers
    calls.clear()
    net.keep_prob = KEEP
    if kind == "lstm":
        net.StackedLstm_0.keep_prob = KEEP
    net(x, lens)
    assert calls == ["lstm_wavefront_fwd"]


def test_discriminator_dropout_route_at_64_rows(calls):
    rng = np.random.default_rng(7)
    x = t(rng.normal(size=(64, T, OUT)).astype(np.float32))
    d = LstmDiscriminator(input_dim=OUT, cell_size=DU, num_projection=OUT,
                          keep_prob=KEEP, lstm_impl="wavefront")
    d(x, t(lens_for(64)), 0.0, True,
      masks=torch.Generator().manual_seed(1)).sum().backward()
    assert calls == ["lstm_fwd"] * 2 + ["lstm_bwd_acc"] * 2
    calls.clear()
    d(x, t(lens_for(64)), 0.0, False)
    assert calls == ["lstm_wavefront_fwd"]


# ---------------------------------------------------------------------------
# the train step with dropout, from one bridged state
# ---------------------------------------------------------------------------

B = 16


def jax_trainer(kind, keep=KEEP):
    if kind == "lstm":
        gen = JaxLstmGen(output_dim=OUT, cell_size=GU, num_projection=LP,
                         keep_prob=keep, lstm_impl="wavefront")
    else:
        gen = JaxResGen(output_dim=OUT, cell_size=GU, keep_prob=keep,
                        lstm_impl="wavefront")
    return JaxTrainer(gen, JaxDisc(cell_size=DU, num_projection=OUT,
                                   keep_prob=keep, lstm_impl="wavefront"),
                      output_dim=OUT, input_dim=IN, l2_scale=1e-3)


def port_trainer(kind, keep=KEEP):
    g = port_module(kind, "wavefront")
    g.keep_prob = keep
    if kind == "lstm":
        g.StackedLstm_0.keep_prob = keep
    d = LstmDiscriminator(input_dim=OUT, cell_size=DU, num_projection=OUT,
                          keep_prob=keep, lstm_impl="wavefront")
    return GanTrainer(g, d, output_dim=OUT, input_dim=IN, l2_scale=1e-3)


def assert_state_matches(st, jstate, atol):
    tree = checkpoints.state_tree(st)
    want = flax.serialization.to_state_dict(jax.tree.map(np.asarray,
                                                         jstate))
    got_flat, want_flat = flatten_tree(tree), flatten_tree(want)
    assert sorted(got_flat) == sorted(want_flat)
    for k in want_flat:
        np.testing.assert_allclose(np.asarray(got_flat[k], np.float64),
                                   np.asarray(want_flat[k], np.float64),
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("kind,keep", [("l", KEEP), ("lstm", KEEP),
                                       ("lstm", 1.0)])
def test_dropout_train_step_matches_jax(tmp_path, kind, keep):
    """One iteration (noise std 0) with keep_prob 0.8 in G and D: G's
    forward unshared (the D step's fake and each G step draw their own,
    with their own masks), D's masks from a source of their own; and
    lstm without dropout (the shared forward on the wavefront stack at
    P = LP, residual off). Every metric, and the whole GanState within
    1e-5; the port's checkpoint of it restores in flax and serializes
    back to the same bytes."""
    rng = np.random.default_rng(42)
    lens = np.asarray([T, T - 1, 5, T, 3, T, T - 2, 1, T, 4, T, 6, T, 2, T,
                       7], np.int32)
    x = rng.normal(size=(B, T, IN)).astype(np.float32)
    y = rng.normal(size=(B, T, OUT)).astype(np.float32)
    tr = jax_trainer(kind, keep)
    hp = {"g_lr": 3e-3, "d_lr": 1e-2, "mse_lambda": 1.0,
          "disc_noise_std": 0.0, "d_real": 1.0, "d_fake": 0.0}
    masks = JaxMasks(8)
    with pltpu.force_tpu_interpret_mode():
        s0 = tr.init_state(jax.random.PRNGKey(1), jnp.asarray(x),
                           jnp.asarray(lens))
        s0 = s0.replace(g=s0.g.replace(params=jax.tree.map(
            lambda a: a + 0.05, s0.g.params)))
        assert tr._share_g_forward() == (keep == 1.0)
        with nn.intercept_methods(masks):
            s1, m_want = tr._train_step_impl(
                s0, jnp.asarray(x), jnp.asarray(y), jnp.asarray(lens),
                {k: jnp.float32(v) for k, v in hp.items()},
                jax.random.PRNGKey(2))
    g_layers = 3 if kind == "lstm" else 4
    # G: the D step's fake and two G steps; D: 2B rows once, B rows twice
    assert len(masks.drawn["G"]) == (3 * g_layers if keep < 1 else 0)
    assert [m.shape[0] for m in masks.drawn["D"]] == (
        [2 * B] * 2 + [B] * 4 if keep < 1 else [])

    ptr = port_trainer(kind, keep)
    st = ptr.init_state()
    checkpoints.load_state_tree(st, flax.serialization.to_state_dict(
        jax.tree.map(np.asarray, s0)))
    assert ptr._share_g_forward() == (keep == 1.0)
    ptr.g_masks, ptr.d_masks = (Replay(masks.drawn["G"]),
                                Replay(masks.drawn["D"]))
    m = ptr.train_step(st, t(x), t(y), t(lens), hp)
    assert ptr.g_masks.masks == [] and ptr.d_masks.masks == []
    for k, v in m_want.items():
        np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert st.step == 1
    assert_state_matches(st, s1, atol=STATE_TOL)
    path = checkpoints.save_checkpoint(str(tmp_path), "GAN_RNN",
                                       checkpoints.state_tree(st), 1)
    with open(path, "rb") as f:
        port_bytes = f.read()
    restored = flax.serialization.from_bytes(s1, port_bytes)
    assert flax.serialization.to_bytes(restored) == port_bytes
