"""The port's training layer against the JAX package: losses, clipping,
Adam/SGD/RMSProp, EMA, schedules, LstmDiscriminator (both kernel
branches), one whole GanTrainer.train_step from a bridged state, the
full GanState checkpoint both ways, eval_step, the graph-fed d_step and
g_step, and the conditioned D (``_d_input``, a conditioned train_step).

f32 throughout; JAX Pallas kernels run in interpreter mode. Tolerances:
1e-5 for forwards and losses, 2e-4 for gradients (tests/test_pallas_lstm
.py); after a train step, params and optimizer moments 1e-5 (they move by
lr times O(1) updates from identical starting values).
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rsrgan_tpu.models.discriminators import (
    LstmDiscriminator as JaxDisc)
from rsrgan_tpu.models.recurrent import ResLstmGenerator as JaxGen
from rsrgan_tpu.training import GanTrainer as JaxTrainer
from rsrgan_tpu.training import checkpoints as jax_ckpt
from rsrgan_tpu.training import losses as jl
from rsrgan_tpu.training import schedules as js
from rsrgan_tpu.training import state as jst
from rsrgan_tpu_torch.models import flatten_tree, load_flax_params
from rsrgan_tpu_torch.models.discriminators import LstmDiscriminator
from rsrgan_tpu_torch.models.recurrent import ResLstmGenerator
from rsrgan_tpu_torch.training import GanTrainer, checkpoints, losses
from rsrgan_tpu_torch.training import schedules, state as tst

torch.set_num_threads(1)

IN, OUT, GU, DU = 9, 4, 13, 10   # G: 4 x LSTM(13, proj 9); D: LSTM(10, 4)
T = 9


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# losses, clipping, optimizers, EMA, schedules
# ---------------------------------------------------------------------------

def test_losses_match(rng):
    a, b = rng.normal(size=(3, T, 1)), rng.normal(size=(3, T, 1))
    g, y = rng.normal(size=(3, T, OUT)), rng.normal(size=(3, T, OUT))
    a, b, g, y = (x.astype(np.float32) for x in (a, b, g, y))
    for got, want in zip(losses.lsgan_d_losses(t(a), t(b), 0.9, 0.1),
                         jl.lsgan_d_losses(a, b, 0.9, 0.1)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(losses.lsgan_g_adv_loss(t(b), 0.9)),
                               float(jl.lsgan_g_adv_loss(b, 0.9)), rtol=1e-6)
    np.testing.assert_allclose(float(losses.g_mse_loss(t(g), t(y), OUT)),
                               float(jl.g_mse_loss(g, y, OUT)), rtol=1e-6)
    tree = {"a": {"kernel": rng.normal(size=(3, 4)).astype(np.float32),
                  "bias": rng.normal(size=4).astype(np.float32)},
            "Bias_free": {"w": rng.normal(size=5).astype(np.float32)}}
    got = losses.l2_loss_nonbias({k: t(v) for k, v in
                                  flatten_tree(tree).items()}, 1e-3)
    np.testing.assert_allclose(float(got),
                               float(jl.l2_loss_nonbias(tree, 1e-3)),
                               rtol=1e-6)
    assert float(losses.l2_loss_nonbias({"w": t(tree["a"]["kernel"])},
                                        0.0)) == 0.0


def test_l2_loss_at_scale_zero_lies_on_the_params_device():
    """--l2_scale=0 (the recipes' flag): the zero lies where the
    parameters do, so the CLI can stack it with the step's other metrics
    (on a card it lay on the CPU, and the first epoch's average raised)."""
    params = {"w": torch.zeros((3, 4), device="meta")}
    zero = losses.l2_loss_nonbias(params, 0.0)
    assert zero.device.type == "meta" and zero.shape == ()
    assert losses.l2_loss_nonbias(params, 1e-3).device.type == "meta"


@pytest.mark.parametrize("name", ["adam", "sgd", "rmsprop"])
@pytest.mark.parametrize("max_norm", [15.0, 0.5, None])
def test_optimizer_steps_match_optax(rng, name, max_norm):
    """Three steps of clip + transform + lr + EMA against the JAX
    NetState.apply_gradients, with optimizer state checked each step."""
    params = {"k": rng.normal(size=(4, 3)).astype(np.float32),
              "bias": rng.normal(size=3).astype(np.float32)}
    tx = jst.make_optimizer(name, max_norm)
    jstate = jst.NetState.create(params, tx)
    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(t(v)))
    ns = tst.NetState(module, name, max_norm)
    for step in range(3):
        grads = {k: (rng.normal(size=v.shape) * 3).astype(np.float32)
                 for k, v in params.items()}
        jstate = jstate.apply_gradients(grads, tx, 1e-2, 0.9)
        ns.apply_gradients({k: t(v) for k, v in grads.items()}, 1e-2, 0.9)
        for k in params:
            np.testing.assert_allclose(ns.params()[k].detach().numpy(),
                                       np.asarray(jstate.params[k]),
                                       atol=1e-6)
            np.testing.assert_allclose(ns.ema[k].numpy(),
                                       np.asarray(jstate.ema[k]), atol=1e-6)
        core = jstate.opt_state[1]
        if name == "adam":
            assert int(ns.opt_state["count"]) == int(core.count) == step + 1
            for field in ("mu", "nu"):
                for k in params:
                    np.testing.assert_allclose(
                        ns.opt_state[field][k].numpy(),
                        np.asarray(getattr(core, field)[k]), rtol=1e-6,
                        atol=1e-7)
        elif name == "rmsprop":
            for k in params:
                np.testing.assert_allclose(ns.opt_state["nu"][k].numpy(),
                                           np.asarray(core.nu[k]),
                                           rtol=1e-6)


def test_clip_by_norm_each_matches(rng):
    grads = {"a": rng.normal(size=(5, 5)).astype(np.float32) * 10,
             "b": rng.normal(size=3).astype(np.float32) * 1e-3}
    want, _ = jst.clip_by_norm_each(2.0).update(grads, optax.EmptyState())
    got = tst.clip_by_norm_each({k: t(v) for k, v in grads.items()}, 2.0)
    for k in grads:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6)


def test_schedules_match():
    for it in range(0, 12):
        for mult in (True, False):
            assert schedules.exponential_decay(it, 2, 10, 3e-4, mult) == \
                js.exponential_decay(it, 2, 10, 3e-4, mult)
    assert schedules.exponential_decay(3, 1, 10, 0.0) == 0.0
    ours, ref = schedules.ImprovementTracker(0.01), \
        js.ImprovementTracker(0.01)
    for it, loss in enumerate([5.0, 4.0, 4.5, 3.99, 3.98]):
        ours.add(loss)
        ref.add(loss)
        assert ours.check(it) == ref.check(it)
        assert ours.should_stop(it, 2) == ref.should_stop(it, 2)
        assert ours.rel_impr == ref.rel_impr


# ---------------------------------------------------------------------------
# the discriminator
# ---------------------------------------------------------------------------

def make_disc(impl, rows_tree):
    d = LstmDiscriminator(input_dim=OUT, cell_size=DU, num_projection=OUT,
                          lstm_impl=impl)
    load_flax_params(d, rows_tree)
    return d


@pytest.mark.parametrize("rows", [16, 32, 64])
@pytest.mark.parametrize("with_noise", [False, True])
def test_discriminator_matches_jax(rng, rows, with_noise):
    """16 rows: K1 + K2; 32 rows: K1 + K3; 64 rows: the wavefront stack.
    Injected noise: the JAX module's own draws, handed to the port."""
    x = rng.normal(size=(rows, T, OUT)).astype(np.float32)
    lens = np.asarray([T - (i % T) for i in range(rows)], np.int32)
    w = rng.normal(size=(rows, T, 1)).astype(np.float32)
    jd = JaxDisc(cell_size=DU, num_projection=OUT, lstm_impl="wavefront")
    key = jax.random.PRNGKey(3)
    rngs = {"noise": key} if with_noise else None
    with pltpu.force_tpu_interpret_mode():
        variables = jd.init(jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(lens))

        def loss(p, xx):
            y = jd.apply(p, xx, jnp.asarray(lens), 0.3, True, rngs=rngs)
            return jnp.sum(y * w), y

        (_, y_j), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(variables, jnp.asarray(x))
    noise = None
    if with_noise:  # the key the module's make_rng("noise") derives
        nkey = jd.apply(variables, rngs=rngs,
                        method=lambda m: m.make_rng("noise"))
        noise = t(jax.random.normal(nkey, x.shape, jnp.float32))
    d = make_disc("wavefront", jax.tree.map(np.asarray,
                                            variables["params"]))
    xt = t(x).requires_grad_(True)
    y = d(xt, t(lens), 0.3, True, noise)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               atol=1e-5)
    (y * t(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=2e-4)
    want = flatten_tree(jax.tree.map(np.asarray, gp["params"]))
    for name, p in d.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], atol=2e-4,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the train step, the checkpoint, eval
# ---------------------------------------------------------------------------

B = 16


def jax_trainer(**kw):
    return JaxTrainer(JaxGen(output_dim=OUT, cell_size=GU,
                             lstm_impl="wavefront"),
                      JaxDisc(cell_size=DU, num_projection=OUT,
                              lstm_impl="wavefront"),
                      output_dim=OUT, input_dim=IN, l2_scale=1e-3, **kw)


def port_trainer(impl="wavefront", **kw):
    g = ResLstmGenerator(IN, OUT, variant="l", cell_size=GU, lstm_impl=impl)
    d = LstmDiscriminator(input_dim=OUT, cell_size=DU, num_projection=OUT,
                          lstm_impl=impl)
    return GanTrainer(g, d, output_dim=OUT, input_dim=IN, l2_scale=1e-3,
                      **kw)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(42)
    lens = np.asarray([T, T - 1, 5, T, 3, T, T - 2, 1, T, 4, T, 6, T, 2, T,
                       7], np.int32)
    return (rng.normal(size=(B, T, IN)).astype(np.float32),
            rng.normal(size=(B, T, OUT)).astype(np.float32), lens)


@pytest.fixture(scope="module")
def jax_step(batch):
    """A JAX GanState, and that state after one _train_step_impl (noise
    std 0), with the step's metrics."""
    x, y, lens = batch
    tr = jax_trainer()
    hp = {"g_lr": jnp.float32(3e-3), "d_lr": jnp.float32(1e-2),
          "mse_lambda": jnp.float32(1.0), "disc_noise_std": jnp.float32(0.0),
          "d_real": jnp.float32(1.0), "d_fake": jnp.float32(0.0)}
    with pltpu.force_tpu_interpret_mode():
        s0 = tr.init_state(jax.random.PRNGKey(1), jnp.asarray(x),
                           jnp.asarray(lens))
        # non-zero biases exercise the bias and forget-bias paths
        s0 = s0.replace(g=s0.g.replace(params=jax.tree.map(
            lambda a: a + 0.05, s0.g.params)))
        s1, m = tr._train_step_impl(s0, jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(lens), hp,
                                    jax.random.PRNGKey(2))
    hp = {k: float(v) for k, v in hp.items()}
    return s0, s1, {k: float(v) for k, v in m.items()}, hp


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


@pytest.mark.parametrize("impl", ["wavefront", "scan"])
def test_train_step_matches_jax(batch, jax_step, impl):
    """One iteration (1 D step at 2B = 32 rows: K1 + K3; 2 G steps with
    the shared G forward: wavefront + K2, D head at 16 rows: K1 + K2) from
    one bridged state: G and D params, EMA, Adam count/mu/nu, step and
    every metric."""
    s0, s1, m_want, hp = jax_step
    x, y, lens = batch
    tr, st = bridged_impl(s0, impl)
    assert tr._share_g_forward()
    m = tr.train_step(st, t(x), t(y), t(lens), hp)
    assert st.step == 1
    for k, v in m_want.items():
        np.testing.assert_allclose(float(m[k]), v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert_state_matches(st, s1, atol=1e-5)


def bridged_impl(s0, impl):
    tr = port_trainer(impl)
    st = tr.init_state()
    checkpoints.load_state_tree(st, flax.serialization.to_state_dict(
        jax.tree.map(np.asarray, s0)))
    return tr, st


def test_unshared_g_forward_matches(batch, jax_step, monkeypatch):
    """The unshared path (G recomputed for the D step and each G step, as
    for a G with dropout) gives the same step."""
    s0, s1, m_want, hp = jax_step
    x, y, lens = batch
    tr, st = bridged_impl(s0, "wavefront")
    monkeypatch.setattr(tr, "_share_g_forward", lambda: False)
    m = tr.train_step(st, t(x), t(y), t(lens), hp)
    np.testing.assert_allclose(float(m["g_loss"]), m_want["g_loss"],
                               rtol=1e-5)
    assert_state_matches(st, s1, atol=1e-5)


def test_eval_step_matches_jax(batch, jax_step):
    s0, _, _, hp = jax_step
    x, y, lens = batch
    tr = jax_trainer()
    jhp = {k: jnp.float32(v) for k, v in hp.items()}
    with pltpu.force_tpu_interpret_mode():
        want = tr._eval_step_impl(s0, jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(lens), jhp,
                                  jax.random.PRNGKey(4))
    ptr, st = bridged_impl(s0, "wavefront")
    got = ptr.eval_step(st, t(x), t(y), t(lens), hp)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_gan_state_checkpoint_round_trip(tmp_path, jax_step):
    """JAX-written GanState -> port -> bytes equal to flax to_bytes; and
    the port's state after its own step -> JAX from_bytes -> to_bytes
    equal to the port's bytes."""
    _, s1, _, _ = jax_step
    jpath = jax_ckpt.save_checkpoint(str(tmp_path / "jax"), "GAN_RNN", s1, 1)
    with open(jpath, "rb") as f:
        jax_bytes = f.read()
    tr, st = bridged_impl(s1, "wavefront")
    ppath = checkpoints.save_checkpoint(str(tmp_path / "port"), "GAN_RNN",
                                        checkpoints.state_tree(st), 1)
    with open(ppath, "rb") as f:
        assert f.read() == jax_bytes
    # the port resumes what it wrote
    st2 = tr.init_state()
    assert checkpoints.load_checkpoint(str(tmp_path / "port"), "GAN_RNN",
                                       st2) == ppath
    assert st2.step == 1 and int(st2.g.opt_state["count"]) == 2  # 2 G steps
    # port-written -> JAX restores it and writes the same bytes
    with open(ppath, "rb") as f:
        port_bytes = f.read()
    restored = flax.serialization.from_bytes(s1, port_bytes)
    assert flax.serialization.to_bytes(restored) == port_bytes


# ---------------------------------------------------------------------------
# the graph-fed steps and the conditioned D
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", ["d_step", "g_step"])
def test_graph_fed_step_matches_jax(batch, jax_step, step):
    """One d_step (G forward in train mode, detached; D at 2B = 32 rows:
    K1 + K3) or g_step (wavefront + K2, D head at 16 rows: K1 + K2) from
    one bridged state: the whole state within 1e-5 (G's Adam first step
    included, as in test_train_step_matches_jax), the step count, and
    the step's metrics."""
    s0, _, _, hp = jax_step
    x, y, lens = batch
    tr = jax_trainer()
    jhp = {k: jnp.float32(v) for k, v in hp.items()}
    with pltpu.force_tpu_interpret_mode():
        s1, m_want = getattr(JaxTrainer, step).__wrapped__(
            tr, s0, jnp.asarray(x), jnp.asarray(y), jnp.asarray(lens), jhp,
            jax.random.PRNGKey(5))
    ptr, st = bridged_impl(s0, "wavefront")
    m = getattr(ptr, step)(st, t(x), t(y), t(lens), hp)
    assert sorted(m) == sorted(m_want)
    for k, v in m_want.items():
        np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert st.step == int(s1.step) == (1 if step == "g_step" else 0)
    assert_state_matches(st, s1, atol=1e-5)


@pytest.mark.parametrize("left,right", [(0, 0), (2, 1)])
def test_d_input_matches_jax(rng, left, right):
    """D's input: the target alone, or conditioned, the center frame of
    the spliced input (at input_dim * left_context) beside it."""
    x = rng.normal(size=(3, T, IN * (left + 1 + right))).astype(np.float32)
    y = rng.normal(size=(3, T, OUT)).astype(np.float32)
    for cond in (False, True):
        want = jax_trainer(d_conditioned=cond,
                           left_context=left)._d_input(jnp.asarray(x),
                                                       jnp.asarray(y))
        got = port_trainer(d_conditioned=cond,
                           left_context=left)._d_input(t(x), t(y))
        assert got.shape[-1] == OUT + (IN if cond else 0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_d_conditioned_train_step_matches_jax(batch):
    """One conditioned iteration (D on concat(center frame, target), its
    first layer 13 inputs wide, so the single-layer kernels at every row
    count) on a spliced input (left = right = 1) from one bridged state:
    the whole state within 1e-5 and every metric."""
    _, y, lens = batch
    rng = np.random.default_rng(43)
    x = rng.normal(size=(B, T, 3 * IN)).astype(np.float32)
    tr = JaxTrainer(JaxGen(output_dim=OUT, cell_size=GU,
                           lstm_impl="wavefront"),
                    JaxDisc(cell_size=DU, num_projection=OUT,
                            lstm_impl="wavefront"),
                    output_dim=OUT, input_dim=IN, left_context=1,
                    l2_scale=1e-3, d_conditioned=True)
    hp = {"g_lr": 3e-3, "d_lr": 1e-2, "mse_lambda": 1.0,
          "disc_noise_std": 0.0, "d_real": 1.0, "d_fake": 0.0}
    with pltpu.force_tpu_interpret_mode():
        s0 = tr.init_state(jax.random.PRNGKey(1), jnp.asarray(x),
                           jnp.asarray(lens))
        s0 = s0.replace(g=s0.g.replace(params=jax.tree.map(
            lambda a: a + 0.05, s0.g.params)))
        s1, m_want = tr._train_step_impl(
            s0, jnp.asarray(x), jnp.asarray(y), jnp.asarray(lens),
            {k: jnp.float32(v) for k, v in hp.items()},
            jax.random.PRNGKey(2))
    g = ResLstmGenerator(3 * IN, OUT, variant="l", cell_size=GU,
                         lstm_impl="wavefront")
    d = LstmDiscriminator(input_dim=IN + OUT, cell_size=DU,
                          num_projection=OUT, lstm_impl="wavefront")
    ptr = GanTrainer(g, d, output_dim=OUT, input_dim=IN, left_context=1,
                     l2_scale=1e-3, d_conditioned=True)
    st = ptr.init_state()
    checkpoints.load_state_tree(st, flax.serialization.to_state_dict(
        jax.tree.map(np.asarray, s0)))
    m = ptr.train_step(st, t(x), t(y), t(lens), hp)
    for k, v in m_want.items():
        np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert_state_matches(st, s1, atol=1e-5)
