"""The port's SEGAN against the JAX package: virtual batch norm (a live
batch of another size than the init batch), the auto-encoder generator
(kwidth 5, 20 and 31 on odd and even widths, so that SAME padding splits
both ways and the decoder cuts its outputs to the skips; PReLU and the
bias flags), the wave generator at toy dilations, the discriminator, and
``SeganTrainer``: ``init_state``'s vbn_stats, ``train_step`` at 1/1 and
2/2 updates, ``eval_step`` and ``infer_step``, and the ``GanState``
checkpoint byte-equal to flax's in both directions.

JAX's normals are replaced by numpy's (``normals``): each
``jax.random.normal`` call of the JAX step draws from a seeded numpy
generator and records what it drew, and the port's step takes the same
arrays in the same order through its ``rand`` callable. The JAX functions
are jitted in fresh closures, so each is traced anew and its draws are
the constants of that trace. Sizes: ``tests/test_segan.py``'s toy ones
(ENC=(8, 16, 32), 64 -> 16). Tolerances: f32 forwards 1e-5, gradients
and the state after a step 2e-4, each at unit scale (times max(1, max
|reference|)).
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsrgan_tpu.models.segan import SeganAEGenerator as JaxAE
from rsrgan_tpu.models.segan import SeganDiscriminator as JaxD
from rsrgan_tpu.models.segan import SeganWaveGenerator as JaxWave
from rsrgan_tpu.models.segan import VirtualBatchNorm as JaxVBN
from rsrgan_tpu.training import checkpoints as jax_ckpt
from rsrgan_tpu.training.segan import SeganTrainer as JaxSeganTrainer
from rsrgan_tpu_torch.models import (collections_tree, flatten_tree,
                                     load_collections, load_flax_params,
                                     module_tree, unflatten_tree)
from rsrgan_tpu_torch.models.segan import (SeganAEGenerator,
                                           SeganDiscriminator,
                                           SeganWaveGenerator,
                                           VirtualBatchNorm)
from rsrgan_tpu_torch.training import SeganTrainer, checkpoints

torch.set_num_threads(2)

B, W_IN, W_OUT = 4, 64, 16
ENC = (8, 16, 32)


def t(a):
    return torch.from_numpy(np.array(a))


def assert_close(got, want, atol, what=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               atol=atol * max(1.0, np.abs(want).max()),
                               err_msg=what)


@pytest.fixture
def normals(monkeypatch):
    """Every ``jax.random.normal`` call draws from numpy instead and is
    recorded; ``normals.take`` hands the port the recorded arrays in the
    order JAX drew them."""

    class Normals(list):
        rng = np.random.default_rng(123)
        script: list = []   # arrays to hand JAX again, in order

        def draw(self, key, shape=(), dtype=jnp.float32):
            a = (self.script.pop(0) if self.script
                 else self.rng.normal(size=shape).astype(np.float32))
            assert a.shape == tuple(shape)
            self.append(a)
            return jnp.asarray(a, dtype)

        def take(self, shape):
            a = self.pop(0)
            assert a.shape == tuple(shape), (a.shape, shape)
            return torch.from_numpy(a)

    draws = Normals()
    monkeypatch.setattr(jax.random, "normal", draws.draw)
    return draws


def randomized(params, seed):
    """A flax params tree (or its shapes) with every leaf drawn anew
    (zero-initialised biases, PReLU slopes and VBN betas included), at the
    scale of its kind."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flatten_tree(params).items():
        scale = 0.2 if v.ndim < 2 else 1.0 / np.sqrt(np.prod(v.shape[:-1]))
        out[k] = (rng.normal(size=v.shape) * scale).astype(np.float32)
    return unflatten_tree(out)


def test_vbn_matches_flax():
    """Reference statistics from a 6-row init batch; a 3-row live batch
    blended 1/4 with them."""
    rng = np.random.default_rng(0)
    x0 = rng.normal(loc=2.0, size=(6, 9, 5)).astype(np.float32)
    x1 = rng.normal(loc=1.0, scale=2.0, size=(3, 9, 5)).astype(np.float32)
    jv = JaxVBN()
    v = jax.tree.map(np.asarray,
                     jax.jit(jv.init)(jax.random.PRNGKey(0), x0))
    v["params"] = randomized(v["params"], 1)
    pv = VirtualBatchNorm(5)
    load_flax_params(pv, v["params"])
    pv.capture = True
    assert_close(pv(t(x0).transpose(1, 2)).transpose(1, 2).detach(),
                 jv.apply(v, x0), 1e-5)
    pv.capture = False
    stats = collections_tree(pv)["vbn_stats"]
    for k in ("ref_mean", "ref_meansq"):
        assert_close(stats[k], v["vbn_stats"][k], 1e-5, k)
    assert_close(pv(t(x1).transpose(1, 2)).transpose(1, 2).detach(),
                 jv.apply(v, x1), 1e-5)


AE_CASES = [  # (kwidth, W, prelu, bias_downconv, bias_deconv)
    (5, W_IN, False, False, False),
    (20, 50, True, True, True),     # even kernel; 25 -> 13 -> 7: cuts
    (31, 63, False, False, True),
    (20, 61, False, True, False),
]


@pytest.mark.parametrize("kwidth,width,prelu,bias_down,bias_de", AE_CASES)
def test_ae_generator_matches_jax(normals, kwidth, width, prelu, bias_down,
                                  bias_de):
    """Forward with a drawn z and with z = 0 (no z rng), the gradient of
    every parameter, and the tree both ways."""
    rng = np.random.default_rng(kwidth + width)
    x = rng.normal(size=(B, width)).astype(np.float32)
    kw = dict(enc_depths=ENC, kwidth=kwidth, do_prelu=prelu,
              bias_downconv=bias_down, bias_deconv=bias_de)
    jg = JaxAE(units=W_OUT, **kw)
    params = randomized(jax.eval_shape(jg.init, {
        "params": jax.random.PRNGKey(0), "z": jax.random.PRNGKey(1)},
        x)["params"], 2)
    normals.clear()
    pg = SeganAEGenerator(width, W_OUT, **kw)
    load_flax_params(pg, params)
    tree = module_tree(pg)
    assert sorted(flatten_tree(tree)) == sorted(flatten_tree(params))
    w = rng.normal(size=(B, W_OUT)).astype(np.float32)

    def loss(p):
        return jnp.sum(jg.apply({"params": p}, x,
                                rngs={"z": jax.random.PRNGKey(2)}) * w)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss))(params)
    assert len(normals) == 1
    got = pg(t(x), normals.take)
    assert_close(float((got * t(w)).sum().detach()), float(want_loss), 1e-5)
    got.mul(t(w)).sum().backward()
    want_grads = flatten_tree(jax.tree.map(np.asarray, want_grads))
    for k, p in pg.named_parameters():
        assert_close(p.grad.numpy(), want_grads[k], 2e-4, k)
    with torch.no_grad():
        assert_close(pg(t(x)), jg.apply({"params": params}, x), 1e-5)


@pytest.mark.parametrize("width", [20, 21])
def test_wave_generator_matches_jax(normals, width):
    """Toy dilations (1, 2, 4), 3 kernels, a 4-channel z; forward with a
    drawn z and with zeros, and the gradients."""
    rng = np.random.default_rng(width)
    x = rng.normal(size=(B, width)).astype(np.float32)
    kw = dict(dilations=(1, 2, 4), num_kernels=3, z_depth=4)
    jg = JaxWave(units=W_OUT, **kw)
    params = randomized(jax.eval_shape(jg.init, {
        "params": jax.random.PRNGKey(0), "z": jax.random.PRNGKey(1)},
        x)["params"], 3)
    normals.clear()
    pg = SeganWaveGenerator(width, W_OUT, **kw)
    load_flax_params(pg, params)
    w = rng.normal(size=(B, W_OUT)).astype(np.float32)

    def loss(p):
        return jnp.sum(jg.apply({"params": p}, x,
                                rngs={"z": jax.random.PRNGKey(2)}) * w)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss))(params)
    got = pg(t(x), normals.take)
    assert_close(float((got * t(w)).sum().detach()), float(want_loss), 1e-5)
    got.mul(t(w)).sum().backward()
    want_grads = flatten_tree(jax.tree.map(np.asarray, want_grads))
    assert sorted(want_grads) == sorted(dict(pg.named_parameters()))
    for k, p in pg.named_parameters():
        assert_close(p.grad.numpy(), want_grads[k], 2e-4, k)
    with torch.no_grad():
        assert_close(pg(t(x)), jg.apply({"params": params}, x), 1e-5)


def vbn_stats_of(jd, params, x):
    """flax's vbn_stats for D's ``params`` on the init batch x: an apply
    with the collection mutable and absent creates it as init does."""
    _, upd = jd.apply({"params": params}, x, mutable=["vbn_stats"])
    return jax.tree.map(np.asarray, upd["vbn_stats"])


@pytest.mark.parametrize("kwidth,width,bias", [(5, W_IN + W_OUT, True),
                                               (31, 81, False),
                                               (31, 1839, True)])
def test_discriminator_matches_jax(kwidth, width, bias):
    """The vbn_stats of an 8-row init batch (each VBN's from its own
    input), then a 3-row batch: logits and gradients."""
    rng = np.random.default_rng(kwidth + width)
    x0 = rng.normal(size=(8, width)).astype(np.float32)
    x1 = rng.normal(size=(3, width)).astype(np.float32)
    jd = JaxD(num_fmaps=ENC, kwidth=kwidth, bias_conv=bias)
    params = randomized(jax.eval_shape(jd.init, jax.random.PRNGKey(0),
                                       x0)["params"], 4)
    stats = vbn_stats_of(jd, params, x0)
    pd = SeganDiscriminator(width, num_fmaps=ENC, kwidth=kwidth,
                            bias_conv=bias)
    load_flax_params(pd, params)
    pd.init_vbn_stats(t(x0))
    got_stats = flatten_tree(collections_tree(pd)["vbn_stats"])
    want_stats = flatten_tree(stats)
    assert sorted(got_stats) == sorted(want_stats)
    for k in want_stats:
        assert_close(got_stats[k], want_stats[k], 1e-5, k)

    def loss(p):
        return jnp.sum(jd.apply({"params": p, "vbn_stats": stats}, x1))

    want, grads = jax.jit(jax.value_and_grad(loss))(params)
    got = pd(t(x1))
    assert got.shape == (3, 1)
    assert_close(float(got.sum()), float(want), 1e-5)
    got.sum().backward()
    grads = flatten_tree(jax.tree.map(np.asarray, grads))
    for k, p in pd.named_parameters():
        assert_close(p.grad.numpy(), grads[k], 2e-4, k)


# ---------------------------------------------------------------------------
# SeganTrainer
# ---------------------------------------------------------------------------

HP = {"g_lr": 5e-4, "d_lr": 1e-3, "l1_lambda": 3.0, "disc_noise_std": 0.3}


def trainer_pair(du, gu, prelu=False):
    kw = dict(enc_depths=ENC, kwidth=5, do_prelu=prelu, bias_deconv=True)
    jtr = JaxSeganTrainer(JaxAE(units=W_OUT, **kw),
                          JaxD(num_fmaps=ENC, kwidth=5),
                          disc_updates=du, gen_updates=gu)
    ptr = SeganTrainer(SeganAEGenerator(W_IN, W_OUT, **kw),
                       SeganDiscriminator(W_IN + W_OUT, num_fmaps=ENC,
                                          kwidth=5),
                       disc_updates=du, gen_updates=gu)
    return jtr, ptr


def batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, W_IN)).astype(np.float32),
            rng.normal(size=(B, W_OUT)).astype(np.float32))


def jax_state(jtr, x, seed=5):
    """A JAX GanState of ``init_state``'s structure (``jax.eval_shape``,
    nothing computed) with every leaf drawn: params, EMA a step behind,
    RMSProp's second moments as after earlier steps, and D's vbn_stats
    (mean squares above the squared means)."""
    shapes = jax.eval_shape(jtr.init_state, jax.random.PRNGKey(0),
                            jnp.asarray(x))
    rng = np.random.default_rng(seed)

    def net(ns, s):
        params = randomized(ns.params, s)
        nu = jax.tree.map(lambda a: rng.uniform(1e-4, 1e-3, a.shape).astype(
            np.float32), ns.opt_state[1].nu)
        extra = None
        if ns.extra is not None:
            extra = {"vbn_stats": {}}
            for name, leaf in ns.extra["vbn_stats"].items():
                mean = rng.normal(0, 0.3, leaf["ref_mean"].shape)
                extra["vbn_stats"][name] = {
                    "ref_mean": mean.astype(np.float32),
                    "ref_meansq": (mean ** 2 + rng.uniform(
                        0.5, 1.5, mean.shape)).astype(np.float32)}
        return ns.replace(params=params,
                          ema=jax.tree.map(lambda a: a * 0.9, params),
                          opt_state=(ns.opt_state[0],
                                     ns.opt_state[1]._replace(nu=nu)),
                          extra=extra)

    return jax.tree.map(jnp.asarray, shapes.replace(
        g=net(shapes.g, seed), d=net(shapes.d, seed + 1),
        step=np.zeros((), np.int32)))


def jit_step(method):
    """A JAX trainer's jitted step, jitted anew in a fresh closure (its own
    trace, and so its own draws)."""
    fn, trainer = method.__wrapped__, method.__self__
    return jax.jit(lambda *a: fn(trainer, *a))


def bridged(ptr, s0):
    st = ptr.init_state(torch.zeros(2, W_IN))
    checkpoints.load_state_tree(st, flax.serialization.to_state_dict(
        jax.tree.map(np.asarray, s0)))
    return st


def assert_state_matches(st, jstate, atol):
    got = flatten_tree(checkpoints.state_tree(st))
    want = flatten_tree(flax.serialization.to_state_dict(
        jax.tree.map(np.asarray, jstate)))
    assert sorted(got) == sorted(want)
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
            continue
        assert_close(got[k], want[k], atol, k)


def test_init_state_vbn_stats_match_jax():
    """init_state: D's reference statistics from concat(x, G(x) with
    z = 0), from the same weights as JAX's init."""
    jtr, ptr = trainer_pair(1, 1, prelu=True)
    x, _ = batch(0)
    s0 = jax.jit(jtr.init_state)(jax.random.PRNGKey(0), jnp.asarray(x))
    load_flax_params(ptr.generator, jax.tree.map(np.asarray, s0.g.params))
    load_flax_params(ptr.discriminator,
                     jax.tree.map(np.asarray, s0.d.params))
    st = ptr.init_state(t(x))
    assert st.g.extra() is None and list(st.d.extra()) == ["vbn_stats"]
    got = flatten_tree(st.d.extra())
    want = flatten_tree(jax.tree.map(np.asarray, s0.d.extra))
    assert sorted(got) == sorted(want)
    for k in want:
        assert_close(got[k], want[k], 1e-5, k)


@pytest.mark.parametrize("du,gu", [(1, 1), (2, 2)])
def test_train_step_matches_jax(normals, du, gu):
    """One train_step from one bridged state, with JAX's z and noise: the
    metrics, the first D update's gradients, and the whole GanState after
    the step (params, RMSProp moments, EMA, D's vbn_stats untouched,
    step)."""
    jtr, ptr = trainer_pair(du, gu)
    x, y = batch(1)
    s0 = jax_state(jtr, x)
    normals.clear()
    s1, m_want = jit_step(jtr.train_step)(s0, jnp.asarray(x), jnp.asarray(y),
                                          HP, jax.random.PRNGKey(7))
    assert len(normals) == 3 * du + 2 * gu
    draws = list(normals)
    st = bridged(ptr, s0)
    ptr.grad_log = []
    m = ptr.train_step(st, t(x), t(y), HP, normals.take)
    assert not normals
    for k, v in m_want.items():
        np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert [tag for tag, _ in ptr.grad_log] == ["d"] * du + ["g"] * gu
    # the first D update's gradients, from the step's first three draws
    normals.script[:] = draws[:3]

    @jax.jit
    def d_grads(s, x, y):
        g_out = jtr._g_apply(s.g.params, x, jax.random.PRNGKey(0))
        return jax.grad(jtr._d_loss, has_aux=True)(
            s.d.params, s.d.extra, g_out, x, y, HP,
            (jax.random.PRNGKey(1), jax.random.PRNGKey(2)))[0]

    grads = d_grads(s0, jnp.asarray(x), jnp.asarray(y))
    assert not normals.script
    want = flatten_tree(jax.tree.map(np.asarray, grads))
    got = ptr.grad_log[0][1]
    assert sorted(got) == sorted(want)
    for k in want:
        assert_close(got[k].numpy(), want[k], 2e-4, k)
    assert st.step == int(s1.step) == 1
    assert_state_matches(st, s1, 2e-4)


def test_eval_and_infer_match_jax(normals):
    """eval_step draws z and three noises (D's real and fake rows, then
    the fake rows again for G's loss); infer_step runs G with z = 0; no
    state changes."""
    jtr, ptr = trainer_pair(1, 1)
    x, y = batch(2)
    s0 = jax_state(jtr, x, seed=9)
    normals.clear()
    want = jit_step(jtr.eval_step)(s0, jnp.asarray(x), jnp.asarray(y), HP,
                                   jax.random.PRNGKey(3))
    out = jit_step(jtr.infer_step)(s0.g.params, jnp.asarray(x))
    assert len(normals) == 4
    st = bridged(ptr, s0)
    before = flatten_tree(checkpoints.state_tree(st))
    got = ptr.eval_step(st, t(x), t(y), HP, normals.take)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert_close(ptr.infer_step(st, t(x)).numpy(), out, 1e-5)
    after = flatten_tree(checkpoints.state_tree(st))
    for k, v in before.items():
        if v is not None:
            np.testing.assert_array_equal(after[k], v, err_msg=k)


def test_gan_state_checkpoint_bytes_equal_flax(tmp_path, normals):
    """The JAX GanState after a step (RMSProp, D's extra = vbn_stats, G's
    None) -> the port -> the bytes flax writes; the port's file restores
    in both packages and writes the same bytes; decode reads G's params
    from it."""
    jtr, ptr = trainer_pair(1, 1)
    x, y = batch(3)
    s0 = jax_state(jtr, x)
    s1, _ = jit_step(jtr.train_step)(s0, jnp.asarray(x), jnp.asarray(y),
                                     HP, jax.random.PRNGKey(4))
    assert s1.g.extra is None and list(s1.d.extra) == ["vbn_stats"]
    jpath = jax_ckpt.save_checkpoint(str(tmp_path / "jax"), "SEGAN", s1, 1)
    with open(jpath, "rb") as f:
        jax_bytes = f.read()
    st = bridged(ptr, s1)
    ppath = checkpoints.save_checkpoint(str(tmp_path / "port"), "SEGAN",
                                        checkpoints.state_tree(st), 1)
    with open(ppath, "rb") as f:
        port_bytes = f.read()
    assert port_bytes == jax_bytes
    st2 = bridged(ptr, s0)
    checkpoints.load_checkpoint(str(tmp_path / "port"), "SEGAN", st2)
    assert checkpoints.msgpack_serialize(checkpoints.state_tree(st2)) \
        == jax_bytes
    restored = flax.serialization.from_bytes(s1, port_bytes)
    assert flax.serialization.to_bytes(restored) == port_bytes
    params, extra = checkpoints.load_generator_state(str(tmp_path / "port"),
                                                     "SEGAN")
    assert extra is None
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(s1.g.params)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_vbn_stats_load_and_mismatch():
    """D's vbn_stats load by name; a tree of another depth is refused."""
    pd = SeganDiscriminator(W_IN + W_OUT, num_fmaps=ENC, kwidth=5)
    tree = collections_tree(pd)
    assert sorted(tree["vbn_stats"]) == ["d_vbn_0", "d_vbn_1", "d_vbn_2"]
    tree["vbn_stats"]["d_vbn_1"]["ref_mean"] += 1.5
    load_collections(pd, tree)
    np.testing.assert_array_equal(
        pd.d_vbn_1.ref_mean.numpy(), tree["vbn_stats"]["d_vbn_1"]["ref_mean"])
    del tree["vbn_stats"]["d_vbn_2"]
    with pytest.raises(KeyError, match="d_vbn_2"):
        load_collections(pd, tree)
    with pytest.raises(KeyError, match="collections"):
        load_collections(pd, None)
