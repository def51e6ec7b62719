"""The port's frame models against the JAX package's: DnnGenerator,
RcedGenerator and CnnGenerator (with and without BatchNorm, splice 5 and
the even splice 4, whose "SAME" padding is one row longer after than
before), DnnDiscriminator; the flax trees (params and batch_stats) both
ways, the registry, and the port's own initialisers.

f32, narrow widths (input_dim 9, a few units and filters). Tolerances:
forwards and running statistics 1e-5, gradients 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsrgan_tpu.models import get_generator as jax_get_generator
from rsrgan_tpu.models.discriminators import DnnDiscriminator as JaxDnnD
from rsrgan_tpu.models.feedforward import (CnnGenerator as JaxCnn,
                                           DnnGenerator as JaxDnn,
                                           RcedGenerator as JaxRced)
from rsrgan_tpu_torch.models import (batch_stats_tree, flatten_tree,
                                     get_discriminator, get_generator,
                                     load_batch_stats, load_flax_params,
                                     module_tree)
from rsrgan_tpu_torch.models.discriminators import DnnDiscriminator
from rsrgan_tpu_torch.models.feedforward import (CnnGenerator, DnnGenerator,
                                                 RcedGenerator)
from rsrgan_tpu_torch.ops.lstm import glorot_uniform_

torch.set_num_threads(2)

D, OUT, ROWS = 9, 4, 12
FILTERS, WIDTHS = (3, 5, 2), (3, 4, 5)


def t(a):
    return torch.from_numpy(np.array(a))


def pair(kind, splice, bn):
    """(flax module, port module) of one frame model at narrow widths."""
    if kind == "dnn":
        return (JaxDnn(output_dim=OUT, units=8, hidden_layers=2,
                       batch_norm=bn),
                DnnGenerator(D * splice, OUT, units=8, hidden_layers=2,
                             batch_norm=bn))
    if kind == "rced":
        return (JaxRced(output_dim=OUT, input_dim=D, splice=splice,
                        filters_num=FILTERS, filters_width=WIDTHS,
                        batch_norm=bn),
                RcedGenerator(D, splice, OUT, filters_num=FILTERS,
                              filters_width=WIDTHS, batch_norm=bn))
    return (JaxCnn(output_dim=OUT, input_dim=D, splice=splice,
                   filters_num=(3, 2), filters_width=4),
            CnnGenerator(D, splice, OUT, filters_num=(3, 2),
                         filters_width=4))


def bridged(kind, splice, bn, seed=0):
    """Flax variables with non-trivial BatchNorm parameters and running
    statistics, loaded into the port's module."""
    rng = np.random.default_rng(seed)
    jm, pm = pair(kind, splice, bn)
    x = rng.normal(size=(ROWS, D * splice)).astype(np.float32)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed),
                                                 jnp.asarray(x)))
    variables = jax.tree.map(np.array, variables)

    def perturb(tree, lo, hi):
        for path, leaf in flatten_tree(tree).items():
            if "BatchNorm" in path or path.endswith("bias"):
                leaf[...] = rng.uniform(lo, hi, leaf.shape)

    perturb(variables["params"], 0.5, 1.5)
    if "batch_stats" in variables:
        perturb(variables["batch_stats"], 0.3, 2.0)
    load_flax_params(pm, variables["params"])
    load_batch_stats(pm, variables.get("batch_stats"))
    return jm, pm, variables, x


CASES = [("dnn", 5, False), ("dnn", 5, True), ("dnn", 4, True),
         ("rced", 5, False), ("rced", 5, True), ("rced", 4, True),
         ("cnn", 5, False), ("cnn", 4, False)]


@pytest.mark.parametrize("kind,splice,bn", CASES)
def test_eval_forward_matches_jax(kind, splice, bn):
    """Eval mode (BatchNorm on the running statistics), 2-D frames and a
    3-D [1, T, D] utterance."""
    jm, pm, variables, x = bridged(kind, splice, bn)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    got = pm(t(x)).detach().numpy()
    assert got.shape == want.shape == (ROWS, OUT)
    np.testing.assert_allclose(got, want, atol=1e-5)
    got3 = pm(t(x)[None]).detach().numpy()
    want3 = np.asarray(jm.apply(variables, jnp.asarray(x)[None]))
    assert got3.shape == want3.shape == (1, ROWS, OUT)
    np.testing.assert_allclose(got3, want3, atol=1e-5)


@pytest.mark.parametrize("kind,splice,bn", CASES)
def test_train_forward_grads_and_batch_stats_match_jax(kind, splice, bn):
    """Train mode: the output, the running statistics after the forward
    (flax's mutated batch_stats: momentum 0.99, biased variance) and the
    gradients of a weighted sum, against flax."""
    jm, pm, variables, x = bridged(kind, splice, bn, seed=1)
    w = np.random.default_rng(2).normal(size=(ROWS, OUT)).astype(np.float32)
    extra = {k: v for k, v in variables.items() if k != "params"}

    def loss(params):
        y, new = jm.apply({"params": params, **extra}, jnp.asarray(x),
                          train=True, mutable=list(extra))
        return jnp.sum(y * w), (y, new)

    (_, (y_j, new_j)), g_j = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    y = pm(t(x), train=True)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               atol=1e-5)
    (y * t(w)).sum().backward()
    want = flatten_tree(jax.tree.map(np.asarray, g_j))
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], atol=2e-4,
                                   err_msg=name)
    stats = batch_stats_tree(pm)
    if not bn:
        assert stats is None and not new_j
        return
    want_stats = flatten_tree(jax.tree.map(np.asarray,
                                           new_j["batch_stats"]))
    got_stats = flatten_tree(stats)
    assert sorted(got_stats) == sorted(want_stats)
    moved = False
    for k in want_stats:
        np.testing.assert_allclose(got_stats[k], want_stats[k], atol=1e-5,
                                   err_msg=k)
        moved |= not np.allclose(
            want_stats[k], flatten_tree(variables["batch_stats"])[k])
    assert moved


@pytest.mark.parametrize("kind,splice,bn", [("dnn", 5, True),
                                            ("rced", 4, True),
                                            ("cnn", 4, False)])
def test_flax_trees_round_trip(kind, splice, bn):
    """flax -> port -> flax gives the same trees (names, shapes, values);
    the port's own weights, written as flax trees, give flax the port's
    outputs in eval and train mode."""
    jm, pm, variables, x = bridged(kind, splice, bn)
    for got, want in ((module_tree(pm), variables["params"]),
                      (batch_stats_tree(pm), variables.get("batch_stats"))):
        if want is None:
            assert got is None
            continue
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)
    _, own = pair(kind, splice, bn)
    with torch.no_grad():
        for p in own.parameters():
            p.add_(0.01)
    tree = {"params": module_tree(own)}
    if bn:
        tree["batch_stats"] = batch_stats_tree(own)
    np.testing.assert_allclose(
        own(t(x)).detach().numpy(),
        np.asarray(jm.apply(tree, jnp.asarray(x))), atol=1e-5)
    if bn:
        y_j, _ = jm.apply(tree, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
        np.testing.assert_allclose(own(t(x), train=True).detach().numpy(),
                                   np.asarray(y_j), atol=1e-5)


@pytest.mark.parametrize("clip", [True, False])
def test_dnn_discriminator_matches_jax(clip):
    """DNN-D forward (outputs on both sides of the clip) and gradients."""
    rng = np.random.default_rng(3)
    jd = JaxDnnD(units=8, hidden_layers=2, clip_output=clip)
    x = (rng.normal(size=(ROWS, D + OUT)) * 3).astype(np.float32)
    params = jax.tree.map(np.asarray, jd.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x))["params"])
    d = DnnDiscriminator(D + OUT, units=8, hidden_layers=2,
                         clip_output=clip)
    load_flax_params(d, params)

    def loss(p):
        y = jd.apply({"params": p}, jnp.asarray(x), train=True)
        return jnp.sum(y * jnp.arange(ROWS)[:, None]), y

    (_, y_j), g_j = jax.value_and_grad(loss, has_aux=True)(params)
    y = d(t(x), train=True)
    got = y.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(y_j), atol=1e-5)
    if clip:
        assert got.min() == -0.5 or got.max() == 1.5
    (y * torch.arange(ROWS)[:, None]).sum().backward()
    want = flatten_tree(jax.tree.map(np.asarray, g_j))
    for name, p in d.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], atol=2e-4,
                                   err_msg=name)


@pytest.mark.parametrize("g_type,left,right,bn", [
    ("dnn", 5, 5, True), ("dnn", 2, 1, False), ("rced", 2, 2, True),
    ("rced", 2, 1, False), ("cnn", 1, 2, False)])
def test_registry_builds_the_jax_trees(g_type, left, right, bn):
    """get_generator dispatches on g_type with the JAX registry's
    arguments (input_dim one frame's width, the contexts, batch_norm):
    the same parameter and batch_stats trees, names and shapes, at the
    reference sizes; get_discriminator("dnn") likewise."""
    splice = left + 1 + right
    kw = dict(input_dim=D, output_dim=OUT, left_context=left,
              right_context=right, batch_norm=bn)
    x = jnp.zeros((2, D * splice), jnp.float32)
    want = jax.eval_shape(jax_get_generator(g_type, **kw).init,
                          jax.random.PRNGKey(0), x)
    got = get_generator(g_type, **kw)
    assert type(got).__name__ == type(jax_get_generator(g_type,
                                                         **kw)).__name__
    shapes = {k: tuple(v.shape) for k, v in
              flatten_tree(dict(want["params"])).items()}
    assert {k: tuple(v.shape) for k, v in
            got.named_parameters()} == shapes
    stats = batch_stats_tree(got)
    if "batch_stats" in want:
        assert {k: v.shape for k, v in flatten_tree(stats).items()} == {
            k: tuple(v.shape) for k, v in
            flatten_tree(dict(want["batch_stats"])).items()}
    else:
        assert stats is None
    d_in = D + OUT
    jd = jax.eval_shape(JaxDnnD().init, jax.random.PRNGKey(0),
                        jnp.zeros((2, d_in)))
    pd = get_discriminator("dnn", input_dim=d_in)
    assert {k: tuple(v.shape) for k, v in pd.named_parameters()} == {
        k: tuple(v.shape) for k, v in
        flatten_tree(dict(jd["params"])).items()}


def test_initialisers_statistics():
    """The port's own initialisers: glorot uniform (Dense and HWIO conv
    kernels, fans with the receptive field), the truncated normal of
    DNN-D (|w| <= 2 stddev, stddev sqrt(2 / units) before truncation, so
    0.8796 of it after), R-CED's 0.1 output bias, zero biases, BatchNorm
    at scale 1, bias 0, mean 0, var 1. Moments within 5 standard errors."""
    gen = torch.Generator().manual_seed(0)

    def check_uniform(w, limit):
        w = w.detach().double().flatten()
        n = w.numel()
        assert float(w.abs().max()) <= limit
        var = limit ** 2 / 3
        assert abs(float(w.mean())) < 5 * (var / n) ** 0.5
        assert abs(float(w.var()) - var) < 5 * var * (0.8 / n) ** 0.5

    check_uniform(glorot_uniform_(torch.empty(300, 200), gen),
                  (6 / 500) ** 0.5)
    check_uniform(glorot_uniform_(torch.empty(11, 13, 12, 16), gen),
                  (6 / (143 * 28)) ** 0.5)
    d = DnnDiscriminator(50, units=256, generator=gen)
    stddev = (2 / 256) ** 0.5
    for k in range(4):
        w = getattr(d, f"Dense_{k}").kernel.detach().double().flatten()
        assert float(w.abs().max()) <= 2 * stddev
        sd = 0.87962566103423978 * stddev
        assert abs(float(w.std()) - sd) < 5 * sd / (2 * w.numel()) ** 0.5
        assert abs(float(w.mean())) < 5 * sd / w.numel() ** 0.5
    check_uniform(d.Dense_4.kernel, (6 / 257) ** 0.5)
    r = RcedGenerator(D, 5, OUT, batch_norm=True, generator=gen)
    assert torch.all(r.Dense_0.bias == 0.1)
    assert all(torch.all(getattr(r, f"Conv_{k}").bias == 0)
               for k in range(9))
    bn = r.BatchNorm_3
    assert torch.all(bn.scale == 1) and torch.all(bn.bias == 0)
    assert torch.all(bn.mean == 0) and torch.all(bn.var == 1)
