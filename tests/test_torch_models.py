"""The port's generators (ResLstmGenerator, LstmGenerator), loaded from a
JAX-initialised parameter tree with load_flax_params, against the JAX
scan generators on the same inputs (rsrgan_tpu/models/recurrent.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsrgan_tpu.models.recurrent import LstmGenerator as JaxLstmGen
from rsrgan_tpu.models.recurrent import ResLstmGenerator as JaxResLstm
from rsrgan_tpu_torch.models import (flatten_tree, get_generator,
                                     load_flax_params)
from rsrgan_tpu_torch.models.recurrent import (LstmGenerator,
                                               ResLstmGenerator)

torch.set_num_threads(1)

B, T, D, OUT, U = 3, 17, 9, 4, 13
LENS = [T, 11, 5]


def jax_generator(variant, rng, cdt=jnp.float32):
    gen = JaxResLstm(output_dim=OUT, variant=variant, cell_size=U,
                     compute_dtype=cdt, lstm_impl="scan")
    x = jnp.asarray(rng.normal(size=(B, T, D)), jnp.float32)
    lens = jnp.asarray(LENS, jnp.int32)
    params = gen.init(jax.random.PRNGKey(0), x, lens)["params"]
    params = jax.tree.map(np.asarray, params)
    for name, node in params.items():  # non-zero biases
        node["bias"] = rng.normal(0, 0.3, node["bias"].shape).astype(
            np.float32)
    return gen, params, x, lens


def port_generator(variant, params, impl, cdt=torch.float32):
    gen = ResLstmGenerator(D, OUT, variant=variant, cell_size=U,
                           compute_dtype=cdt, lstm_impl=impl)
    load_flax_params(gen, params)
    return gen


@pytest.mark.parametrize("variant", ["l", "base", "i"])
@pytest.mark.parametrize("impl", ["wavefront", "scan"])
def test_generator_matches_jax_scan(rng, variant, impl):
    jgen, params, x, lens = jax_generator(variant, rng)
    want = np.asarray(jgen.apply({"params": params}, x, lens))
    gen = port_generator(variant, params, impl)
    got = gen(torch.from_numpy(np.array(x)), torch.tensor(LENS))
    assert got.shape == (B, T, OUT)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_generator_bf16_sanity(rng):
    """bf16 kernel path vs the JAX bf16 scan generator: the two round at
    different points (the scan rounds each product's result, the
    wavefront only its operands), so they agree to bf16 scale."""
    jgen, params, x, lens = jax_generator("l", rng, jnp.bfloat16)
    want = np.asarray(jgen.apply({"params": params}, x, lens))
    gen = port_generator("l", params, "wavefront", torch.bfloat16)
    got = gen(torch.from_numpy(np.array(x)), torch.tensor(LENS))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-2)


def test_load_flax_params_names_layouts_and_values(rng):
    _, params, _, _ = jax_generator("l", rng)
    gen = port_generator("l", params, "wavefront")
    assert sorted(params) == ["forward_out"] + [f"lstm_cell_{k}"
                                                for k in range(1, 5)]
    for name, value in gen.named_parameters():
        layer, leaf = name.split(".")
        np.testing.assert_array_equal(value.detach().numpy(),
                                      params[layer][leaf])


def test_load_flax_params_rejects_mismatch(rng):
    _, params, _, _ = jax_generator("l", rng)
    gen = get_generator("res_lstm_l", input_dim=D, output_dim=OUT)
    with pytest.raises(KeyError, match="lstm_cell_4"):
        load_flax_params(gen, {k: v for k, v in params.items()
                               if k != "lstm_cell_4"})
    with pytest.raises(ValueError, match="lstm_cell_1.kernel"):
        load_flax_params(gen, params)  # cell 760 vs the tree's 13
    wider = ResLstmGenerator(D, OUT + 1, cell_size=U)
    with pytest.raises(ValueError, match="forward_out.kernel"):
        load_flax_params(wider, params)


def jax_lstm_generator(rng, P_=7, layers=3):
    gen = JaxLstmGen(output_dim=OUT, cell_size=U, num_projection=P_,
                     num_layers=layers, lstm_impl="scan")
    x = jnp.asarray(rng.normal(size=(B, T, D)), jnp.float32)
    lens = jnp.asarray(LENS, jnp.int32)
    params = jax.tree.map(np.asarray,
                          gen.init(jax.random.PRNGKey(1), x, lens)["params"])
    rng2 = np.random.default_rng(3)   # non-zero biases
    params = jax.tree.map(
        lambda a: a + rng2.normal(0, 0.1, a.shape).astype(np.float32),
        params)
    return gen, params, x, lens


@pytest.mark.parametrize("impl", ["wavefront", "pallas", "scan"])
def test_lstm_generator_matches_jax_scan(rng, impl):
    """Dense 9 -> 7, leakyrelu, 3 x LSTM(13, proj 7), Dense 7 -> 4: the
    wavefront stack (residual off, its twin here), the per-layer kernels'
    twins and the eager cell against the JAX scan module."""
    jgen, params, x, lens = jax_lstm_generator(rng)
    want = np.asarray(jgen.apply({"params": params}, x, lens))
    gen = LstmGenerator(D, OUT, cell_size=U, num_projection=7,
                        lstm_impl=impl)
    load_flax_params(gen, params)
    got = gen(torch.from_numpy(np.array(x)), torch.tensor(LENS))
    assert got.shape == (B, T, OUT)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_lstm_generator_tree_names_and_registry(rng):
    """The flax tree (Dense_0, StackedLstm_0/cell_{0,1,2}, Dense_1) loads
    by name; get_generator("lstm") builds the reference sizes: Dense
    257 -> 280, 3 x LSTM(760, proj 280), Dense 280 -> 40."""
    _, params, _, _ = jax_lstm_generator(rng)
    gen = LstmGenerator(D, OUT, cell_size=U, num_projection=7)
    load_flax_params(gen, params)
    assert sorted(params) == ["Dense_0", "Dense_1", "StackedLstm_0"]
    flat = flatten_tree(params)
    for name, value in gen.named_parameters():
        np.testing.assert_array_equal(value.detach().numpy(), flat[name])
    full = get_generator("lstm", input_dim=257, output_dim=40, keep_prob=0.8)
    shapes = {n: tuple(p.shape) for n, p in full.named_parameters()}
    assert shapes["Dense_0.kernel"] == (257, 280)
    assert shapes["StackedLstm_0.cell_2.kernel"] == (560, 3040)
    assert shapes["StackedLstm_0.cell_2.proj_kernel"] == (760, 280)
    assert shapes["Dense_1.kernel"] == (280, 40)
    assert full.keep_prob == full.StackedLstm_0.keep_prob == 0.8
    res = get_generator("res_lstm_l", input_dim=D, output_dim=OUT,
                        keep_prob=0.5)
    assert res.keep_prob == 0.5
