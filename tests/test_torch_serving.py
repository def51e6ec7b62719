"""The port's StreamingEnhancer (rsrgan_tpu_torch/serving/streaming.py)
against the JAX package's on the same parameter tree and the same chunks,
for every supported wiring, at tests/test_streaming.py's shapes: chunked
outputs, the masked step and its frozen state, state isolation and the
rejections."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsrgan_tpu.models.recurrent import (BnLstmGenerator, LstmGenerator,
                                         ResLstmGenerator)
from rsrgan_tpu.serving import StreamingEnhancer as JaxEnhancer
from rsrgan_tpu_torch.serving import StreamingEnhancer

B, T, P, OUT = 2, 24, 7, 3
CHUNKS = ((0, 5), (5, 11), (16, 8))  # uneven chunk sizes
VARIANTS = ["res_lstm_l", "res_lstm_base", "res_lstm_i", "lstm"]
ATOL = 1e-5


def numpy_tree(tree):
    return jax.tree.map(np.asarray, dict(tree))


@functools.lru_cache(maxsize=None)
def make(variant):
    """(numpy params, x [B, T, P], JAX's whole-utterance forward); the
    tests only read them."""
    rng = np.random.default_rng(0)
    if variant == "lstm":
        gen = LstmGenerator(output_dim=OUT, cell_size=11, num_projection=5,
                            lstm_impl="scan")
    else:
        gen = ResLstmGenerator(output_dim=OUT, variant=variant[9:] or "l",
                               cell_size=11, lstm_impl="scan")
    x = rng.normal(size=(B, T, P)).astype(np.float32)
    lens = jnp.full((B,), T, jnp.int32)
    variables = gen.init(jax.random.PRNGKey(0), jnp.asarray(x), lens)
    full = np.asarray(gen.apply(variables, jnp.asarray(x), lens))
    return numpy_tree(variables["params"]), x, full


def run_chunks(enh, x, to_numpy):
    state = enh.init_state(B)
    outs = []
    for start, size in CHUNKS:
        out, state = enh.step(x[:, start:start + size], state)
        outs.append(to_numpy(out))
    return np.concatenate(outs, axis=1), state


def states_np(state):
    return [np.asarray(a) for ch in state for a in ch]


@pytest.mark.parametrize("variant", VARIANTS)
def test_chunked_matches_jax(variant):
    params, x, full = make(variant)
    ours, our_state = run_chunks(
        StreamingEnhancer(params, variant=variant, device="cpu"), x,
        lambda t: t.numpy())
    theirs, their_state = run_chunks(JaxEnhancer(params, variant=variant),
                                     jnp.asarray(x), np.asarray)
    assert ours.shape == (B, T, OUT)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=ATOL)
    np.testing.assert_allclose(ours, full, rtol=0, atol=ATOL)
    for a, b in zip(states_np(our_state), states_np(their_state)):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


@pytest.mark.parametrize("variant", ["res_lstm_l", "lstm"])
def test_masked_step_matches_jax(variant):
    """Uneven lane lengths (one lane idle): the outputs, zero past each
    lane's length, and the frozen state match JAX's masked step."""
    params, x, _ = make(variant)
    lengths = np.array([4, 0], np.int32)
    ours = StreamingEnhancer(params, variant=variant, device="cpu")
    theirs = JaxEnhancer(params, variant=variant)
    # a warm state, so that frozen lanes keep something non-zero
    s_ours = ours.step(x[:, :6], ours.init_state(B))[1]
    s_theirs = theirs.step(jnp.asarray(x[:, :6]), theirs.init_state(B))[1]
    y, s = ours.step(x[:, 6:16], s_ours, lengths=lengths)
    y_j, s_j = theirs.step(jnp.asarray(x[:, 6:16]), s_theirs,
                           lengths=lengths)
    y = y.numpy()
    assert np.all(y[0, 4:] == 0.0) and np.all(y[1] == 0.0)
    np.testing.assert_allclose(y, np.asarray(y_j), rtol=0, atol=1e-6)
    for a, b in zip(states_np(s), states_np(s_j)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    for (c, h), (c0, h0) in zip(s, s_ours):   # the idle lane is frozen
        assert torch.equal(c[1], c0[1]) and torch.equal(h[1], h0[1])


def test_full_lengths_match_unmasked():
    params, x, _ = make("res_lstm_l")
    enh = StreamingEnhancer(params, device="cpu")
    y_u, s_u = enh.step(x, enh.init_state(B))
    y_m, s_m = enh.step(x, enh.init_state(B), lengths=np.full(B, T))
    assert torch.equal(y_u, y_m)
    for a, b in zip(states_np(s_u), states_np(s_m)):
        np.testing.assert_array_equal(a, b)


def test_chunking_does_not_change_bits():
    """Every product has one step's shape, so chunk sizes give the same
    bits (the card's serve gate, here on the CPU)."""
    params, x, _ = make("res_lstm_l")
    enh = StreamingEnhancer(params, device="cpu")
    whole = enh.step(x, enh.init_state(B))[0]
    state, outs = enh.init_state(B), []
    for lo in range(0, T, 7):
        out, state = enh.step(x[:, lo:lo + 7], state)
        outs.append(out)
    assert torch.equal(torch.cat(outs, dim=1), whole)


def test_state_isolation():
    """Independent streams don't leak state across init_state calls."""
    params, x, _ = make("res_lstm_l")
    enh = StreamingEnhancer(params, device="cpu")
    out1, _ = enh.step(x, enh.init_state(B))
    _, carried = enh.step(x, enh.init_state(B))
    out2, _ = enh.step(x, enh.init_state(B))
    assert torch.equal(out1, out2)
    out3, _ = enh.step(x, carried)  # warm state -> different output
    assert not torch.allclose(out1, out3)


def test_tensor_input_and_device():
    """A tensor chunk gives the numpy chunk's result; the parameters and
    the state live on the enhancer's device as f32."""
    params, x, _ = make("res_lstm_i")
    enh = StreamingEnhancer(params, variant="res_lstm_i", device="cpu")
    a = enh.step(x, enh.init_state(B))[0]
    b = enh.step(torch.from_numpy(x).double(), enh.init_state(B))[0]
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for ch in enh.init_state(3) for t in ch)
    assert (enh.num_layers, enh.num_units, enh.num_proj) == (2, 11, P)


def test_rejects_wrong_variant_tree():
    params_l, _, _ = make("res_lstm_l")
    with pytest.raises(ValueError, match="does not match res_lstm_i"):
        StreamingEnhancer(params_l, variant="res_lstm_i", device="cpu")
    params_i, _, _ = make("res_lstm_i")
    with pytest.raises(ValueError, match="does not match res_lstm_l"):
        StreamingEnhancer(params_i, variant="res_lstm_l", device="cpu")
    with pytest.raises(ValueError, match="lstm.py"):
        StreamingEnhancer(params_l, variant="lstm", device="cpu")
    broken = {**params_l, "lstm_cell_2": {
        k: v for k, v in params_l["lstm_cell_2"].items() if k != "w_f_diag"}}
    with pytest.raises(ValueError, match="w_f_diag"):
        StreamingEnhancer(broken, device="cpu")


def test_rejects_bnlstm(rng):
    gen = BnLstmGenerator(output_dim=OUT, cell_size=8, num_projection=5,
                          num_layers=2)
    x = jnp.asarray(rng.normal(size=(B, T, P)), jnp.float32)
    variables = gen.init(jax.random.PRNGKey(0), x,
                         jnp.full((B,), T, jnp.int32))
    with pytest.raises(ValueError, match="bnlstm"):
        StreamingEnhancer(numpy_tree(variables["params"]), variant="bnlstm",
                          device="cpu")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    params, _, _ = make("res_lstm_l")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingEnhancer(params)
