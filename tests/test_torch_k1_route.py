"""K1's two kernels and the route between them (ops/lstm_seq.py
``fwd_route``), on the CPU.

Where a layer's weights fit one row-group block (the D layer) K1 keeps
its row-group kernel; where they do not (G width) it runs on K4's
resident grid at L = 1 without the residual, whose plan then drops the
dead in-part of the gate product (K = P padded, not 2P). Here: the route
at the chip's shapes, the L = 1 plan's sizes, K4's plans at L >= 2 as
they were, the L = 1 twin of the wavefront against K1's twin and both
against JAX's ``_fwd_pallas`` in interpreter mode, and a res_lstm_i train
step (G per layer on K1 and K2) and its decode against the JAX trainer.

Tolerances are f32: 1e-5 for forward streams (tests/test_pallas_lstm.py),
after a train step 1e-5 on the state (tests/test_torch_training.py).
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rsrgan_tpu.models.discriminators import LstmDiscriminator as JaxDisc
from rsrgan_tpu.models.recurrent import ResLstmGenerator as JaxGen
from rsrgan_tpu.ops import pallas_lstm as jpl
from rsrgan_tpu.training import GanTrainer as JaxTrainer
from rsrgan_tpu_torch.models import flatten_tree
from rsrgan_tpu_torch.models.discriminators import LstmDiscriminator
from rsrgan_tpu_torch.models.recurrent import ResLstmGenerator
from rsrgan_tpu_torch.ops import lstm_seq as ls
from rsrgan_tpu_torch.ops import resident
from rsrgan_tpu_torch.ops import wavefront as wf
from rsrgan_tpu_torch.training import GanTrainer, checkpoints

torch.set_num_threads(1)

H100_SMS = 132
FWD_TOL, STATE_TOL = 1e-5, 1e-5
DTYPES = [torch.float32, torch.bfloat16]


# ---------------------------------------------------------------------------
# the route and the plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [8, 16, 32, 64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_d_layer_takes_the_rowgroup_kernel(B, dtype):
    """The D layer (U=256, P=40) at the recipes' 8-64 rows keeps the
    row-group kernel in both dtypes: its bf16 weights fit one block."""
    assert ls.fwd_route(B, 256, 40, dtype, H100_SMS) == "rowgroup"
    assert ls.rowgroup_plan(B, 256, 40, torch.bfloat16,
                            H100_SMS).weights_resident()


@pytest.mark.parametrize("B", [1, 16, 32, 64])
@pytest.mark.parametrize("P", [257, 280])
@pytest.mark.parametrize("dtype", DTYPES)
def test_g_width_takes_the_resident_grid(B, P, dtype):
    """G width (U=760; P=257 for res_lstm_*, 280 for --g_type=lstm) at
    1-64 rows: no row-group block holds the layer, so K1 runs on K4's
    grid at L = 1."""
    assert not ls.rowgroup_plan(B, 760, P, torch.bfloat16,
                                H100_SMS).weights_resident()
    assert ls.fwd_route(B, 760, P, dtype, H100_SMS) == "resident"


def test_route_raises_with_the_shape_where_nothing_fits():
    """4096 rows at G width: no row-group block holds the weights and K4's
    staging exceeds a block's shared memory: a raise, with the shape."""
    with pytest.raises(ValueError, match="B=4096 U=760 P=257"):
        ls.fwd_route(4096, 760, 257, torch.bfloat16, H100_SMS)


@pytest.mark.parametrize("B", [1, 16, 32, 64])
@pytest.mark.parametrize("P", [257, 280])
@pytest.mark.parametrize("dtype", DTYPES)
def test_l1_plan_drops_the_in_part(B, P, dtype):
    """At L = 1 the gate product's K is P padded to 16 (not 2P), a block
    owns SINGLE_LAYER_UNITS units (bf16 16: 48 blocks; f32 8: 95), every
    weight slice is resident in both dtypes, the grid fits the card one
    block an SM (the cooperative launch needs every block co-resident),
    and each region is the size the kernel reads."""
    plan = wf.resident_plan(B, 1, 760, P, dtype, H100_SMS)
    wb = 2 if dtype == torch.bfloat16 else 4
    NU = wf.SINGLE_LAYER_UNITS[dtype]
    assert plan.blocks == plan.nbl == -(-760 // NU) <= H100_SMS
    assert plan.NU == NU and plan.NG == 4 * NU
    assert plan.Kp == resident.round_up(P, 16) < resident.round_up(2 * P, 16)
    assert plan.ldw == plan.Kp + 8
    assert plan.weights_resident()
    assert plan.smem <= resident.SMEM_CAP
    o = plan.offsets
    assert o["gate"] - o["a"] == resident.round_up(plan.Mp * plan.ldw * wb,
                                                   resident.ALIGN)
    assert o["wg"] - o["wp"] == resident.round_up(
        plan.Np * plan.ldm * wb, resident.ALIGN)
    assert plan.smem - o["wg"] == resident.round_up(
        plan.NG * plan.ldw * wb, resident.ALIGN)


@pytest.mark.parametrize("dtype,blocks,ldm,smem", [
    (torch.bfloat16, 48, 24, 63872), (torch.float32, 95, 9, 66688)])
def test_l1_plan_sizes_at_the_dropout_batch(dtype, blocks, ldm, smem):
    """B=16, U=760, P=257: K = 272 (with K = 2P padded it would be 528);
    48 blocks and 63,872 bytes of shared memory a block in bf16; 95 and
    66,688 in f32, whose projection slice rows lie 9 floats apart (odd:
    block_gemm_direct's threads read consecutive rows)."""
    plan = wf.resident_plan(16, 1, 760, 257, dtype, H100_SMS)
    assert (plan.Kp, plan.ldw, plan.Km, plan.Np, plan.Mp) == (272, 280, 16,
                                                             264, 16)
    assert plan.ldm == ldm
    assert plan.blocks == blocks and plan.smem == smem


# K4's plans at L >= 2 as they were before K1 took the grid at L = 1:
# (nbl, NU, Kp, ldw, Km, ldm, n_res_g, n_res_p, tpi, smem, offsets)
K4_PLANS = {
    ((16, 2, 760, 257), torch.bfloat16): (66, 12, 528, 536, 16, 24, 48, 264, 4, 86288, (0, 17152, 20224, 20992, 21760, 22160, 34832)),  # noqa: E501
    ((16, 2, 760, 257), torch.float32): (66, 12, 528, 536, 16, 24, 48, 264, 4, 168336, (0, 34304, 37376, 38912, 39680, 40080, 65424)),  # noqa: E501
    ((64, 2, 760, 280), torch.bfloat16): (66, 12, 560, 568, 16, 24, 48, 280, 1, 159696, (0, 72704, 84992, 88064, 91136, 91728, 105168)),  # noqa: E501
    ((64, 2, 760, 280), torch.float32): (66, 12, 560, 568, 16, 24, 16, 280, 1, 230736, (0, 145408, 157696, 163840, 166912, 167504, 194384)),  # noqa: E501
    ((3, 2, 13, 9), torch.bfloat16): (13, 2, 32, 40, 16, 24, 8, 16, 32, 3664, (0, 1280, 1376, 2144, 2176, 2256, 3024)),  # noqa: E501
    ((3, 2, 13, 9), torch.float32): (13, 2, 32, 40, 16, 24, 8, 16, 32, 7120, (0, 2560, 2656, 4192, 4224, 4304, 5840)),  # noqa: E501
    ((16, 3, 760, 257), torch.bfloat16): (44, 18, 528, 536, 32, 40, 72, 264, 2, 123072, (0, 17152, 21760, 23040, 24192, 24768, 45888)),  # noqa: E501
    ((16, 3, 760, 257), torch.float32): (44, 18, 528, 536, 32, 40, 68, 264, 2, 231232, (0, 34304, 38912, 41472, 42624, 43200, 85440)),  # noqa: E501
    ((64, 3, 760, 280), torch.bfloat16): (44, 18, 560, 568, 32, 40, 72, 280, 1, 205824, (0, 72704, 91136, 96256, 100864, 101632, 124032)),  # noqa: E501
    ((64, 3, 760, 280), torch.float32): (44, 18, 560, 568, 32, 40, 3, 280, 1, 231072, (0, 145408, 163840, 174080, 178688, 179456, 224256)),  # noqa: E501
    ((3, 3, 13, 9), torch.bfloat16): (13, 2, 32, 40, 16, 24, 8, 16, 32, 3664, (0, 1280, 1376, 2144, 2176, 2256, 3024)),  # noqa: E501
    ((3, 3, 13, 9), torch.float32): (13, 2, 32, 40, 16, 24, 8, 16, 32, 7120, (0, 2560, 2656, 4192, 4224, 4304, 5840)),  # noqa: E501
    ((16, 4, 760, 257), torch.bfloat16): (33, 24, 528, 536, 32, 40, 96, 264, 2, 150880, (0, 17152, 23296, 24576, 26112, 26848, 47968)),  # noqa: E501
    ((16, 4, 760, 257), torch.float32): (33, 24, 528, 536, 32, 40, 67, 264, 2, 231168, (0, 34304, 40448, 43008, 44544, 45280, 87520)),  # noqa: E501
    ((64, 4, 760, 280), torch.bfloat16): (33, 24, 560, 568, 32, 40, 88, 280, 1, 231840, (0, 72704, 97280, 102400, 108544, 109472, 131872)),  # noqa: E501
    ((64, 4, 760, 280), torch.float32): (33, 24, 560, 568, 32, 40, 0, 280, 1, 232096, (0, 145408, 169984, 180224, 186368, 187296, 232096)),  # noqa: E501
    ((3, 4, 13, 9), torch.bfloat16): (13, 2, 32, 40, 16, 24, 8, 16, 32, 3664, (0, 1280, 1376, 2144, 2176, 2256, 3024)),  # noqa: E501
    ((3, 4, 13, 9), torch.float32): (13, 2, 32, 40, 16, 24, 8, 16, 32, 7120, (0, 2560, 2656, 4192, 4224, 4304, 5840)),  # noqa: E501
}


@pytest.mark.parametrize("shape,dtype", list(K4_PLANS))
def test_k4_plans_at_two_layers_and_more_are_unchanged(shape, dtype):
    p = wf.resident_plan(*shape, dtype, H100_SMS)
    assert p.Kp == resident.round_up(2 * shape[3], 16)
    assert (p.nbl, p.NU, p.Kp, p.ldw, p.Km, p.ldm, p.n_res_g, p.n_res_p,
            p.tpi, p.smem, tuple(p.offsets.values())) == K4_PLANS[
                shape, dtype]


def test_l1_packing_holds_w_h_alone():
    """At L = 1 the packed gate slices hold W_h once and nothing past it
    (no W_x part), proj once in the projection slices."""
    rng = np.random.default_rng(2)
    U, P = 13, 9
    wh = torch.tensor(rng.uniform(-1, 1, (1, P, 4 * U)), dtype=torch.float32)
    proj = torch.tensor(rng.uniform(-1, 1, (1, U, P)), dtype=torch.float32)
    plan = wf.resident_plan(3, 1, U, P, torch.float32, 5)
    wg_pk, wp_pk = wf.pack_wavefront_weights(wh.new_empty((0, P, 4 * U)),
                                             wh, proj, plan)
    assert wg_pk.shape[-1] == plan.ldw == resident.round_up(P, 16) + 8
    torch.testing.assert_close(wg_pk.abs().sum(), wh.abs().sum())
    assert not wg_pk[..., P:].any()
    torch.testing.assert_close(wp_pk.abs().sum(), proj.abs().sum())


# ---------------------------------------------------------------------------
# the twins against each other and against JAX
# ---------------------------------------------------------------------------

T, U, P = 11, 13, 9
UP = 128  # the JAX kernels' lane-padded U


def layer_inputs(seed, B):
    rng = np.random.default_rng(seed)
    lens = np.asarray(([T, 7, 0] + [T - (i % T) for i in range(B)])[:B],
                      np.int32)
    return {"xw": rng.normal(0, 0.5, (T, B, 4 * U)).astype(np.float32),
            "w_h": rng.uniform(-0.5, 0.5, (P, 4 * U)).astype(np.float32),
            "proj": rng.uniform(-0.5, 0.5, (U, P)).astype(np.float32),
            "bias": rng.normal(0, 0.3, 4 * U).astype(np.float32),
            "wi": rng.uniform(-0.5, 0.5, U).astype(np.float32),
            "wf": rng.uniform(-0.5, 0.5, U).astype(np.float32),
            "wo": rng.uniform(-0.5, 0.5, U).astype(np.float32),
            "lens": lens}


def jax_forward(d):
    """JAX's _fwd_pallas (interpreter mode) on lane-padded inputs ->
    unpadded (out, c_hist, h_hist, acts)."""
    def pad_g(a):
        return jpl.pad_gate_dim(jnp.asarray(a), U, UP)

    def pad_u(a):
        return jnp.asarray(np.pad(a, [(0, 0)] * (a.ndim - 1)
                                  + [(0, UP - U)]))

    mask = (np.arange(T)[:, None] < d["lens"][None, :]).astype(
        np.float32)[:, None, :]
    with pltpu.force_tpu_interpret_mode():
        out, c, h, acts = jpl._fwd_pallas(
            pad_g(d["xw"]), jnp.asarray(mask), pad_g(d["w_h"]),
            jnp.asarray(np.pad(d["proj"], ((0, UP - U), (0, 0)))),
            pad_g(d["bias"][None]),
            *(pad_u(d[k][None]) for k in ("wi", "wf", "wo")))
    acts = np.array(acts)
    acts = acts.reshape(acts.shape[:-1] + (4, UP))[..., :U].reshape(
        acts.shape[:-1] + (4 * U,))
    return np.array(out), np.array(c)[..., :U], np.array(h), acts


@pytest.mark.parametrize("B", [3, 16])
def test_l1_wavefront_twin_is_k1s_twin_and_jaxs(B):
    """The resident route's twin (the wavefront at L = 1, residual off)
    gives K1's four streams: the same as K1's twin and JAX's
    ``_fwd_pallas``, with a zero-length row; and without the saved
    streams the same output."""
    d = layer_inputs(B, B)
    tt = {k: torch.from_numpy(v) for k, v in d.items()}
    k1 = ls.lstm_fwd_reference(tt["xw"], tt["lens"], tt["w_h"], tt["proj"],
                               tt["bias"], tt["wi"], tt["wf"], tt["wo"])
    stack = (tt["xw"], tt["lens"], torch.zeros(T, B, P),
             torch.zeros(0, P, 4 * U), tt["w_h"][None], tt["proj"][None],
             tt["bias"][None], tt["wi"][None], tt["wf"][None],
             tt["wo"][None])
    l1 = wf.lstm_wavefront_fwd_reference(*stack, residual=False,
                                         save_acts=True)
    want = jax_forward(d)
    for name, a, b, w in zip(("out", "c_hist", "h_hist", "acts"), l1, k1,
                             want):
        np.testing.assert_allclose(a[0].numpy(), b.numpy(), atol=FWD_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(a[0].numpy(), w, atol=FWD_TOL,
                                   err_msg=name)
    top = wf.lstm_wavefront_fwd_reference(*stack, residual=False)
    np.testing.assert_allclose(top.numpy(), want[0], atol=FWD_TOL)
    assert np.all(top.numpy()[:, 2] == 0)


# ---------------------------------------------------------------------------
# res_lstm_i: G per layer in training and in decode
# ---------------------------------------------------------------------------

IN, OUT, GU, DU, TS, BS = 9, 4, 13, 10, 9, 16


@pytest.fixture(scope="module")
def res_i_step():
    """A JAX GanState with a res_lstm_i G, that state after one
    _train_step_impl (noise std 0) with its metrics, the batch, and JAX's
    decode of the batch from the post-step G."""
    rng = np.random.default_rng(17)
    lens = np.asarray([TS, TS - 1, 5, TS, 3, TS, TS - 2, 1, TS, 4, TS, 6,
                       TS, 2, TS, 7], np.int32)
    x = rng.normal(size=(BS, TS, IN)).astype(np.float32)
    y = rng.normal(size=(BS, TS, OUT)).astype(np.float32)
    tr = JaxTrainer(JaxGen(output_dim=OUT, variant="i", cell_size=GU,
                           lstm_impl="wavefront"),
                    JaxDisc(cell_size=DU, num_projection=OUT,
                            lstm_impl="wavefront"),
                    output_dim=OUT, input_dim=IN, l2_scale=1e-3)
    hp = {"g_lr": jnp.float32(3e-3), "d_lr": jnp.float32(1e-2),
          "mse_lambda": jnp.float32(1.0), "disc_noise_std": jnp.float32(0.0),
          "d_real": jnp.float32(1.0), "d_fake": jnp.float32(0.0)}
    with pltpu.force_tpu_interpret_mode():
        s0 = tr.init_state(jax.random.PRNGKey(1), jnp.asarray(x),
                           jnp.asarray(lens))
        s0 = s0.replace(g=s0.g.replace(params=jax.tree.map(
            lambda a: a + 0.05, s0.g.params)))
        s1, m = tr._train_step_impl(s0, jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(lens), hp,
                                    jax.random.PRNGKey(2))
        decoded = tr.generator.apply({"params": s1.g.params},
                                     jnp.asarray(x),
                                     jnp.asarray(lens))
    return (s0, s1, {k: float(v) for k, v in m.items()},
            {k: float(v) for k, v in hp.items()}, (x, y, lens),
            np.asarray(decoded))


def test_res_lstm_i_train_step_and_decode_match_jax(res_i_step,
                                                    monkeypatch):
    """One GAN iteration with a res_lstm_i G from one bridged state (G per
    layer on K1 and K2 forward and backward: the "i" wiring has no
    wavefront), then decode of the batch from the post-step G on K1
    without its saved streams: the metrics, every tensor of the state and
    the decoded frames."""
    s0, s1, m_want, hp, (x, y, lens), decoded = res_i_step
    calls = []
    fwd = ls.lstm_fwd
    monkeypatch.setattr(ls, "lstm_fwd", lambda *a, **k: calls.append(
        k.get("save_acts", True)) or fwd(*a, **k))
    g = ResLstmGenerator(IN, OUT, variant="i", cell_size=GU,
                         lstm_impl="wavefront")
    d = LstmDiscriminator(input_dim=OUT, cell_size=DU, num_projection=OUT,
                          lstm_impl="wavefront")
    tr = GanTrainer(g, d, output_dim=OUT, input_dim=IN, l2_scale=1e-3)
    st = tr.init_state()
    checkpoints.load_state_tree(st, flax.serialization.to_state_dict(
        jax.tree.map(np.asarray, s0)))
    t = torch.from_numpy
    m = tr.train_step(st, t(x), t(y), t(lens), hp)
    # at least the shared G forward's 2 layers, with their saved streams
    assert calls.count(True) >= 2
    for k, v in m_want.items():
        np.testing.assert_allclose(float(m[k]), v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    tree = checkpoints.state_tree(st)
    want = flax.serialization.to_state_dict(jax.tree.map(np.asarray, s1))
    got_flat, want_flat = flatten_tree(tree), flatten_tree(want)
    assert sorted(got_flat) == sorted(want_flat)
    for k in want_flat:
        np.testing.assert_allclose(np.asarray(got_flat[k], np.float64),
                                   np.asarray(want_flat[k], np.float64),
                                   atol=STATE_TOL, err_msg=k)
    calls.clear()
    got = g(t(x), t(lens))
    assert calls == [False, False]
    np.testing.assert_allclose(got.detach().numpy(), decoded, atol=FWD_TOL)
