"""K3 at G's width (csrc/resident.cu): K2's resident walk in its acc mode,
then the weight-gradient reduction, their plans and their order, on the CPU.

``bwd_acc_route`` (ops/lstm_seq.py) sends each K3 call down one of three
routes by shape: the row-group walk where the layer fits one block (the D
layer), K2's resident grid in acc mode where ``resident_plan(...,
acc=True)`` fits (G width; in f32 up to ``RESIDENT_F32_MAX_ROWS`` rows),
csrc/lstm_bwd.cu elsewhere. In acc mode every
block of the grid sums, for its own units only, the dbias and peephole
terms of its (row, unit) cells over the steps in registers, then over the
rows in row order; ``wgrad_plan`` then splits dW_h and dproj into tiles
and K slices summed in slice order. Here the route, the plans and a torch
emulation of that order are checked, the emulation against the plain twin
in f32 (ragged lengths, a zero-length row) and against the Pallas kernel
in interpreter mode.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rsrgan_tpu.ops import pallas_lstm as jpl
from rsrgan_tpu_torch.ops import lstm_seq as ls
from rsrgan_tpu_torch.ops import resident
from test_torch_lstm_seq import (GRAD_TOL, jax_forward, jax_mask,
                                 layer_inputs, pad_g, pad_u, torch_args,
                                 unpad_g)
from test_torch_resident import cell_reverse, fixed_order_sum
from test_torch_rowgroup_bwd import (SOURCE, bwd_args, emulate_wgrad,
                                     struct_fields)

torch.set_num_threads(1)

F32, BF16 = torch.float32, torch.bfloat16
F32_TOL = 1e-5
H100_SMS = 132
GRADS = ("dxw", "dwh", "dproj", "dbias", "dwi", "dwf", "dwo")

# ---------------------------------------------------------------------------
# the route and the plans
# ---------------------------------------------------------------------------

# (B, U, P, dtype) -> K3's route on an H100: the D layer (256, 40) at the D
# step's 32 and 64 rows on the row-group walk in both dtypes; G width
# (760, 257) on the resident walk in bf16 up to 256 rows and in f32 up to
# RESIDENT_F32_MAX_ROWS, csrc/lstm_bwd.cu for f32 past them (faster there,
# though the resident plan fits up to 128 rows, not at 256)
ROUTES = [
    (32, 256, 40, F32, "rowgroup"), (32, 256, 40, BF16, "rowgroup"),
    (64, 256, 40, F32, "rowgroup"), (64, 256, 40, BF16, "rowgroup"),
    (32, 760, 257, F32, "resident"), (32, 760, 257, BF16, "resident"),
    (48, 760, 257, F32, "resident"), (56, 760, 257, F32, "streaming"),
    (64, 760, 257, F32, "streaming"), (64, 760, 257, BF16, "resident"),
    (128, 760, 257, F32, "streaming"), (128, 760, 257, BF16, "resident"),
    (256, 760, 257, BF16, "resident"), (256, 760, 257, F32, "streaming"),
]


@pytest.mark.parametrize("B,U,P,dtype,route", ROUTES)
def test_route_at_the_chip_shapes(B, U, P, dtype, route):
    assert ls.bwd_acc_route(B, U, P, dtype, H100_SMS) == route
    if route == "rowgroup":
        assert ls.rowgroup_bwd_route(B, U, P, H100_SMS)
    elif route == "resident":
        assert ls.resident_plan(B, U, P, dtype, H100_SMS, acc=True).acc
    elif B <= 128:                                    # plan fits, slower
        assert dtype == F32 and B > ls.RESIDENT_F32_MAX_ROWS
        assert ls.resident_plan(B, U, P, dtype, H100_SMS, acc=True).acc
    else:
        with pytest.raises(ValueError, match=f"B={B} U={U} P={P}"):
            ls.resident_plan(B, U, P, dtype, H100_SMS, acc=True)


@pytest.mark.parametrize("B", [32, 64, 256])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_acc_plan_budget_at_g_width(B, dtype):
    """The acc walk's shared memory at G's width: within the cap, every
    weight resident, the row reduction's sums [7, B, NU] inside region "a"
    (which at G width needs no growth, so the layout is K2's), and each
    thread's cells within ACC_CELLS."""
    try:
        plan = ls.resident_plan(B, 760, 257, dtype, H100_SMS, acc=True)
    except ValueError:
        assert (B, dtype) == (256, F32)               # staging 341 KB
        return
    k2 = ls.resident_plan(B, 760, 257, dtype, H100_SMS)
    assert plan.acc and not k2.acc
    assert plan.smem <= resident.SMEM_CAP and plan.weights_resident()
    assert plan.offsets == k2.offsets and plan.smem == k2.smem
    a_bytes = plan.offsets["dm"] - plan.offsets["a"]
    assert a_bytes >= 7 * B * plan.NU * 4
    assert B * plan.NU <= ls.ACC_CELLS * ls.RESIDENT_THREADS
    assert (plan.blocks, plan.NU) == (132, 6)


def test_acc_plan_grows_region_a_for_the_sums():
    """Where the staging of A is smaller than the sums (narrow P, several
    units a block) the acc plan enlarges region "a" and shifts the rest."""
    k2 = ls.resident_plan(32, 200, 9, BF16, H100_SMS)
    acc = ls.resident_plan(32, 200, 9, BF16, H100_SMS, acc=True)
    need = 7 * 32 * acc.NU * 4
    assert k2.offsets["dm"] - k2.offsets["a"] < need
    assert acc.offsets["dm"] - acc.offsets["a"] >= need
    assert acc.smem > k2.smem


@pytest.mark.parametrize("B,U,P,match", [
    (512, 760, 257, "rows x 6 units"), (0, 760, 257, "on 132 SMs"),
    (256, 760, 257, "bytes of staging")])
def test_acc_plan_raises_with_the_shape(B, U, P, match):
    dtype = F32 if B == 256 else BF16
    with pytest.raises(ValueError, match=f"no resident K3 plan for B={B} "
                       f"U={U} P={P}.*{match}"):
        ls.resident_plan(B, U, P, dtype, H100_SMS, acc=True)


@pytest.mark.parametrize("T,B", [(500, 32), (500, 64), (500, 256), (13, 3)])
def test_reduction_plan_covers_every_row_step_once(T, B):
    """dW_h's (T-1)·B and dproj's T·B row-steps fall into ``splits``
    contiguous slices, none empty; at G's width the K split fills the
    card (two slices of 300 tiles: 600 blocks, over WG_FILL an SM)."""
    U, P = 760, 257
    w = ls.wgrad_plan(T, B, U, P, H100_SMS)
    for K, rows in (((T - 1) * B, w.rows_wh), (T * B, w.rows_proj)):
        starts = [min(s * rows, K) for s in range(w.splits)]
        ends = [min(s0 + rows, K) for s0 in starts]
        covered = np.zeros(K, np.int32)
        for s0, s1 in zip(starts, ends):
            covered[s0:s1] += 1
        assert (covered == 1).all()
        assert (w.splits - 1) * rows < K <= w.splits * rows
    assert w.tiles == 5 * 48 + 12 * 5 and w.tiles_wh == 240
    if T * B >= 2 * ls.WG_FILL * ls.WG_K:
        assert w.splits >= 2
        assert w.tiles * w.splits >= ls.WG_FILL * H100_SMS


# ---------------------------------------------------------------------------
# emulation of the kernels' order
# ---------------------------------------------------------------------------

def emulate_resident_acc(plan, acts, lengths, dout, c_hist, w_h, proj, wi,
                         wf, wo):
    """K3's resident walk, block by block, in its order (f32): K2's walk
    (test_torch_resident.emulate_bwd's arithmetic), each (row, unit) cell's
    seven terms summed over the steps, then each unit's over the rows in
    row order. Returns (dxw, m, dh, dbias, dwi, dwf, dwo)."""
    T, B, G = acts.shape
    U, P = proj.shape
    NU, nb = plan.NU, plan.blocks
    assert plan.acc
    proj_pk, wh_pk = ls.pack_bwd_weights(w_h, proj, plan)
    dh = torch.zeros(B, P)
    dc = torch.zeros(B, U)
    dxw, m_out = torch.zeros(T, B, G), torch.zeros(T, B, U)
    dh_out = torch.zeros(T, B, P)
    cells = torch.zeros(7, B, U)      # block i holds its units' columns
    for t in reversed(range(T)):
        live = (t < lengths)[:, None]
        a = torch.zeros(plan.Mp, plan.ld1)
        a[:B, :P] = dout[t] + dh
        dh_out[t] = torch.where(live, a[:B, :P], 0.0)
        partials = []
        for i in range(nb):
            u0, u1 = plan.unit_bounds[i], plan.unit_bounds[i + 1]
            assert B * (u1 - u0) <= ls.ACC_CELLS * ls.RESIDENT_THREADS
            dm = a[:B, :plan.K1] @ proj_pk[i, :u1 - u0, :plan.K1].t()
            si, tj, sf, so = (acts[t, :, g * U + u0:g * U + u1]
                              for g in range(4))
            c_new = c_hist[t, :, u0:u1]
            c_prev = c_hist[t - 1, :, u0:u1] if t else torch.zeros(B, u1 - u0)
            dg, m, dc[:, u0:u1] = cell_reverse(
                dm, live, si, tj, sf, so, c_new, c_prev, dc[:, u0:u1],
                wi[u0:u1], wf[u0:u1], wo[u0:u1])
            terms = dg + [torch.where(live, dg[0] * c_prev, 0.0),
                          torch.where(live, dg[2] * c_prev, 0.0),
                          torch.where(live, dg[3] * c_new, 0.0)]
            for k, v in enumerate(terms):     # each cell, in step order
                cells[k, :, u0:u1] = cells[k, :, u0:u1] + v
            s_dg = torch.zeros(plan.Mp, plan.ld2)
            for g in range(4):
                dxw[t, :, g * U + u0:g * U + u1] = dg[g]
                s_dg[:B, g * NU:g * NU + u1 - u0] = dg[g]
            m_out[t, :, u0:u1] = m
            partials.append(s_dg[:B, :plan.K2] @ wh_pk[i, :P, :plan.K2].t())
        stacked = torch.stack(partials, -1)            # [B, P, blocks]
        for i in range(nb):          # phase B: column owners, fixed order
            c0, c1 = plan.col_bounds[i], plan.col_bounds[i + 1]
            total = fixed_order_sum(stacked[:, c0:c1], plan.tpi)
            dh[:, c0:c1] = torch.where(live, total, dh[:, c0:c1])
    sums = torch.zeros(7, U)
    for b in range(B):                # each unit's rows, in row order
        sums = sums + cells[:, b]
    return (dxw, m_out, dh_out, sums[:4].reshape(-1), sums[4], sums[5],
            sums[6])


def emulate_k3_resident(sms, plan_dtype, acts, lengths, dout, c_hist, h_hist,
                        w_h, proj, wi, wf, wo):
    """The resident route in the order of the ``plan_dtype`` plans: the acc
    walk, then dW_h and dproj in the reduction's slice order."""
    T, B, _ = acts.shape
    U, P = proj.shape
    plan = ls.resident_plan(B, U, P, plan_dtype, sms, acc=True)
    dxw, m, dh, *sums = emulate_resident_acc(plan, acts, lengths, dout,
                                             c_hist, w_h, proj, wi, wf, wo)
    wplan = ls.wgrad_plan(T, B, U, P, sms)
    dwh, dproj = emulate_wgrad(wplan, h_hist, dxw, m, dh,
                               torch.zeros(0, 7 * U))[:2]
    return (dxw, dwh, dproj, *sums)


@pytest.mark.parametrize("B,U,P,sms", [
    (5, 13, 9, 4), (1, 13, 9, 6), (33, 20, 7, 3), (32, 13, 9, H100_SMS),
    (17, 40, 24, 5), (64, 13, 9, 2), (3, 200, 9, H100_SMS)])
@pytest.mark.parametrize("plan_dtype", [F32, BF16])
def test_emulation_matches_twin(B, U, P, sms, plan_dtype):
    """Units that do not divide the grid (20 over 3 blocks, 13 over 4),
    one unit a block (132 SMs), up to 13 units a block, ragged lengths
    and a zero-length row, the reduction's K in several slices."""
    args = bwd_args(np.random.default_rng(B + U), 13, B, U, P)
    got = emulate_k3_resident(sms, plan_dtype, *args)
    want = ls.lstm_bwd_acc_reference(*args)
    for name, g, w in zip(GRADS, got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=F32_TOL,
                                   err_msg=name)


def test_emulated_streams_match_k2_twin():
    """The acc walk writes K2's three streams, as they are today."""
    args = bwd_args(np.random.default_rng(4), 13, 7, 13, 9)
    acts, lens, dout, c_hist, h_hist, *weights = args
    plan = ls.resident_plan(7, 13, 9, F32, 4, acc=True)
    got = emulate_resident_acc(plan, acts, lens, dout, c_hist, *weights)[:3]
    want = ls.lstm_bwd_reference(acts, lens, dout, c_hist, *weights)
    for name, g, w in zip(("dxw", "m", "dh"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=F32_TOL,
                                   err_msg=name)


def test_emulation_matches_bwd_pallas_acc():
    """The emulated order against the Pallas kernel in interpreter mode, at
    the ladder's gradient tolerance (as test_torch_lstm_seq's K3 test)."""
    from test_torch_lstm_seq import P, T, U, UP
    B = 32
    d = layer_inputs(5, B)
    _, c, h, acts = jax_forward(d)
    with pltpu.force_tpu_interpret_mode():
        want = jpl._bwd_pallas_acc(
            T, B, UP, P, jnp.asarray(pad_g(acts)),
            jnp.asarray(jax_mask(d["lens"])), jnp.asarray(d["dout"]),
            jnp.asarray(pad_u(c)), jnp.asarray(h),
            jnp.asarray(pad_g(d["w_h"])),
            jnp.asarray(np.pad(d["proj"], ((0, UP - U), (0, 0)))),
            *(jnp.asarray(pad_u(d[k][None])) for k in ("wi", "wf", "wo")))
    want = (unpad_g(want[0]), unpad_g(want[1]), np.asarray(want[2])[:U],
            unpad_g(want[3])[0], *(np.asarray(a)[0, :U] for a in want[4:]))
    got = emulate_k3_resident(7, F32, torch.from_numpy(acts),
                              torch.from_numpy(d["lens"]),
                              torch.from_numpy(d["dout"]), torch.from_numpy(c),
                              torch.from_numpy(h),
                              *torch_args(d, "w_h", "proj", "wi", "wf", "wo"))
    for name, g, w in zip(GRADS, got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_TOL,
                                   err_msg=name)


def test_wrapper_counts_nothing_off_the_card():
    """CPU tensors take the twin; another device raises; neither counts a
    launch on any route."""
    args = bwd_args(np.random.default_rng(1), 5, 32, 13, 9)

    def counts():
        return (ls.lstm_bwd_acc.launches, ls.lstm_bwd_acc.resident_launches,
                ls.lstm_bwd_acc.streaming_launches)

    before = counts()
    for g, w in zip(ls.lstm_bwd_acc(*args), ls.lstm_bwd_acc_reference(*args)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="no LSTM backward kernel"):
        ls.lstm_bwd_acc(*(a.to("meta") for a in args))
    assert counts() == before


# ---------------------------------------------------------------------------
# the parameter blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("struct", [resident.BwdParams, resident.WgradParams],
                         ids=lambda s: s.__name__)
def test_changed_params_match_the_source(struct):
    """The acc walk's parameter block (its dbias and peephole outputs and
    its ``acc`` flag) and the reduction's name the C structs' fields in
    order."""
    assert [n for n, _ in struct._fields_] == struct_fields(struct.__name__)
    names = [n for n, _ in struct._fields_]
    if struct is resident.BwdParams:
        assert {"dbias", "dwi", "dwf", "dwo", "acc"} <= set(names)


# the plans' copies of the kernels' compile-time sizes: a drift would make
# a plan admit a shape the kernel then handles wrongly (in acc mode, cells
# past kAccCells x kThreads would go unsummed)
CONSTANTS = [("kAccCells", "ACC_CELLS"), ("kThreads", "RESIDENT_THREADS"),
             ("kWgThreads", "WG_THREADS"), ("kWgTile", "WG_TILE"),
             ("kWgK", "WG_K"), ("kRows", "ROW_TILE"),
             ("kRowThreads", "ROW_THREADS"), ("kEpi", "EPI_PER_THREAD")]


@pytest.mark.parametrize("c_name,py_name", CONSTANTS,
                         ids=[c for c, _ in CONSTANTS])
def test_plan_constants_match_the_source(c_name, py_name):
    with open(SOURCE) as f:
        found = re.findall(r"constexpr int %s = (\d+);" % c_name, f.read())
    assert len(found) == 1
    assert int(found[0]) == getattr(ls, py_name)
