"""K1's row-group kernel (csrc/resident.cu), its plan and its order, on the
CPU.

``rowgroup_plan`` (ops/lstm_seq.py) fixes the row groups (one block
each), the warp that owns each unit group, the padded sizes and the
shared-memory layout; the kernel reads the plan and the weights packed
for it. Here the plan is checked at the chip's shapes and at odd ones, and
a torch emulation that replays the kernel's order (the gate product from
the packed W_h group by group, the projection from the packed proj in K
chunks summed in chunk order, then mask and carry) is held against the
plain twin in f32, with ragged lengths and a zero-length row.
"""

import numpy as np
import pytest
import torch

from rsrgan_tpu_torch.ops import lstm_seq as ls
from rsrgan_tpu_torch.ops import resident

torch.set_num_threads(1)

F32_TOL = 1e-5
H100_SMS = 132

# D at 1-64 rows (the main path: 16 and 32), odd U and P, G width
SHAPES = [(1, 256, 40), (16, 256, 40), (32, 256, 40), (33, 256, 40),
          (64, 256, 40), (3, 13, 9), (17, 200, 40), (16, 760, 257),
          (64, 760, 257)]


@pytest.mark.parametrize("B,U,P", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sms", [H100_SMS, 4])
def test_plan_puts_every_row_in_one_group(B, U, P, dtype, sms):
    """Groups as small as the SMs allow (a power of two up to 16 rows),
    so each block runs as few cells a step as it can."""
    plan = ls.rowgroup_plan(B, U, P, dtype, sms)
    bounds = plan.row_bounds
    assert bounds[0] == 0 and bounds[-1] == B
    assert len(bounds) == plan.groups + 1 == -(-B // plan.group_rows) + 1
    sizes = np.diff(bounds)
    assert sizes.min() >= 1 and sizes.max() <= plan.group_rows
    assert plan.group_rows <= ls.ROW_TILE
    assert sizes.sum() == B                           # each row once
    fewest = next(r for r in (1, 2, 4, 8, 16) if -(-B // r) <= sms or r == 16)
    if U <= 256:                                      # D: the staging fits
        assert plan.group_rows == fewest
    assert plan.group_rows <= fewest


@pytest.mark.parametrize("B,U,P", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_gives_every_gate_column_one_warp(B, U, P, dtype):
    """Unit u's four gate columns g·U + u sit in packed W_h rows
    32·(u // 8) + 8g + u % 8, all of them in the one unit group that one
    warp owns; every warp owns at most ceil(ngrp / 16) groups."""
    plan = ls.rowgroup_plan(B, U, P, dtype, H100_SMS)
    assert plan.ngrp * 8 >= U > (plan.ngrp - 1) * 8
    owners = {}
    for u in range(U):
        for g in range(4):
            row = 32 * (u // 8) + 8 * g + u % 8
            owners.setdefault(u, set()).add(plan.owner(row // 32))
    assert all(len(w) == 1 for w in owners.values())
    per_warp = np.bincount([plan.owner(q) for q in range(plan.ngrp)],
                           minlength=ls.ROW_WARPS)
    assert len(per_warp) == ls.ROW_WARPS
    assert per_warp.max() - per_warp.min() <= 1


@pytest.mark.parametrize("B,U,P", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sms", [H100_SMS, 1])
def test_plan_fits_a_block(B, U, P, dtype, sms):
    plan = ls.rowgroup_plan(B, U, P, dtype, sms)
    assert plan.smem <= resident.SMEM_CAP == 232448
    assert all(o % resident.ALIGN == 0 for o in plan.offsets.values())
    assert plan.Kh >= P and plan.Kh % 16 == 0
    assert plan.Km >= U and plan.Km % 16 == 0 and plan.Np % 8 == 0
    assert plan.n_res_h % 32 == 0 and plan.n_res_p % 8 == 0
    # the projection's K chunks cover Km exactly once, none empty
    assert (plan.ks - 1) * plan.kchunk * 16 < plan.Km
    assert plan.ks * plan.kchunk * 16 >= plan.Km


@pytest.mark.parametrize("B", [16, 32])
def test_d_layer_is_resident_in_bf16(B):
    """The D step's rows on an H100: one row a block, each block holding
    the whole layer; on one SM, 16-row groups hold it too."""
    plan = ls.rowgroup_plan(B, 256, 40, torch.bfloat16, H100_SMS)
    assert plan.weights_resident()
    assert plan.group_rows == 1 and plan.groups == B
    plan = ls.rowgroup_plan(B, 256, 40, torch.bfloat16, 1)
    assert plan.weights_resident()
    assert plan.group_rows == 16 and plan.groups == B // 16


@pytest.mark.parametrize("B,U,P,dtype", [
    (16, 4096, 40, torch.bfloat16), (16, 1500, 1500, torch.float32),
    (0, 256, 40, torch.bfloat16)])
def test_plan_raises_with_the_shape(B, U, P, dtype):
    with pytest.raises(ValueError, match=f"B={B} U={U} P={P}"):
        ls.rowgroup_plan(B, U, P, dtype, H100_SMS)


@pytest.mark.parametrize("U,P", [(13, 9), (256, 40), (200, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_weights_unpack(U, P, dtype):
    rng = np.random.default_rng(U)
    w_h = torch.tensor(rng.uniform(-1, 1, (P, 4 * U)),
                       dtype=torch.float32).to(dtype)
    proj = torch.tensor(rng.uniform(-1, 1, (U, P)),
                        dtype=torch.float32).to(dtype)
    plan = ls.rowgroup_plan(16, U, P, dtype, H100_SMS)
    wh_pk, wp_pk = ls.pack_fwd_weights(w_h, proj, plan)
    assert wh_pk.shape == (32 * plan.ngrp, plan.ldh)
    assert wp_pk.shape == (plan.Np, plan.ldm)
    for g in range(4):
        for u in range(U):
            row = 32 * (u // 8) + 8 * g + u % 8
            assert torch.equal(wh_pk[row, :P], w_h[:, g * U + u])
    assert torch.equal(wp_pk[:P, :U], proj.t())
    # every pad is zero: the packed tensors hold each weight once
    assert int((wh_pk != 0).sum()) == int((w_h != 0).sum())
    assert int((wp_pk != 0).sum()) == int((proj != 0).sum())


# ---------------------------------------------------------------------------
# emulation of the kernel's order
# ---------------------------------------------------------------------------

def emulate_fwd(plan, xw, lengths, w_h, proj, bias, wi, wf, wo, save_acts):
    """K1's row-group kernel, block by block, in its order (f32)."""
    T, B, G = xw.shape
    U, P, ngrp = plan.U, plan.P, plan.ngrp
    wh_pk, wp_pk = ls.pack_fwd_weights(w_h, proj, plan)
    out = torch.zeros(T, B, P)
    c_hist, h_hist = torch.zeros(T, B, U), torch.zeros(T, B, P)
    acts = torch.zeros(T, B, G)
    for i in range(plan.groups):
        r0, r1 = plan.row_bounds[i], plan.row_bounds[i + 1]
        n = r1 - r0
        assert n <= plan.group_rows
        s_h = torch.zeros(ls.ROW_TILE, plan.ldh)
        s_m = torch.zeros(ls.ROW_TILE, plan.ldm)
        s_c = torch.zeros(ls.ROW_TILE, U)
        s_hf = torch.zeros(ls.ROW_TILE, P)
        live_rows = lengths[r0:r1]
        for t in range(T):
            # each unit group's four gate tiles from its 32 packed rows
            pre = torch.zeros(ls.ROW_TILE, 4, 8 * ngrp)
            for q in range(ngrp):
                acc = s_h[:, :plan.Kh] @ wh_pk[32 * q:32 * q + 32,
                                               :plan.Kh].t()
                pre[:, :, 8 * q:8 * q + 8] = acc.reshape(-1, 4, 8)
            x = xw[t, r0:r1].float().reshape(n, 4, U)
            gate = (x + pre[:n, :, :U]) + bias.reshape(4, U)
            c_prev = s_c[:n]
            si = torch.sigmoid(gate[:, 0] + wi * c_prev)
            tj = torch.tanh(gate[:, 1])
            sf = torch.sigmoid(gate[:, 2] + wf * c_prev)
            c_new = sf * c_prev + si * tj
            so = torch.sigmoid(gate[:, 3] + wo * c_new)
            live = (t < live_rows)[:, None]
            s_c[:n] = torch.where(live, c_new, c_prev)
            s_m[:n, :U] = so * torch.tanh(c_new)
            if save_acts:
                c_hist[t, r0:r1] = s_c[:n]
                acts[t, r0:r1] = torch.cat([si, tj, sf, so], 1)
            # the projection's K chunks, summed in chunk order
            v = torch.zeros(ls.ROW_TILE, plan.Np)
            for ck in range(plan.ks):
                k0 = ck * plan.kchunk * 16
                k1 = min(k0 + plan.kchunk * 16, plan.Km)
                v = v + s_m[:, k0:k1] @ wp_pk[:, k0:k1].t()
            v = v[:n, :P]
            s_hf[:n] = torch.where(live, v, s_hf[:n])
            s_h[:n, :P] = s_hf[:n]
            out[t, r0:r1] = torch.where(live, v, 0.0)
            if save_acts:
                h_hist[t, r0:r1] = s_hf[:n]
    if not save_acts:
        return out, None, None, None
    return out, c_hist, h_hist, acts


LENS = [13, 7, 0, 12, 1]


def fwd_args(rng, T, B, U, P):
    def u(*shape):
        return torch.tensor(rng.uniform(-0.5, 0.5, shape),
                            dtype=torch.float32)
    lens = torch.tensor((LENS * B)[:B], dtype=torch.int32)
    xw = torch.tensor(rng.normal(0, 0.5, (T, B, 4 * U)), dtype=torch.float32)
    return xw, lens, u(P, 4 * U), u(U, P), u(4 * U), u(U), u(U), u(U)


@pytest.mark.parametrize("B,U,P,sms", [
    (5, 13, 9, 1), (1, 13, 9, H100_SMS), (17, 13, 9, 1), (33, 20, 7, 3),
    (3, 40, 24, H100_SMS), (16, 40, 24, 4)])
@pytest.mark.parametrize("save_acts", [True, False])
def test_emulation_matches_twin(B, U, P, sms, save_acts):
    """Row groups of 1, 4, 8 and 16 rows, ragged ones (17 and 33 rows in
    groups of 16), one or two unit groups, P a multiple of neither 8 nor
    16, K split into chunks (U=40, P=24: three projection tiles and three
    chunks), ragged lengths and a zero-length row."""
    args = fwd_args(np.random.default_rng(B + U), 13, B, U, P)
    plan = ls.rowgroup_plan(B, U, P, torch.float32, sms)
    got = emulate_fwd(plan, *args, save_acts)
    want = ls.lstm_fwd_reference(*args, save_acts=save_acts)
    if not save_acts:   # the kernel then writes out alone
        assert got[1:] == (None, None, None)
        got, want = got[:1], want[:1]
    for name, g, w in zip(("out", "c_hist", "h_hist", "acts"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=F32_TOL,
                                   err_msg=name)


def test_k_split_is_exercised():
    """The emulation's shapes above include a projection split into
    more than one K chunk, as the D layer's (U=256, P=40: 5 tiles x 3
    chunks of 6 k-steps, a task for 15 of the 16 warps)."""
    assert ls.rowgroup_plan(3, 40, 24, torch.float32, H100_SMS).ks == 3
    plan = ls.rowgroup_plan(16, 256, 40, torch.bfloat16, H100_SMS)
    assert (plan.ks, plan.kchunk) == (3, 6)
    assert plan.ks * (plan.Np // 8) <= ls.ROW_WARPS


def test_fwd_wrapper_raises_for_other_devices():
    args = fwd_args(np.random.default_rng(0), 5, 3, 13, 9)
    with pytest.raises(ValueError, match="no LSTM forward kernel"):
        ls.lstm_fwd(*(a.to("meta") for a in args))
