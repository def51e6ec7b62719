"""K3's row-group walk and its weight-gradient reduction (csrc/resident.cu),
their plans and their order, on the CPU.

``rowgroup_bwd_plan`` (ops/lstm_seq.py) fixes the row groups (one block
each), the warp that owns each unit group, the padded sizes and the
shared-memory layout of the walk; ``wgrad_plan`` the tiles and K splits of
the reduction; ``rowgroup_bwd_route`` which K3 calls take them. Here the
plans are checked at the chip's shapes and at odd ones, and a torch
emulation that replays the kernels' order (dm group by group from the
packed proj, the reverse cell, dh from the packed W_h in K chunks summed in
chunk order, the dbias and peephole terms summed per row group; then dW_h
and dproj over K slices summed in slice order and the group partials
summed in group order) is held against the plain twin in f32, with ragged
lengths and a zero-length row, and against the Pallas kernel in interpreter
mode.
"""

import os
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

torch.set_num_threads(1)

F32_TOL = 1e-5
H100_SMS = 132
DTYPES = [torch.float32, torch.bfloat16]
GRADS = ("dxw", "dwh", "dproj", "dbias", "dwi", "dwf", "dwo")

# D at 1-64 rows (the D step: 32, and 64 at --batch_size=32), odd U and P
SHAPES = [(B, U, P) for B in (1, 16, 32, 33, 64)
          for U, P in ((256, 40), (13, 9), (200, 40))]


@pytest.mark.parametrize("B,U,P", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sms", [H100_SMS, 4])
def test_plan_puts_every_row_in_one_group(B, U, P, dtype, sms):
    plan = ls.rowgroup_bwd_plan(B, U, P, dtype, sms)
    bounds = plan.row_bounds
    assert bounds[0] == 0 and bounds[-1] == B
    assert len(bounds) == plan.groups + 1 == -(-B // plan.group_rows) + 1
    sizes = np.diff(bounds)
    assert sizes.min() >= 1 and sizes.max() <= plan.group_rows
    assert sizes.sum() == B                           # each row once
    fewest = next(r for r in (1, 2, 4, 8, 16) if -(-B // r) <= sms or r == 16)
    assert plan.group_rows <= min(fewest, ls.ROW_TILE)
    if sms == H100_SMS:                               # one row a block
        assert plan.group_rows == 1 and plan.groups == B


@pytest.mark.parametrize("B,U,P", SHAPES + [(2, 300, 9), (1, 512, 40)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_gives_every_unit_group_one_warp(B, U, P, dtype):
    """Unit u sits in group u // 8, whose dm tile (packed proj rows
    8q .. 8q+7) and cells one warp owns; a warp owns at most four groups,
    one a lane octet, so each of its lanes runs one unit's cells."""
    plan = ls.rowgroup_bwd_plan(B, U, P, dtype, H100_SMS)
    assert plan.ngrp * 8 >= U > (plan.ngrp - 1) * 8
    lanes = set()
    for u in range(U):
        q = u // 8
        warp = plan.owner(q)
        lane = 8 * (q // ls.ROW_WARPS) + u % 8
        assert warp == q % ls.ROW_WARPS and lane < 32
        lanes.add((warp, lane))
    assert len(lanes) == U                            # one lane a unit
    per_warp = np.bincount([plan.owner(q) for q in range(plan.ngrp)],
                           minlength=ls.ROW_WARPS)
    assert per_warp.max() <= 4 and per_warp.max() - per_warp.min() <= 1


@pytest.mark.parametrize("B,U,P", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sms", [H100_SMS, 1])
def test_plan_fits_a_block(B, U, P, dtype, sms):
    plan = ls.rowgroup_bwd_plan(B, U, P, dtype, sms)
    wb = 2 if dtype == torch.bfloat16 else 4
    assert plan.smem <= resident.SMEM_CAP == 232448
    assert all(o % resident.ALIGN == 0 for o in plan.offsets.values())
    assert plan.K1 >= P and plan.K1 % 16 == 0
    assert plan.K2 >= 4 * U and plan.K2 % 16 == 0 and plan.Np % 8 == 0
    assert plan.n_res_p % 8 == 0 and plan.n_res_h % 8 == 0
    # the ldmatrix rows and the staged rows start on 16 bytes
    assert plan.ld1 * wb % 16 == 0 and plan.ld2 * wb % 16 == 0
    assert 4 * U * wb % plan.achunk == 0 and plan.lda * wb % plan.achunk == 0
    assert U * 4 % plan.cchunk == 0 and plan.ldc * 4 % 16 == 0
    # the dh product's K chunks cover K2 exactly once, none empty
    assert (plan.ks - 1) * plan.kchunk * 16 < plan.K2
    assert plan.ks * plan.kchunk * 16 >= plan.K2
    assert plan.group_rows * P <= ls.EPI_PER_THREAD * ls.ROW_THREADS


@pytest.mark.parametrize("B", [32, 64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_d_layer_is_resident(B, dtype):
    """The D step's rows on an H100: one row a block, each block holding
    the whole layer (bf16: the dh product's K split as K1's projection's,
    5 tiles x 3 chunks; f32: A operands of one row, one chunk)."""
    plan = ls.rowgroup_bwd_plan(B, 256, 40, dtype, H100_SMS)
    assert plan.weights_resident()
    assert plan.group_rows == 1 and plan.groups == B
    if dtype == torch.bfloat16:
        assert (plan.ks, plan.kchunk) == (3, 22)
        assert plan.ks * (plan.Np // 8) <= ls.ROW_WARPS
    else:
        assert (plan.ks, plan.kchunk) == (1, plan.K2 // 16)


@pytest.mark.parametrize("B,U,P,dtype", [
    (16, 760, 257, torch.bfloat16), (1, 256, 5000, torch.float32),
    (16, 100, 3000, torch.bfloat16), (0, 256, 40, torch.bfloat16)])
def test_plan_raises_with_the_shape(B, U, P, dtype):
    with pytest.raises(ValueError, match=f"B={B} U={U} P={P}"):
        ls.rowgroup_bwd_plan(B, U, P, dtype, H100_SMS)


@pytest.mark.parametrize("B,U,P,want", [
    (32, 256, 40, True), (64, 256, 40, True), (16, 256, 40, True),
    (3, 13, 9, True), (32, 760, 257, False), (256, 760, 257, False)])
def test_route_is_decided_by_the_plan(B, U, P, want):
    """The D layer takes the row-group walk in both dtypes (the route reads
    the bf16 plan); G width stays on csrc/lstm_bwd.cu."""
    assert ls.rowgroup_bwd_route(B, U, P, H100_SMS) is want
    if want:
        for dtype in DTYPES:                          # both dtypes plan
            ls.rowgroup_bwd_plan(B, U, P, dtype, H100_SMS)


@pytest.mark.parametrize("U,P", [(13, 9), (256, 40), (200, 40)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_packed_weights_unpack(U, P, dtype):
    rng = np.random.default_rng(U)
    w_h = torch.tensor(rng.uniform(-1, 1, (P, 4 * U)),
                       dtype=torch.float32).to(dtype)
    proj = torch.tensor(rng.uniform(-1, 1, (U, P)),
                        dtype=torch.float32).to(dtype)
    plan = ls.rowgroup_bwd_plan(32, U, P, dtype, H100_SMS)
    wp_pk, wh_pk = ls.pack_bwd_rowgroup_weights(w_h, proj, plan)
    assert wp_pk.shape == (8 * plan.ngrp, plan.ld1)
    assert wh_pk.shape == (plan.Np, plan.ld2)
    assert torch.equal(wp_pk[:U, :P], proj)
    assert torch.equal(wh_pk[:P, :4 * U], w_h)
    # every pad is zero: the packed tensors hold each weight once
    assert int((wp_pk != 0).sum()) == int((proj != 0).sum())
    assert int((wh_pk != 0).sum()) == int((w_h != 0).sum())


@pytest.mark.parametrize("T,B,U,P,sms", [
    (500, 32, 256, 40, H100_SMS), (500, 64, 256, 40, H100_SMS),
    (500, 32, 760, 257, H100_SMS), (1, 1, 13, 9, H100_SMS), (13, 3, 13, 9, 1)])
def test_wgrad_plan_covers_every_output_and_row_once(T, B, U, P, sms):
    w = ls.wgrad_plan(T, B, U, P, sms)
    G = 4 * U
    cover = np.zeros((P + U, max(G, P)), np.int32)
    for tile in range(w.tiles):
        wh = tile < w.tiles_wh
        M, N = (P, G) if wh else (U, P)
        i = tile if wh else tile - w.tiles_wh
        tn = -(-N // ls.WG_TILE)
        m0, n0 = (i // tn) * ls.WG_TILE, (i % tn) * ls.WG_TILE
        rows = slice(m0 + (0 if wh else P), min(m0 + ls.WG_TILE, M)
                     + (0 if wh else P))
        cover[rows, n0:min(n0 + ls.WG_TILE, N)] += 1
    assert (cover[:P, :G] == 1).all() and (cover[P:, :P] == 1).all()
    assert cover.sum() == P * G + U * P
    assert w.splits * w.rows_wh >= (T - 1) * B
    assert w.splits * w.rows_proj >= T * B
    assert w.rows_wh % ls.WG_K == 0 and w.rows_proj % ls.WG_K == 0
    if T * B >= 2 * sms * ls.WG_K:                    # enough rows to split
        assert w.tiles * w.splits >= 2 * sms


# ---------------------------------------------------------------------------
# emulation of the kernels' order
# ---------------------------------------------------------------------------

def emulate_walk(plan, acts, lengths, dout, c_hist, w_h, proj, wi, wf, wo):
    """K3's walk, block by block, in its order (f32). Returns (dxw, m, dh,
    part [groups, 7U])."""
    T, B, G = acts.shape
    U, P, ngrp = plan.U, plan.P, plan.ngrp
    wp_pk, wh_pk = ls.pack_bwd_rowgroup_weights(w_h, proj, plan)
    dxw, m_s, dh_s = (torch.zeros(T, B, n) for n in (G, U, P))
    part = torch.zeros(plan.groups, 7 * U)
    for i in range(plan.groups):
        r0, r1 = plan.row_bounds[i], plan.row_bounds[i + 1]
        n = r1 - r0
        assert n <= plan.group_rows
        lens = lengths[r0:r1]
        a1 = torch.zeros(ls.ROW_TILE, plan.ld1)
        a2 = torch.zeros(ls.ROW_TILE, plan.ld2)
        dc, dh = torch.zeros(n, U), torch.zeros(n, P)
        acc = torch.zeros(7, U)
        a1[:n, :P] = dout[T - 1, r0:r1]
        dh_s[T - 1, r0:r1] = torch.where((T - 1 < lens)[:, None],
                                         dout[T - 1, r0:r1], 0.0)
        for t in reversed(range(T)):
            live = (t < lens)[:, None]
            dm = torch.zeros(ls.ROW_TILE, 8 * ngrp)
            for q in range(ngrp):           # each group's dm tile
                dm[:, 8 * q:8 * q + 8] = (a1[:, :plan.K1]
                                          @ wp_pk[8 * q:8 * q + 8,
                                                  :plan.K1].t())
            dm = torch.where(live, dm[:n, :U], 0.0)
            si, tj, sf, so = acts[t, r0:r1].float().reshape(n, 4, U).unbind(1)
            c_new = c_hist[t, r0:r1]
            c_prev = c_hist[t - 1, r0:r1] if t > 0 else torch.zeros(n, U)
            tc = torch.tanh(c_new)
            d_o = dm * tc * so * (1 - so)
            dc_total = (torch.where(live, dc, 0.0) + dm * so * (1 - tc * tc)
                        + d_o * wo)
            d_f = dc_total * c_prev * sf * (1 - sf)
            d_i = dc_total * tj * si * (1 - si)
            d_j = dc_total * si * (1 - tj * tj)
            dc = torch.where(live, dc_total * sf + d_f * wf + d_i * wi, dc)
            dg = torch.where(live, torch.cat([d_i, d_j, d_f, d_o], 1), 0.0)
            a2[:n, :G] = dg
            for b in range(n):              # the owning lane, row by row
                acc[:4] += dg[b].reshape(4, U)
                if live[b]:
                    acc[4] += d_i[b] * c_prev[b]
                    acc[5] += d_f[b] * c_prev[b]
                    acc[6] += d_o[b] * c_new[b]
            dxw[t, r0:r1] = dg
            m_s[t, r0:r1] = torch.where(live, so * tc, 0.0)
            v = torch.zeros(ls.ROW_TILE, plan.Np)
            for ck in range(plan.ks):       # K chunks, in chunk order
                k0 = ck * plan.kchunk * 16
                k1 = min(k0 + plan.kchunk * 16, plan.K2)
                v = v + a2[:, k0:k1] @ wh_pk[:, k0:k1].t()
            dh = torch.where(live, v[:n, :P], dh)
            if t > 0:
                d = dout[t - 1, r0:r1] + dh
                a1[:n, :P] = d
                dh_s[t - 1, r0:r1] = torch.where((t - 1 < lens)[:, None], d,
                                                 0.0)
        part[i] = acc.reshape(-1)
    return dxw, m_s, dh_s, part


def emulate_wgrad(wplan, h_hist, dxw, m, dh, part):
    """The reduction in its order: K slices summed in slice order, group
    partials in group order."""
    T, B, P = h_hist.shape
    U = m.shape[2]
    G = 4 * U

    def split_k(A, Bm, rows):
        K = A.shape[0]
        out = torch.zeros(A.shape[1], Bm.shape[1])
        for s in range(wplan.splits):
            k0 = min(s * rows, K)
            k1 = min(k0 + rows, K)
            out = out + A[k0:k1].t() @ Bm[k0:k1]
        return out

    dwh = split_k(h_hist.reshape(T * B, P)[:(T - 1) * B],
                  dxw.reshape(T * B, G)[B:], wplan.rows_wh)
    dproj = split_k(m.reshape(T * B, U), dh.reshape(T * B, P),
                    wplan.rows_proj)
    vec = torch.zeros(7 * U)
    for g in range(part.shape[0]):
        vec = vec + part[g]
    return (dwh, dproj, vec[:G], vec[G:5 * U], vec[5 * U:6 * U],
            vec[6 * U:])


def emulate_bwd_acc(sms, plan_dtype, acts, lengths, dout, c_hist, h_hist,
                    w_h, proj, wi, wf, wo):
    """Both kernels in the order of the ``plan_dtype`` plan (f32
    arithmetic: the bf16 plan's order is its chunked dh product)."""
    T, B, _ = acts.shape
    U, P = proj.shape
    plan = ls.rowgroup_bwd_plan(B, U, P, plan_dtype, sms)
    dxw, m, dh, part = emulate_walk(plan, acts, lengths, dout, c_hist, w_h,
                                    proj, wi, wf, wo)
    return (dxw,) + emulate_wgrad(ls.wgrad_plan(T, B, U, P, sms), h_hist, dxw,
                                  m, dh, part)


LENS = [13, 7, 0, 12, 1]


def bwd_args(rng, T, B, U, P):
    """K3's inputs from the forward twin's streams, f32."""
    def u(*shape):
        return torch.tensor(rng.uniform(-0.5, 0.5, shape),
                            dtype=torch.float32)
    lens = torch.tensor((LENS * B)[:B], dtype=torch.int32)
    xw = torch.tensor(rng.normal(0, 0.5, (T, B, 4 * U)), dtype=torch.float32)
    w_h, proj, bias, wi, wf, wo = (u(P, 4 * U), u(U, P), u(4 * U), u(U),
                                   u(U), u(U))
    _, c_hist, h_hist, acts = ls.lstm_fwd_reference(xw, lens, w_h, proj, bias,
                                                    wi, wf, wo)
    dout = torch.tensor(rng.normal(size=(T, B, P)), dtype=torch.float32)
    return acts, lens, dout, c_hist, h_hist, w_h, proj, wi, wf, wo


@pytest.mark.parametrize("B,U,P,sms", [
    (5, 13, 9, 1), (1, 13, 9, H100_SMS), (17, 13, 9, 1), (33, 20, 7, 3),
    (3, 40, 24, H100_SMS), (16, 40, 24, 4), (2, 300, 9, H100_SMS),
    (32, 16, 8, H100_SMS)])
@pytest.mark.parametrize("plan_dtype", DTYPES)
def test_emulation_matches_twin(B, U, P, sms, plan_dtype):
    """Row groups of 1, 4, 8 and 16 rows, ragged ones (17 and 33 rows in
    groups of 16), one to five unit groups and more than 32 (lanes 8-31
    own units), P a multiple of neither 8 nor 16, the dh product's K split
    into up to five chunks (bf16 plans), the reduction's K into several
    slices, ragged lengths and a zero-length row."""
    args = bwd_args(np.random.default_rng(B + U), 13, B, U, P)
    got = emulate_bwd_acc(sms, plan_dtype, *args)
    want = ls.lstm_bwd_acc_reference(*args)
    for name, g, w in zip(GRADS, got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=F32_TOL,
                                   err_msg=name)


def test_splits_are_exercised():
    """The shapes above include a dh product in several K chunks and a
    reduction in several K slices."""
    assert ls.rowgroup_bwd_plan(3, 40, 24, torch.bfloat16, H100_SMS).ks == 5
    assert ls.wgrad_plan(13, 3, 40, 24, H100_SMS).splits == 2
    assert ls.wgrad_plan(13, 32, 16, 8, H100_SMS).splits == 13


def test_emulation_streams_match_k2_twin():
    """The walk's dxw, m and dh streams are K2's: the reduction's inputs."""
    args = bwd_args(np.random.default_rng(3), 13, 7, 13, 9)
    acts, lens, dout, c_hist, h_hist, *weights = args
    plan = ls.rowgroup_bwd_plan(7, 13, 9, torch.float32, 2)
    got = emulate_walk(plan, acts, lens, dout, c_hist, *weights)[:3]
    want = ls.lstm_bwd_reference(acts, lens, dout, c_hist, *weights)
    for name, g, w in zip(("dxw", "m", "dh"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=F32_TOL,
                                   err_msg=name)


def test_emulation_matches_bwd_pallas_acc():
    """The emulated order against the Pallas kernel in interpreter mode, at
    the ladder's gradient tolerance (as test_torch_lstm_seq's K3 test)."""
    from test_torch_lstm_seq import P, T, U, UP
    B = 32
    d = layer_inputs(3, B)
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
    got = emulate_bwd_acc(H100_SMS, torch.float32, torch.from_numpy(acts),
                          torch.from_numpy(d["lens"]),
                          torch.from_numpy(d["dout"]), torch.from_numpy(c),
                          torch.from_numpy(h),
                          *torch_args(d, "w_h", "proj", "wi", "wf", "wo"))
    for name, g, w in zip(GRADS, got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_TOL,
                                   err_msg=name)


def test_wrapper_raises_for_other_devices():
    args = bwd_args(np.random.default_rng(0), 5, 3, 13, 9)
    before = (ls.lstm_bwd_acc.launches, ls.lstm_bwd_acc.streaming_launches)
    with pytest.raises(ValueError, match="no LSTM backward kernel"):
        ls.lstm_bwd_acc(*(a.to("meta") for a in args))
    assert (ls.lstm_bwd_acc.launches,
            ls.lstm_bwd_acc.streaming_launches) == before


# ---------------------------------------------------------------------------
# the parameter blocks
# ---------------------------------------------------------------------------

SOURCE = os.path.join(os.path.dirname(resident.__file__), os.pardir, "csrc",
                      "resident.cu")


def struct_fields(name):
    """Field names of ``struct name`` in csrc/resident.cu, in order."""
    with open(SOURCE) as f:
        text = f.read()
    body = re.search(r"struct %s \{(.*?)\n\};" % name, text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        first, *rest = (s.strip() for s in decl.split(","))
        names += [re.split(r"[\s*]+", first)[-1], *rest]
    return names


@pytest.mark.parametrize("struct", resident.PARAMS,
                         ids=lambda s: s.__name__)
def test_ctypes_params_match_the_source(struct):
    """The ctypes blocks name the C structs' fields in the same order (the
    library checks only their sizes at load)."""
    assert [n for n, _ in struct._fields_] == struct_fields(struct.__name__)
