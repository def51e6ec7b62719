"""The resident kernels' decomposition (csrc/resident.cu), on the CPU.

``resident_plan`` (ops/lstm_seq.py for K2, ops/wavefront.py for K4) fixes
which block owns which units and which P columns and how many bytes each
holds in shared memory; the kernels read that plan and the weight slices
packed for it. Here the plans are checked at the chip's shapes and at odd
ones, and a torch emulation that replays the kernels' order (per-block
partial products from the packed slices, then the partials summed over
the blocks in block order, then the masked carries) is held against the
plain twins in f32, with ragged lengths and a zero-length row.
"""

import numpy as np
import pytest
import torch

from rsrgan_tpu_torch.ops import lstm_seq as ls
from rsrgan_tpu_torch.ops import resident
from rsrgan_tpu_torch.ops import wavefront as wf
from rsrgan_tpu_torch.ops.wavefront_stack import _prep

torch.set_num_threads(1)

H100_SMS = 132
F32_TOL = 1e-5


def owners(bounds):
    """Every index of range(bounds[-1]) with the slice that owns it."""
    return [i for i in range(len(bounds) - 1)
            for _ in range(bounds[i], bounds[i + 1])]


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

BWD_SHAPES = [(16, 760, 257), (16, 256, 40), (1, 13, 9), (3, 13, 9),
              (33, 13, 9), (64, 760, 257), (3, 200, 7)]


@pytest.mark.parametrize("B,U,P", BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_plan_partitions(B, U, P, dtype):
    plan = ls.resident_plan(B, U, P, dtype, H100_SMS)
    assert plan.blocks == min(H100_SMS, U)
    assert owners(plan.unit_bounds) == sorted(owners(plan.unit_bounds))
    assert len(owners(plan.unit_bounds)) == U        # each unit once
    assert len(owners(plan.col_bounds)) == P         # each column once
    assert max(np.diff(plan.unit_bounds)) == plan.NU
    assert plan.smem <= resident.SMEM_CAP == 232448
    assert plan.K1 >= P and plan.K1 % 16 == 0 and plan.K2 >= 4 * plan.NU
    assert plan.Mp >= B and plan.Mp % 16 == 0
    assert all(o % resident.ALIGN == 0 for o in plan.offsets.values())
    if dtype == torch.bfloat16 or U < 300:
        assert plan.weights_resident()


@pytest.mark.parametrize("B", [1, 3, 16, 33, 64])
@pytest.mark.parametrize("L,U,P", [(4, 760, 257), (1, 13, 9), (3, 13, 9),
                                   (4, 13, 9), (1, 256, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wavefront_plan_partitions(B, L, U, P, dtype):
    plan = wf.resident_plan(B, L, U, P, dtype, H100_SMS)
    # L = 1 (K1's layer) takes SINGLE_LAYER_UNITS units a block
    nbl = (-(-U // wf.SINGLE_LAYER_UNITS[dtype]) if L == 1
           else H100_SMS // L)
    assert plan.blocks <= H100_SMS and plan.nbl == min(nbl, U)
    assert len(owners(plan.unit_bounds)) == U
    assert len(owners(plan.pair_bounds)) == L * P    # each (layer, col) once
    assert plan.NU % 2 == 0 and plan.NG == 4 * plan.NU
    assert max(np.diff(plan.unit_bounds)) <= plan.NU
    assert plan.smem <= 232448
    assert all(o % resident.ALIGN == 0 for o in plan.offsets.values())
    if dtype == torch.bfloat16:  # bf16 holds every weight slice
        assert plan.weights_resident()


@pytest.mark.parametrize("items", [1, 7, 8, 32, 128, 129, 256, 1024])
def test_threads_per_sum(items):
    """Phase B shares an output's partials between a power of two of
    neighbouring lanes (at most a warp), as many as the 256 threads of a
    block can give every output."""
    tpi = resident.threads_per_sum(items)
    assert tpi in (1, 2, 4, 8, 16, 32)
    assert tpi == 1 or items * tpi <= 256
    assert tpi == 32 or items * tpi * 2 > 256


def test_chip_shapes_fill_the_card():
    """At the main path's shapes the grids exceed 100 blocks and bf16
    keeps every weight in shared memory; f32 at full width does not fit
    its gate weights beside the staging and reads the rest through L2."""
    k2 = ls.resident_plan(16, 760, 257, torch.bfloat16, H100_SMS)
    assert k2.blocks == 132 and k2.NU == 6 and k2.weights_resident()
    for B in (1, 16, 64):
        k4 = wf.resident_plan(B, 4, 760, 257, torch.bfloat16, H100_SMS)
        assert k4.blocks == 132 and k4.NU == 24 and k4.weights_resident()
    k4f = wf.resident_plan(16, 4, 760, 257, torch.float32, H100_SMS)
    assert k4f.n_res_p == k4f.Np and 0 < k4f.n_res_g < k4f.NG


@pytest.mark.parametrize("plan_fn,args,shape", [
    (ls.resident_plan, (2048, 760, 257, torch.bfloat16, H100_SMS),
     "B=2048 U=760 P=257"),
    (wf.resident_plan, (512, 4, 760, 257, torch.bfloat16, H100_SMS),
     "B=512 L=4 U=760 P=257"),
    (wf.resident_plan, (16, 200, 13, 9, torch.float32, H100_SMS),
     "B=16 L=200 U=13 P=9"),
])
def test_plan_raises_with_the_shape(plan_fn, args, shape):
    with pytest.raises(ValueError, match=shape):
        plan_fn(*args)


# ---------------------------------------------------------------------------
# emulation of the kernels' order
# ---------------------------------------------------------------------------

def cell_reverse(dm, live, si, tj, sf, so, c_new, c_prev, dc_old, wi_, wf_,
                 wo_):
    """The peephole cell's reverse math as the kernel writes it."""
    tc = torch.tanh(c_new)
    dm = torch.where(live, dm, 0.0)
    d_o = dm * tc * so * (1.0 - so)
    dc_total = (torch.where(live, dc_old, 0.0) + dm * so * (1.0 - tc * tc)
                + d_o * wo_)
    d_f = dc_total * c_prev * sf * (1.0 - sf)
    d_i = dc_total * tj * si * (1.0 - si)
    d_j = dc_total * si * (1.0 - tj * tj)
    dc_prev = dc_total * sf + d_f * wf_ + d_i * wi_
    dg = [torch.where(live, d, 0.0) for d in (d_i, d_j, d_f, d_o)]
    return dg, torch.where(live, so * tc, 0.0), torch.where(live, dc_prev,
                                                            dc_old)


def fixed_order_sum(parts, tpi):
    """Phase B's sum over the last dim (one partial per block), in the
    kernel's order: thread t of tpi adds partials t, t + tpi, ... in turn,
    then a shuffle tree over the tpi threads."""
    lanes = []
    for t in range(tpi):
        v = torch.zeros(parts.shape[:-1])
        for j in range(t, parts.shape[-1], tpi):
            v = v + parts[..., j]
        lanes.append(v)
    s = tpi // 2
    while s:
        lanes = [lanes[t] + lanes[t ^ s] for t in range(tpi)]
        s //= 2
    return lanes[0]


def emulate_bwd(plan, acts, lengths, dout, c_hist, w_h, proj, wi_, wf_, wo_):
    """K2's resident kernel, block by block, in its order."""
    T, B, G = acts.shape
    U, P = proj.shape
    NU, nb = plan.NU, plan.blocks
    proj_pk, wh_pk = ls.pack_bwd_weights(w_h, proj, plan)
    dh = torch.zeros(B, P)
    dc = torch.zeros(B, U)            # each block's slice of it
    dxw, m_out = torch.zeros(T, B, G), torch.zeros(T, B, U)
    dh_out = torch.zeros(T, B, P)
    for t in reversed(range(T)):
        live = (t < lengths)[:, None]
        a = torch.zeros(plan.Mp, plan.ld1)
        a[:B, :P] = dout[t] + dh
        for i in range(nb):          # owners of columns write the dh stream
            c0, c1 = plan.col_bounds[i], plan.col_bounds[i + 1]
            dh_out[t, :, c0:c1] = torch.where(live, a[:B, c0:c1], 0.0)
        partials = []
        for i in range(nb):
            u0, u1 = plan.unit_bounds[i], plan.unit_bounds[i + 1]
            dm = a[:B, :plan.K1] @ proj_pk[i, :u1 - u0, :plan.K1].t()
            si, tj, sf, so = (acts[t, :, g * U + u0:g * U + u1]
                              for g in range(4))
            c_prev = c_hist[t - 1, :, u0:u1] if t else torch.zeros(B, u1 - u0)
            dg, m, dc[:, u0:u1] = cell_reverse(
                dm, live, si, tj, sf, so, c_hist[t, :, u0:u1], c_prev,
                dc[:, u0:u1], wi_[u0:u1], wf_[u0:u1], wo_[u0:u1])
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
    return dxw, m_out, dh_out


def emulate_wavefront(plan, xw1, lengths, x, wx, wh, proj, bias, wi_, wf_,
                      wo_, residual, save):
    """K4's resident kernel, block by block, in its order."""
    T, B, G = xw1.shape
    L, U, P, NU, nbl = plan.L, plan.U, plan.P, plan.NU, plan.nbl
    wg_pk, wp_pk = wf.pack_wavefront_weights(wx, wh, proj, plan)
    h = torch.zeros(L, B, P)
    c = torch.zeros(L, B, U)
    inbuf = torch.zeros(2, L, B, P)
    partial = torch.zeros(L, nbl, B, P)
    y = torch.zeros(T, B, P)
    taps, h_s = torch.zeros(L, T, B, P), torch.zeros(L, T, B, P)
    c_s, acts = torch.zeros(L, T, B, U), torch.zeros(L, T, B, G)
    for s in range(T + L - 1):
        in_cur, in_next = inbuf[s & 1], inbuf[(s + 1) & 1]
        for blk in range(plan.blocks):                       # phase A
            k, j = divmod(blk, nbl)
            t = s - k
            if not 0 <= t < T:
                continue
            u0, u1 = plan.unit_bounds[j], plan.unit_bounds[j + 1]
            a = torch.zeros(plan.Mp, plan.ldw)
            a[:B, :P] = h[k]
            if k:
                a[:B, P:2 * P] = in_cur[k]
            gates = a[:B, :plan.Kp] @ wg_pk[k, j, :, :plan.Kp].t()
            live = (t < lengths)[:, None]
            gate = [gates[:, g * NU:g * NU + u1 - u0]
                    + (xw1[t, :, g * U + u0:g * U + u1] if k == 0 else 0)
                    + bias[k, g * U + u0:g * U + u1] for g in range(4)]
            c_prev = c[k, :, u0:u1]
            si = torch.sigmoid(gate[0] + wi_[k, u0:u1] * c_prev)
            tj = torch.tanh(gate[1])
            sf = torch.sigmoid(gate[2] + wf_[k, u0:u1] * c_prev)
            c_new = sf * c_prev + si * tj
            so = torch.sigmoid(gate[3] + wo_[k, u0:u1] * c_new)
            c[k, :, u0:u1] = torch.where(live, c_new, c_prev)
            s_m = torch.zeros(plan.Mp, plan.ldm)
            s_m[:B, :u1 - u0] = so * torch.tanh(c_new)
            if save:
                c_s[k, t, :, u0:u1] = c[k, :, u0:u1]
                for g, v in enumerate((si, tj, sf, so)):
                    acts[k, t, :, g * U + u0:g * U + u1] = v
            partial[k, j] = s_m[:B, :plan.Km] @ wp_pk[k, j, :P, :plan.Km].t()
        for blk in range(plan.blocks):                       # phase B
            for pr in range(plan.pair_bounds[blk], plan.pair_bounds[blk + 1]):
                k, col = divmod(pr, P)
                t = s - k
                if not 0 <= t < T:
                    continue
                h_new = fixed_order_sum(partial[k, :, :, col].t(), plan.tpi)
                live = t < lengths
                h_prev = h[k, :, col].clone()
                h[k, :, col] = torch.where(live, h_new, h_prev)
                tap = torch.where(live, h_new, 0.0)
                if residual:
                    tap = tap + (x[t, :, col] if k == 0 else in_cur[k, :, col])
                if k + 1 < L:
                    in_next[k + 1, :, col] = tap
                elif not save:
                    y[t, :, col] = tap
                if save:
                    taps[k, t, :, col] = tap
                    h_s[k, t, :, col] = h[k, :, col]
    return (taps, c_s, h_s, acts) if save else y


T, U, P = 13, 13, 9
LENS = [13, 7, 0, 12, 1]


def layer_args(rng, B):
    """One layer's K2 inputs from its forward twin's streams."""
    def u(*shape):
        return torch.tensor(rng.uniform(-0.5, 0.5, shape),
                            dtype=torch.float32)
    lens = torch.tensor((LENS * B)[:B], dtype=torch.int32)
    xw = torch.tensor(rng.normal(0, 0.5, (T, B, 4 * U)), dtype=torch.float32)
    w_h, proj, bias, wi_, wf_, wo_ = (u(P, 4 * U), u(U, P), u(4 * U), u(U),
                                      u(U), u(U))
    _, c_hist, _, acts = ls.lstm_fwd_reference(xw, lens, w_h, proj, bias,
                                               wi_, wf_, wo_)
    dout = torch.tensor(rng.normal(size=(T, B, P)), dtype=torch.float32)
    return acts, lens, dout, c_hist, w_h, proj, wi_, wf_, wo_


@pytest.mark.parametrize("B,sms", [(5, 4), (3, 132), (1, 6), (17, 5)])
def test_bwd_emulation_matches_twin(B, sms):
    """Units that do not divide the grid evenly (13 over 4, 6, 5 blocks),
    one unit per block (132 SMs), and a zero-length row."""
    args = layer_args(np.random.default_rng(B), B)
    plan = ls.resident_plan(B, U, P, torch.float32, sms)
    got = emulate_bwd(plan, *args)
    want = ls.lstm_bwd_reference(*args)
    for name, g, w in zip(("dxw", "m", "dh"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=F32_TOL,
                                   err_msg=name)


def wavefront_args(rng, L, B):
    def u(*shape):
        return torch.tensor(rng.uniform(-0.5, 0.5, shape),
                            dtype=torch.float32)
    params = [{"kernel": u(2 * P, 4 * U), "bias": u(4 * U),
               "proj_kernel": u(U, P), "w_i_diag": u(1, U),
               "w_f_diag": u(1, U), "w_o_diag": u(1, U)} for _ in range(L)]
    x = torch.tensor(rng.normal(size=(T, B, P)), dtype=torch.float32)
    wx, wh, bias, proj, wi_, wf_, wo_ = _prep(params, P, 1.0)
    return (x @ wx[0], torch.tensor((LENS * B)[:B], dtype=torch.int32), x,
            wx[1:].contiguous(), wh, proj, bias, wi_, wf_, wo_)


@pytest.mark.parametrize("L,residual,B,sms", [
    (4, True, 5, 12), (3, False, 3, 132), (1, True, 1, 5), (1, False, 5, 7),
    (4, True, 17, 132)])
@pytest.mark.parametrize("save", [False, True])
def test_wavefront_emulation_matches_twin(L, residual, B, sms, save):
    args = wavefront_args(np.random.default_rng(10 * L + B), L, B)
    plan = wf.resident_plan(B, L, U, P, torch.float32, sms)
    got = emulate_wavefront(plan, *args, residual, save)
    want = wf.lstm_wavefront_fwd_reference(*args, residual=residual,
                                           save_acts=save)
    if not save:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.float().numpy(),
                                   atol=F32_TOL)


def test_packed_slices_hold_each_weight_once():
    """Every weight of W_h, W_x and proj sits in exactly one block's packed
    slice (the pads are zero), so the partial products sum to the full
    ones."""
    rng = np.random.default_rng(3)
    args = wavefront_args(rng, 3, 2)
    wx, wh, proj = args[3], args[4], args[5]
    plan = wf.resident_plan(2, 3, U, P, torch.float32, 10)
    wg_pk, wp_pk = wf.pack_wavefront_weights(wx, wh, proj, plan)
    for w, packed in ((wh, wg_pk[..., :P]), (wx, wg_pk[1:, ..., P:2 * P]),
                      (proj, wp_pk)):
        torch.testing.assert_close(packed.abs().sum(), w.abs().sum())
        assert int((packed != 0).sum()) == int((w != 0).sum())
    assert not wg_pk[0, ..., P:].any()               # layer 0 has no W_x
    bplan = ls.resident_plan(4, U, P, torch.float32, 5)
    proj_pk, wh_pk = ls.pack_bwd_weights(wh[0], proj[0], bplan)
    torch.testing.assert_close(proj_pk.abs().sum(), proj[0].abs().sum())
    torch.testing.assert_close(wh_pk.abs().sum(), wh[0].abs().sum())


def test_bwd_wrapper_raises_for_other_devices():
    args = layer_args(np.random.default_rng(0), 3)
    with pytest.raises(ValueError, match="no LSTM backward kernel"):
        ls.lstm_bwd(*(a.to("meta") for a in args))
