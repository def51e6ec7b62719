"""The copied bound functions and the model FLOPs against numbers worked
out by hand."""

import pytest

from benchmark import harness, roofline

HBM = 3.35e12


def test_bound_takes_the_larger_side():
    b = roofline.bound(989e12, 0.0, "bfloat16")
    assert b["bound_ms"] == pytest.approx(1000.0)
    assert b["bound_by"] == "operations"
    b = roofline.bound(0.0, HBM, "float32")
    assert b["bound_ms"] == pytest.approx(1000.0)
    assert b["bound_by"] == "bytes"


def test_bwd_bound_by_hand():
    # U=2 (G=8), P=1, one row of true length 1 padded to T=2, f32
    k2 = roofline.bwd_bound(2, 1, 1, 2, [1], "float32", acc=False)
    assert k2["flops"] == 2 * 1 * 2 + 2 * 8 * 1
    # weights 40, peepholes 24, lengths 4, acts/dout/c_hist 44, dxw 64,
    # m and dh 24
    assert k2["bytes"] == 200
    k3 = roofline.bwd_bound(2, 1, 1, 2, [1], "float32", acc=True)
    assert k3["flops"] == 20 + 2 * 1 * 8 + 2 * 2 * 1
    # no m, dh; h_hist 4 and the weight gradients 96 instead
    assert k3["bytes"] == 200 - 24 + 4 + 96
    assert k3["bound_ms"] == pytest.approx(276 / HBM * 1e3)


def test_wavefront_bound_by_hand():
    b = roofline.wavefront_bound(1, 2, 1, 1, 2, [1], "float32",
                                 train=False, residual=True)
    assert b["flops"] == 2 * 1 * 8 + 2 * 2 * 1
    # weights 40, bias and peepholes 56, xw1 32, lengths 4, x 8, out 8
    assert b["bytes"] == 148
    # bf16 weights and xw1 halve
    b16 = roofline.wavefront_bound(1, 2, 1, 1, 2, [1], "bfloat16",
                                   train=False, residual=True)
    assert b16["bytes"] == 148 - 20 - 16


def test_true_steps_clip_to_the_padded_length():
    assert roofline.true_steps([3, 9, 5], 6) == 3 + 6 + 5


def test_keys_and_rows():
    assert roofline.parse_key("U=760,P=257,B=16") == {
        "U": 760, "P": 257, "B": 16}
    assert roofline.row_lengths(4, [1, 2]) == [1, 2, 1, 2]
    assert roofline.row_lengths(2, [1, 2]) == [1, 2]
    assert roofline.row_lengths(3, [1, 2]) is None


def test_model_flops_by_hand():
    cfg = harness.cell("gan_b8").config
    # G a frame: 4 layers of 2*257*3040 (x) + 2*257*3040 (h) +
    # 2*760*257 (proj), then 2*257*40
    g_fwd = 4 * (2 * 257 * 3040 * 2 + 2 * 760 * 257) + 2 * 257 * 40
    assert g_fwd == 14_083_600
    assert roofline.decode_flops(cfg) == g_fwd
    # D: 2 layers of 2*40*1024 * 2 + 2*256*40, then 2*40
    d_fwd = 2 * (2 * 40 * 1024 * 2 + 2 * 256 * 40) + 2 * 40
    assert d_fwd == 368_720
    g_bwd = 2 * g_fwd - 2 * 257 * 3040       # no gradient of the data
    d_bwd_data, d_bwd_in = 2 * d_fwd - 2 * 40 * 1024, 2 * d_fwd
    gan = (2 * g_fwd + 2 * (d_fwd + d_bwd_data)
           + 2 * (d_fwd + d_bwd_in + g_bwd))
    assert roofline.gan_iteration_flops(cfg) == gan == 85_637_280
    mse_cfg = harness.cell("mse_b16").config
    assert roofline.mse_iteration_flops(mse_cfg) == g_fwd + g_bwd \
        == 40_688_240
