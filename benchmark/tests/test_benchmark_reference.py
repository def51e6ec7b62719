"""The plain reference against the program at a tiny size on the CPU,
both in f32 (``--bf16=False``): the same mathematics in another order, so
the gaps are rounding. Adam's first step takes the sign of each
gradient, so a near-zero one moves its element by a whole step either
way: the change is held more loosely than the losses and gradients."""

import pytest
from bench_tiny import tiny_cell, tiny_ctx

from benchmark import calibrate


@pytest.mark.parametrize("name", ["gan_b8", "mse_b16"])
def test_training_reference_matches_the_port_in_f32(name):
    got = calibrate.readings(tiny_ctx(tiny_cell(name, f32=True), seed=3),
                             False, False)["program"]
    assert got["loss_gap"] < 1e-5
    assert got["grad_gap"] < 1e-5
    assert got["change_gap"] < 1e-3


def test_decode_reference_matches_the_port_in_f32():
    got = calibrate.readings(tiny_ctx(tiny_cell("decode_b8", f32=True),
                                      seed=3), False, False)["program"]
    assert got["out_rel_rms"] < 1e-5
