"""The control: the plain reference put in the program's place with its
products in float8 (the precision below the configuration's bfloat16)
has to come out not ``correct`` under the committed limits, while the
program comes out ``correct``. On the card at each cell's own size
(``-m cuda``); here on the CPU at the cell's widths on a short corpus
(the control's gap grows with the widths its products sum over: at
8-wide inputs it stays within the limits)."""

import time

import pytest
from bench_tiny import tiny_cell, tiny_ctx

from benchmark import calibrate, check, harness
from benchmark.trace import Tracer

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


def verdicts(ctx):
    got = calibrate.readings(ctx, True, False)
    limits = ctx.cell.workload["limits"]
    return ({c["name"]: c["ok"] for c in check.judge(got[k], limits)}
            for k in ("program", "control"))


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_a_short_corpus(name):
    _, control = verdicts(tiny_ctx(tiny_cell(name, widths=True), seed=21))
    assert not all(control.values()), control


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(card, name):
    ctx = harness.Ctx(cell=harness.cell(name), seed=2 ** 31 + 99,
                      seconds=0.0, tracer=Tracer(False, card), device=card,
                      t0=time.monotonic())
    program, control = verdicts(ctx)
    assert all(program.values()), program
    assert not all(control.values()), control
