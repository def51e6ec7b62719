"""No run loads JAX or the JAX package (compared by whole top-level
names: the port's name begins with the JAX package's), and the reference
and the comparison import nothing of the program."""

import ast
import json
import os
import subprocess
import sys
import types

import pytest

from benchmark import harness

BENCH = harness.BENCH_DIR
# the yardstick's modules: what the reference and the comparison are made of
YARDSTICK = ["reference/res_lstm.py", "check.py", "weights.py",
             "roofline.py", "traffic/corpus.py"]
TINY_RUN = """
import json, sys
from bench_tiny import tiny_cell, tiny_ctx
from benchmark import harness, run
import torch
cell = tiny_cell("mse_b16", f32=True)
rc, line, _ = run.execute(harness.manifest(), cell, 5, 0.3, False,
                          torch.device("cpu"), 0.0)
tops = sorted({n.split(".")[0] for n in sys.modules})
print(json.dumps({"rc": rc, "tops": tops}))
"""


def imported(path: str):
    tree = ast.parse(open(os.path.join(BENCH, path)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("name", ["jax", "jaxlib.xla_client", "flax",
                                  "rsrgan_tpu", "rsrgan_tpu.ops.lstm"])
def test_forbidden_names_are_caught(monkeypatch, name):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert name.split(".")[0] in harness.forbidden_loaded()


@pytest.mark.parametrize("name", ["rsrgan_tpu_torch", "rsrgan_tpu_torch.ops",
                                  "jaxtyping", "flaxen"])
def test_whole_names_only(monkeypatch, name):
    for mod in [m for m in sys.modules if m.split(".")[0] in
                harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_loaded() == []


@pytest.mark.parametrize("path", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in imported(path)}
    assert not tops & {"rsrgan_tpu_torch", "rsrgan_tpu", "jax", "flax"}


def test_reference_loads_no_program_module():
    code = ("import sys, benchmark.reference.res_lstm, benchmark.check, "
            "benchmark.weights, benchmark.roofline; print(sorted({n.split('.')[0]"
            " for n in sys.modules} & {'rsrgan_tpu_torch', 'rsrgan_tpu', "
            "'jax', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_loads_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [harness.ROOT, os.path.join(BENCH, "tests")]))
    out = subprocess.run([sys.executable, "-c", TINY_RUN], cwd=harness.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0
    assert "rsrgan_tpu_torch" in got["tops"]
    assert not set(got["tops"]) & set(harness.FORBIDDEN)
