"""``recipes/run_multihost.sh`` through the port
(``tools.experiments --recipe=multihost``) on the CPU.

* The recipe's own shell under the recording ``python`` of
  tests/test_torch_experiments.py gives the runner's calls letter for
  letter: the corpus generator's keywords, the ``prepare`` calls and the
  two training processes (the coordinator's free port aside; the shell
  starts them in the background, so they are compared by
  ``--process_id``).
* The recipe's two processes (``--coordinator_address``) against the
  port's one-process ``--num_gpu=2`` at the same flags, and the same with
  ``--batch_norm`` (BatchNorm's moments of the global batch then cross
  the processes): the last eval ``g_loss`` within rtol 1e-4
  (tests/test_multihost.py's tolerance), every row within it, and only
  rank 0 writes (the same files as the one-process run, one metrics row
  an iteration, one events file a split).
"""

import contextlib
import io
import json
import os
import re

import numpy as np
import pytest
import torch

import test_torch_experiments as te
from rsrgan_tpu_torch.cli import train as port_train
from rsrgan_tpu_torch.parallel import free_port
from rsrgan_tpu_torch.tools import experiments, recipe_stages

torch.set_num_threads(2)


def normalized(calls):
    """Calls with the coordinator's port taken out and the two training
    processes in ``--process_id`` order."""
    calls = json.loads(re.sub(r"localhost:\d+", "localhost:PORT",
                              json.dumps(calls)))
    train = [c for c in calls if "--num_processes=2" in c[0]]
    rest = [c for c in calls if "--num_processes=2" not in c[0]]
    return rest + sorted(train, key=lambda c: c[0][-1])


def test_multihost_calls_letter_for_letter(tmp_path, monkeypatch):
    """The corpus, cmvn, split, two make-store calls and the two
    processes, each with the recipe's flags."""
    sh_root, run_root = tmp_path / "sh", tmp_path / "run"
    want = te.shell_calls(tmp_path, "multihost", [str(sh_root)], {})
    got = te.runner_calls(monkeypatch, ["--recipe=multihost",
                                        f"--workdir={run_root}"])
    assert normalized(te.rooted(got, [run_root])) == normalized(
        te.rooted(want, [sh_root]))
    modules = [c[0] for c, _ in want]
    assert modules == ["make_synthetic_corpus"] + [
        "rsrgan_tpu.cli.prepare"] * 4 + ["rsrgan_tpu.cli.train"] * 2
    assert sorted(c[-1] for c, _ in want[-2:]) == ["--process_id=0",
                                                   "--process_id=1"]


def rows(save_dir, split):
    with open(os.path.join(save_dir, f"metrics_{split}.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    """The recipe on the CPU: its workdir, exit code and printed lines
    (the processes' own output is not among them)."""
    w = tmp_path_factory.mktemp("multihost") / "w"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = experiments.main(["--recipe=multihost", f"--workdir={w}",
                               "--device=cpu"])
    return str(w), rc, buf.getvalue()


def two_processes(data_dir, save_dir, *extra):
    """The recipe's two processes at ``extra`` flags: their exit codes."""
    common = experiments.multihost_flags(data_dir, save_dir, free_port())
    return recipe_stages.run_processes("cli.train", [
        [*common, *extra, f"--process_id={i}", "--device=cpu"]
        for i in range(2)])


def num_gpu_2(data_dir, save_dir, *extra):
    """The same flags in one process, ``--num_gpu=2`` (two spawned
    ranks), no coordinator."""
    flags = [f for f in experiments.multihost_flags(data_dir, save_dir, 0)
             if not f.startswith(("--coordinator_address",
                                  "--num_processes"))]
    return port_train.main([*flags, *extra, "--num_gpu=2", "--device=cpu"])


@pytest.mark.parametrize("batch_norm", [False, True])
def test_two_processes_match_num_gpu_2(recipe, tmp_path, batch_norm):
    """The last eval g_loss within rtol 1e-4 of the one-process run's
    (every row's losses too), the same files in both directories, one
    metrics row an iteration."""
    w, rc, _ = recipe
    assert rc == 0
    data_dir = os.path.join(w, "data")
    if batch_norm:
        multi = str(tmp_path / "multi")
        assert two_processes(data_dir, multi, "--batch_norm=true") == [0, 0]
        extra = ("--batch_norm=true",)
    else:
        multi, extra = os.path.join(w, "exp"), ()
    single = str(tmp_path / "single")
    assert num_gpu_2(data_dir, single, *extra) == 0
    assert sorted(os.listdir(multi)) == sorted(os.listdir(single))
    for split in ("train", "eval"):
        got, want = rows(multi, split), rows(single, split)
        assert len(got) == len(want) == 2
        for g, r in zip(got, want):
            for k, v in r.items():
                if k.endswith("loss"):
                    np.testing.assert_allclose(g[k], v, rtol=1e-4,
                                               err_msg=(split, k))
    np.testing.assert_allclose(rows(multi, "eval")[-1]["g_loss"],
                               rows(single, "eval")[-1]["g_loss"],
                               rtol=1e-4)


def test_recipe_passes_and_only_rank_0_writes(recipe):
    """Exit 0, the PASSED line with the eval rows' count, the result
    line's two exit codes; rank 0's files only: a checkpoint pointer,
    checkpoints, one events file per split, one metrics row an
    iteration."""
    w, rc, printed = recipe
    save_dir = os.path.join(w, "exp")
    assert rc == 0 and os.path.isfile(os.path.join(save_dir, "checkpoint"))
    assert "MULTIHOST RUN PASSED (2 eval records)" in printed
    result = json.loads(printed.strip().splitlines()[-1])
    assert result["exit_codes"] == [0, 0] and result["passed"]
    assert [f for f in os.listdir(save_dir) if f.endswith(".ckpt")]
    for split in ("train", "eval"):
        assert len(os.listdir(os.path.join(save_dir, split))) == 1
        assert len(rows(save_dir, split)) == 2
