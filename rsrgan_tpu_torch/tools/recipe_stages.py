"""What the recipe runners (``e2e_chain``, ``experiments``) share: a CLI
call that must exit 0 (its printed lines captured or not), CLI processes
started together, the recipes' prepare stage, their awk filter of an scp,
JSONL rows, a score call's summary line, and a timer of named stages."""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List

# the directory that holds the rsrgan_tpu_torch package
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# how long a process of ``run_processes`` may run
PROCESS_TIMEOUT = 600


def read_jsonl(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def filter_scp(keys_scp: str, scp: str, out: str) -> None:
    """Lines of ``scp`` whose utterance is in ``keys_scp``, in ``scp``'s
    order (the recipe's awk filter)."""
    with open(keys_scp) as f:
        keep = {line.split()[0] for line in f if line.strip()}
    with open(scp) as f, open(out, "w") as g:
        for line in f:
            if line.strip() and line.split()[0] in keep:
                g.write(line)


def call(main: Callable, argv: List[str], stage: str) -> None:
    rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"stage {stage}: {argv[:2]} returned {rc}")


def run_cli(name: str, argv: List[str]) -> int:
    """``python -m rsrgan_tpu_torch.{name} argv`` in this process: its
    exit code."""
    return importlib.import_module(f"rsrgan_tpu_torch.{name}").main(argv)


def run_processes(name: str, argvs: List[List[str]],
                  timeout: float = PROCESS_TIMEOUT) -> List[int]:
    """``python -m rsrgan_tpu_torch.{name} argv`` for every argv of
    ``argvs``, as processes started together (a recipe's ``cmd &`` ...
    ``wait``) that inherit this process's output; their exit codes. A
    process still running past ``timeout`` seconds, or when the caller
    is interrupted, is killed."""
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=PACKAGE_ROOT if not path
               else os.pathsep.join([PACKAGE_ROOT, path]))
    sys.stdout.flush()
    procs = [subprocess.Popen([sys.executable, "-m",
                               f"rsrgan_tpu_torch.{name}", *argv], env=env)
             for argv in argvs]
    deadline = time.monotonic() + timeout
    try:
        return [p.wait(timeout=max(0.0, deadline - time.monotonic()))
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def check_cli(name: str, argv: List[str], stage: str) -> None:
    """``run_cli``, which must exit 0."""
    call(lambda a: run_cli(name, a), argv, stage)


def prepare_stores(train_dir: str, val_size: int, stage: str,
                   split_seed: bool = True) -> None:
    """The recipes' ``cli.prepare`` stage over ``train_dir``'s features:
    cmvn, split (``--seed=1`` unless ``split_seed`` is false), the tr/cv
    stores and their list files, the test store and its list."""
    check_cli("cli.prepare", ["cmvn", f"--inputs={train_dir}/inputs.cmvn",
                              f"--labels={train_dir}/labels.cmvn",
                              f"--save_dir={train_dir}"], stage)
    check_cli("cli.prepare", ["split", f"--val_size={val_size}",
                              f"--data_dir={train_dir}",
                              *(["--seed=1"] if split_seed else [])], stage)
    stores = f"{train_dir}/stores"
    os.makedirs(stores, exist_ok=True)
    for sub in ("tr", "cv"):
        check_cli("cli.prepare", [
            "make-store", f"--inputs={train_dir}/{sub}/inputs.scp",
            f"--labels={train_dir}/{sub}/labels.scp",
            f"--cmvn_dir={train_dir}", f"--output_dir={stores}",
            f"--name={sub}"], stage)
        with open(f"{train_dir}/{sub}.list", "w") as f:
            f.write(f"{stores}/{sub}.rtu\n")
    check_cli("cli.prepare", ["make-store", "--test",
                              f"--inputs={train_dir}/cv/inputs.scp",
                              f"--cmvn_dir={train_dir}",
                              f"--output_dir={stores}", "--name=test"], stage)
    with open(f"{train_dir}/test.list", "w") as f:
        f.write(f"{stores}/test.rtu\n")


def capture_cli(name: str, argv: List[str], stage: str) -> str:
    """``check_cli`` with its printed lines captured and returned (passed
    on where it fails)."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            check_cli(name, argv, stage)
    except Exception:
        sys.stdout.write(buf.getvalue())
        raise
    return buf.getvalue()


def score_summary(argv: List[str]) -> dict:
    """One ``cli.score`` call; its output passes through, and its last
    line, the summary JSON, is returned."""
    out = capture_cli("cli.score", argv, "score")
    sys.stdout.write(out)
    return json.loads(out.strip().splitlines()[-1])


class StageTimer:
    """``with timer.stage(name):`` times a stage into ``secs[name]`` (a
    stage entered again adds to its time) inside ``context(name)``, the
    caller's wrapper (chip_smoke.py counts kernel launches in it)."""

    def __init__(self, context: Callable = contextlib.nullcontext):
        self.context = context
        self.secs: Dict[str, float] = {}
        self.t0 = time.monotonic()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.monotonic()
        with self.context(name):
            yield
        self.secs[name] = self.secs.get(name, 0.0) + time.monotonic() - t0

    def seconds(self) -> float:
        return time.monotonic() - self.t0
