"""The experiment recipes through the port (tools/experiments.py) on the
CPU.

(a) The recipes' own shell, run unchanged over all their stages with a
    recording ``python`` (and a ``sleep`` that returns at once) first on
    PATH, gives the runner's calls letter for letter: every CLI, the
    tools/ scripts (the port's ``tools.*`` modules), the corpus
    generators' keywords (the heredoc run against recording stand-ins)
    and the verdict and gate heredocs' arguments, each with its
    ABLATION_* environment; the module prefix and ``--device`` aside.
    The runner's calls are recorded by replacing
    ``recipe_stages.run_cli``, the generators and the verdicts; both
    recorders leave the files the recipes' next steps read.
(b) The gate heredocs of run_ema_check.sh and run_synth_quality.sh, cut
    out of the shell files and run on the runner's inputs, give the
    runner's verdicts.
(c) ``--recipe=ablation`` stages 0-8 on a CPU-sized corpus with the
    recipe's own flagship flags: every system's row, the two-call GAN
    schedule's restore, and stage 7's JSONL and stage 8's table against
    ``rsrgan_tpu.cli.score`` and ``tools/ablation_table.py`` on the
    port's own arks and waves.
"""

import contextlib
import inspect
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from rsrgan_tpu_torch.tools import experiments
from rsrgan_tpu_torch.tools import recipe_stages

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHIM = """#!{python}
import json, os, sys
argv = sys.argv[1:]
program = sys.stdin.read() if argv[:1] == ["-"] else None
"""

SHIM_MAIN = """
call = shell_call(argv, program)
with open(os.environ["SHIM_LOG"], "a") as f:
    f.write(json.dumps([call, ablation_env(os.environ)]) + "\\n")
fake_outputs(call)
"""

# where the port's module differs from the recipes' (a tools/ script)
SHELL_NAME = {"tools.proxy_asr": "tools/proxy_asr.py",
              "tools.ablation_table": "tools/ablation_table.py"}
# the calls that compute on the device: the runner adds --device there
ON_DEVICE = {"rsrgan_tpu.cli.train", "rsrgan_tpu.cli.extract",
             "tools/proxy_asr.py"}


def ablation_env(environ):
    return {k: v for k, v in environ.items() if k.startswith("ABLATION_")}


def shell_call(argv, program):
    """A recorded ``python`` call as [module or script, args...]; a
    heredoc that makes a corpus runs against recording stand-ins of its
    generator (["make_sim_assets", [args], {kwargs}]); another heredoc
    (a verdict or a gate) is ["heredoc", args...]."""
    if argv[:1] == ["-m"]:
        return argv[1:]
    if argv[:1] != ["-"]:
        return argv
    if "make_sim_assets" not in program and \
            "make_synthetic_corpus" not in program:
        return ["heredoc", *argv[1:]]
    import types
    seen = []
    for mod in ("rsrgan_tpu", "rsrgan_tpu.sim", "rsrgan_tpu.data",
                "rsrgan_tpu.data.synthetic"):
        sys.modules[mod] = types.ModuleType(mod)
    for mod, fn in (("rsrgan_tpu.sim", "make_sim_assets"),
                    ("rsrgan_tpu.data.synthetic", "make_synthetic_corpus")):
        setattr(sys.modules[mod], fn,
                lambda *a, _fn=fn, **k: seen.append([_fn, list(a), k]))
    sys.argv = argv
    exec(program, {"__name__": "__main__"})
    return seen[0]


def fake_outputs(call):
    """What a recorded call leaves behind for the recipe's next steps: a
    corpus's directory and clean wav.scp; a train call's --save_dir and,
    on --decode, test/feats.scp (absolute ark paths, as the decode CLI
    writes them); simulate's wav.scp and extract's NAME.scp (and
    NAME.cmvn with --accumulate_cmvn); split's cv/inputs.scp; the
    coordinator process of a multi-process train call its checkpoint
    pointer and eval rows."""
    kw = dict(a[2:].split("=", 1) for a in call[1:]
              if isinstance(a, str) and a.startswith("--") and "=" in a)

    def write(path, lines):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.writelines(f"{line}\n" for line in lines)
    if call[0] == "make_sim_assets":
        write(f"{call[1][0]}/clean/wav.scp", ["u1 c1.wav", "u2 c2.wav"])
    elif call[0] == "make_synthetic_corpus":
        os.makedirs(call[1][0], exist_ok=True)
    elif "save_dir" in kw and call[0].endswith("cli.train"):
        os.makedirs(kw["save_dir"], exist_ok=True)
        if kw.get("process_id") == "0":   # the coordinator writes
            write(f"{kw['save_dir']}/checkpoint", ["TP-1.ckpt"])
            write(f"{kw['save_dir']}/metrics_eval.jsonl", ["{}", "{}"])
        if "--decode" in call:
            d = f"{kw['save_dir']}/test"
            write(f"{d}/feats.scp", [f"u1 {d}/feats.ark:6",
                                     f"u2 {d}/feats.ark:900"])
    elif "wav_scp" in kw and "output_dir" in kw:
        name = kw.get("name", "wav")
        write(f"{kw['output_dir']}/{name}.scp", ["u1 x:1", "u2 x:2"])
        if "--accumulate_cmvn" in call:
            write(f"{kw['output_dir']}/{name}.cmvn", ["stats"])
    elif call[1:2] == ["split"]:
        write(f"{kw['data_dir']}/cv/inputs.scp", ["u1 x:1"])
        os.makedirs(f"{kw['data_dir']}/tr", exist_ok=True)


def shell_calls(tmp_path, recipe, argv, env):
    """The recipe's shell under the recording shims: every ``python``
    call as ``shell_call`` gives it, beside its ABLATION_* environment."""
    bin_dir = tmp_path / "shims"
    bin_dir.mkdir(exist_ok=True)
    (bin_dir / "python").write_text(
        SHIM.format(python=sys.executable)
        + "".join(inspect.getsource(f) + "\n" for f in (
            ablation_env, shell_call, fake_outputs)) + SHIM_MAIN)
    (bin_dir / "sleep").write_text("#!/bin/sh\nexit 0\n")
    for f in bin_dir.iterdir():
        f.chmod(0o755)
    log = tmp_path / f"{recipe}.log"
    proc = subprocess.run(
        ["bash", os.path.join(REPO, "recipes", f"run_{recipe}.sh"), *argv],
        env={**{k: v for k, v in os.environ.items()
                if not k.startswith("ABLATION_")}, **env,
             "SHIM_LOG": str(log), "TPU_HANDOFF_SLEEP": "0",
             "PATH": f"{bin_dir}:{os.environ['PATH']}"},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return [json.loads(line) for line in log.read_text().splitlines()]


def runner_calls(monkeypatch, argv):
    """The runner's calls as the shell's: each CLI as [the JAX package's
    module or the tools/ script, args...] (``--device`` taken off, and
    checked to be on exactly the calls that compute on the device), the
    corpus generators and the verdict and gate (the heredocs' work) as
    ``shell_call`` records them; beside each, its ABLATION_*
    environment."""
    from rsrgan_tpu_torch import sim
    from rsrgan_tpu_torch.data import synthetic
    calls = []

    def record(call):
        calls.append([call, ablation_env(os.environ)])
        fake_outputs(call)

    def cli(name, args):
        device = args[-1:] == ["--device=cpu"]
        module = SHELL_NAME.get(name, f"rsrgan_tpu.{name}")
        assert device == (module in ON_DEVICE), (module, args)
        record([module, *args[:len(args) - device]])
        return 0

    def generator(fn):
        return lambda *a, **k: record([fn, list(a), k])

    def heredoc(ret):
        def f(*a):
            record(["heredoc", *map(str, a)])
            return ret
        return f
    monkeypatch.setattr(recipe_stages, "run_cli", cli)
    monkeypatch.setattr(recipe_stages, "run_processes",
                        lambda name, argvs: [cli(name, a) for a in argvs])
    monkeypatch.setattr(sim, "make_sim_assets", generator("make_sim_assets"))
    monkeypatch.setattr(synthetic, "make_synthetic_corpus",
                        generator("make_synthetic_corpus"))
    monkeypatch.setattr(experiments, "ema_verdict",
                        heredoc({"verdict": "EMA_OK"}))
    monkeypatch.setattr(experiments, "synth_verdict",
                        heredoc({"line": "", "passed": True}))
    for k in ablation_env(os.environ):
        monkeypatch.delenv(k)
    assert experiments.main(argv + ["--device=cpu"]) == 0
    return calls


def rooted(obj, roots):
    text = json.dumps(obj)
    for r in roots:
        text = text.replace(str(r), "ROOT")
    return json.loads(text)


def lps_corpus(root):
    """The files ablation_mfcc copies from an ablation workdir."""
    for f in ("inputs.scp", "inputs.cmvn"):
        os.makedirs(f"{root}/abl/data/train", exist_ok=True)
        open(f"{root}/abl/data/train/{f}", "w").write("u1 x:1\n")


RECIPE_CASES = {
    # run_ablation.sh stages 0-8: the weight x seed cross and GAN_COND
    "ablation": (
        lambda w: [f"{w}/abl", "40", "4", "18 20", "20 25"],
        {"SEEDS": "777 778", "MSE_WEIGHTS": "3 10", "GAN_COND": "1"},
        lambda w: [f"--workdir={w}/abl", "--num_utts=40", "--val_size=4",
                   "--seeds=777 778", "--mse_weights=3 10",
                   "--gan_cond=1"], 8 + 2 + 6),
    # run_ablation_mfcc.sh stages 0-6, three seeds (the table's rows
    # seed by seed)
    "ablation_mfcc": (
        lambda w: [f"{w}/abl", f"{w}/mfcc", "200", "3 4", "5 6"],
        {"SEEDS": "777 778 779"},
        lambda w: [f"--lps_workdir={w}/abl", f"--workdir={w}/mfcc",
                   "--gan_epochs=3 4", "--mse_epochs=5 6",
                   "--seeds=777 778 779"], 6 + 3 + 6),
    # run_ref_scale.sh stages 0-8, the rotation flags not at defaults
    "ref_scale": (
        lambda w: [f"{w}/ref"],
        {"NUM_UTTS": "50", "VAL_SIZE": "5", "ROT_BLOCK": "2",
         "PREFETCH": "false", "SEED": "5", "GAN_EPOCHS": "2 3",
         "MSE_EPOCHS": "4 5"},
        lambda w: [f"--workdir={w}/ref", "--num_utts=50", "--val_size=5",
                   "--rot_block=2", "--prefetch=false", "--seed=5",
                   "--gan_epochs=2 3", "--mse_epochs=4 5"], 2 + 1 + 2),
    # run_synth_quality.sh: corpus, prepare, train, decode, gate
    "synth_quality": (
        lambda w: [f"{w}/q", "7"], {},
        lambda w: [f"--workdir={w}/q", "--iters=7"], 2),
}


@pytest.mark.parametrize("recipe", list(RECIPE_CASES))
def test_recipe_calls_letter_for_letter(tmp_path, monkeypatch, recipe):
    """Every call of the recipe's stages, in order: the CLIs, the tools/
    scripts, the corpus generator's keywords and the heredocs' arguments,
    each with its ABLATION_* environment."""
    shell_argv, env, runner_argv, n_train = RECIPE_CASES[recipe]
    sh_root, run_root = tmp_path / "sh", tmp_path / "run"
    for root in (sh_root, run_root):
        lps_corpus(root)
    want = shell_calls(tmp_path, recipe, shell_argv(sh_root), env)
    got = runner_calls(monkeypatch,
                       [f"--recipe={recipe}", *runner_argv(run_root)])
    assert rooted(got, [run_root]) == rooted(want, [sh_root])
    modules = [c[0] for c, _ in want]
    assert modules.count("rsrgan_tpu.cli.train") == n_train
    assert {"rsrgan_tpu.cli.prepare", "rsrgan_tpu.cli.train"} <= set(modules)
    if recipe != "synth_quality":
        assert {"rsrgan_tpu.cli.extract", "rsrgan_tpu.cli.score",
                "tools/proxy_asr.py", "tools/ablation_table.py"
                } <= set(modules)
        tables = [e for c, e in want if c[0] == "tools/ablation_table.py"]
        assert tables == [{
            "ablation": {},
            "ablation_mfcc": {"ABLATION_MIN_ESTOI_DELTA": "-1",
                              "ABLATION_MAX_LSD_RATIO": "0.9"},
            "ref_scale": {"ABLATION_MIN_ESTOI_DELTA": "-1",
                          "ABLATION_MAX_LSD_RATIO": "0.9"}}[recipe]]
    else:
        assert modules[0] == "make_synthetic_corpus"
        assert modules[-1] == "heredoc"


def test_ema_check_calls_and_scp_rewrite(tmp_path, monkeypatch):
    """run_ema_check.sh stages 0-3: the train call, the raw and EMA
    decodes with each decode's test/ renamed and its feats.scp
    rewritten, the two scores and the verdict heredoc's arguments."""
    sh, run = tmp_path / "sh", tmp_path / "run"
    want = shell_calls(tmp_path, "ema_check",
                       [f"{sh}/abl", f"{sh}/ema"], {"iters": "4"})
    calls = runner_calls(monkeypatch, [
        "--recipe=ema_check", f"--lps_workdir={run}/abl",
        f"--workdir={run}/ema", "--iters=4"])
    assert [c[0] for c, _ in want] == [
        "rsrgan_tpu.cli.train"] * 3 + ["rsrgan_tpu.cli.score"] * 2 + [
        "heredoc"]
    assert rooted(calls, [run]) == rooted(want, [sh])
    for v in ("raw", "ema"):
        scps = [open(f"{root}/ema/exp/gan_ema/test_{v}/feats.scp").read()
                .replace(str(root), "ROOT") for root in (sh, run)]
        assert scps[0] == scps[1]
        assert f"ROOT/ema/exp/gan_ema/test_{v}/feats.ark:6" in scps[0]
    assert not os.path.exists(f"{run}/ema/exp/gan_ema/test")


def heredoc(recipe: str) -> str:
    """The last ``python - ... <<'EOF'`` program of a recipe."""
    with open(os.path.join(REPO, "recipes", f"run_{recipe}.sh")) as f:
        text = f.read()
    start = text.rindex("<<'EOF'\n") + len("<<'EOF'\n")
    return text[start:text.index("\nEOF", start)] + "\n"


def run_heredoc(recipe, *args):
    return subprocess.run(
        [sys.executable, "-", *map(str, args)], input=heredoc(recipe),
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"})


@pytest.mark.parametrize("ema_scale", [0.9, 1.015, 1.3])
def test_ema_verdict_equals_heredoc(tmp_path, ema_scale):
    rng = np.random.default_rng(int(ema_scale * 100))
    w, exp = tmp_path, tmp_path / "exp"
    exp.mkdir()
    raw = rng.uniform(2, 4, size=12)
    for v, scale in (("raw", 1.0), ("ema", ema_scale)):
        with open(w / f"feats_{v}.jsonl", "w") as f:
            for i, m in enumerate(raw):
                f.write(json.dumps({
                    "utt_id": f"u{i}", "lsd_db": 7 + m * scale,
                    "mse": None if i == 5 else float(m * scale),
                    "gv_ratio": 0.9}) + "\n")
    with open(exp / "metrics_train.jsonl", "w") as f:
        for i in range(4):
            f.write(json.dumps({"iteration": i + 1, "g_loss": 1.0}) + "\n")
    proc = run_heredoc("ema_check", w, exp, 4)
    assert proc.returncode == 0, proc.stderr
    want = json.loads((w / "ema_check.json").read_text())
    got = experiments.ema_verdict(str(w), str(exp), 4)
    assert got == want == json.loads(proc.stdout)
    assert got["verdict"] == ("EMA_OK" if ema_scale <= 1.02
                              else "EMA_WORSE")


@pytest.mark.parametrize("noise", [0.2, 5.0])
def test_synth_gate_equals_heredoc(tmp_path, noise):
    from rsrgan_tpu_torch.data import ArkWriter
    rng = np.random.default_rng(int(noise * 10))
    train_dir, save_dir = tmp_path / "data", tmp_path / "exp"
    (train_dir / "cv").mkdir(parents=True)
    (save_dir / "test").mkdir(parents=True)
    clean = {f"u{i}": (rng.normal(size=(40 + 9 * i, 40)) * (1 + i))
             .astype(np.float32) for i in range(6)}
    for scp, mats in ((train_dir / "cv" / "labels.scp", clean),
                      (save_dir / "test" / "feats.scp",
                       {u: (y + noise * rng.normal(size=y.shape))
                        .astype(np.float32) for u, y in clean.items()})):
        w = ArkWriter(str(scp))
        for u, m in mats.items():
            w.write_next_utt(str(scp).replace(".scp", ".ark"), u, m)
        w.close()
    proc = run_heredoc("synth_quality", train_dir, save_dir)
    got = experiments.synth_verdict(str(train_dir), str(save_dir))
    assert proc.stdout.splitlines()[0] == got["line"]
    assert (proc.returncode == 0) == got["passed"] == (noise < 1)
    assert ("QUALITY CHECK PASSED" in proc.stdout) == got["passed"]


@pytest.fixture(scope="module")
def micro_ablation(tmp_path_factory):
    """Stages 0-8 of --recipe=ablation at 10 utterances of 1.0-1.5 s,
    seeds 777 and 778, the conditioned D, one epoch a call; the main GAN
    calls' restore points as the port and JAX would find them."""
    from rsrgan_tpu.training.checkpoints import \
        latest_checkpoint as jax_latest
    from rsrgan_tpu_torch.training.checkpoints import latest_checkpoint

    w = str(tmp_path_factory.mktemp("micro") / "abl")
    restores = []
    run_cli = recipe_stages.run_cli

    def spy(name, argv):
        if "--d_learning_rate=0.0003" in argv:   # the main GAN call
            save = next(a.split("=", 1)[1] for a in argv
                        if a.startswith("--save_dir="))
            restores.append((latest_checkpoint(save, "GAN_RNN"),
                             jax_latest(save, "GAN_RNN")))
        return run_cli(name, argv)
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(buf):
        mp.setattr(recipe_stages, "run_cli", spy)
        rc, res = experiments.run_recipe(
            experiments.build_parser().parse_args([
                "--recipe=ablation", f"--workdir={w}", "--num_utts=10",
                "--val_size=2", "--gan_epochs=1 1", "--mse_epochs=1 1",
                "--seeds=777 778", "--gan_cond=1", "--device=cpu"]),
            assets=dict(min_dur_s=1.0, max_dur_s=1.5, num_rooms=1,
                        rirs_per_room=1))
    return dict(w=w, rc=rc, res=res, out=buf.getvalue(),
                restores=restores)


def test_ablation_micro_run_against_jax_scoring(micro_ablation, tmp_path,
                                                 capsys):
    """The micro run's systems, the two-call schedule, and stage 7's
    JSONL and stage 8's table against the JAX scorer and the original
    table on the port's arks and waves."""
    from rsrgan_tpu.cli import score as jax_score
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import ablation_table as ref_table

    w, rc, res, out, restores = (micro_ablation[k] for k in (
        "w", "rc", "res", "out", "restores"))
    names = ["gan", "gan_w10_s778", "mse", "mse_s778", "gan_cond"]
    assert sorted(res["systems_trained"]) == sorted(names)
    assert list(res["stage_seconds"]) == [
        "0_assets", "1_simulate", "2_extract", "3_prepare", "4_train_gan",
        "5_train_mse", "6_decode", "7_score", "7_proxy", "8_table"]

    # the two-call schedule: the main run restores the warm-up's
    # checkpoint, the file JAX's CLI would restore, and counts its
    # epochs from 1 at its own d_lr
    assert len(restores) == 3 and all(p == j and p for p, j in restores)
    assert out.count("[*] Load SUCCESS (checkpoint)") == 3
    for name in ("gan", "gan_w10_s778", "gan_cond"):
        rows = recipe_stages.read_jsonl(
            f"{w}/exp/{name}_res_lstm_l/metrics_train.jsonl")
        assert [(r["iteration"], r["d_lr"]) for r in rows] == [
            (1, pytest.approx(0.001)), (1, pytest.approx(0.0003))]
        assert res["systems_trained"][name]["rows"] == 2
    assert res["systems_trained"]["mse"]["rows"] == 1

    # the table: every system's row and label; the two seeds differ
    table = open(f"{w}/ablation.md").read()
    for label in ("no enhancement", "MSE (run_rnn.sh schedule)",
                  "LSGAN (flagship schedule)", "LSGAN(w=10,seed=778)",
                  "MSE(seed=778)", "LSGAN+condD(w=10,seed=777)",
                  "LSGAN mean±spread (2 seeds)",
                  "MSE mean±spread (2 seeds)"):
        assert f"| {label} | " in table
    systems = res["systems"]
    assert set(names + ["noisy"]) <= set(systems)
    assert systems["gan"]["mse"] != systems["gan_w10_s778"]["mse"]
    assert all(np.isfinite(systems[n]["lsd_db"]) for n in names)
    assert all(systems[n]["proxy_fer"] is not None for n in names)
    assert rc == (0 if res["passed"] else 1)

    # stage 7: the JAX scorer on the port's arks and waves
    train_dir = f"{w}/data/train"
    ref = tmp_path / "jax"
    ref.mkdir()
    capsys.readouterr()
    jobs = [("feats", "noisy", f"{train_dir}/cv/inputs.scp",
             f"{train_dir}/cv/labels.scp"),
            ("wav", "noisy", f"{w}/cv_noisy_wav.scp",
             f"{w}/cv_clean_wav.scp")]
    for n in names:
        d = f"{w}/exp/{n}_res_lstm_l/test"
        jobs += [("feats", n, f"{d}/feats.scp",
                  f"{train_dir}/cv/labels.scp"),
                 ("wav", n, f"{d}/wav/wav.scp", f"{w}/cv_clean_wav.scp")]
    for mode, n, est, refscp in jobs:
        assert jax_score.main(["--mode", mode, f"--est_scp={est}",
                               f"--ref_scp={refscp}",
                               f"--per_utt={ref}/{mode}_{n}.jsonl"]) == 0
        assert (open(f"{ref}/{mode}_{n}.jsonl").read()
                == open(f"{w}/{mode}_{n}.jsonl").read())
    capsys.readouterr()

    # stage 8: tools/ablation_table.py on the same dumps and proxy.json
    shutil.copy(f"{w}/proxy.json", ref)
    extra = ["--extra=gan_w10_s778:LSGAN(w=10,seed=778)",
             "--extra=mse_s778:MSE(seed=778)",
             "--extra=gan_cond:LSGAN+condD(w=10,seed=777)",
             "--aggregate=LSGAN mean±spread (2 seeds):gan,gan_w10_s778",
             "--aggregate=MSE mean±spread (2 seeds):mse,mse_s778"]
    assert ref_table.main([str(ref), f"--train_dir={train_dir}",
                           f"--gan_dir={w}/exp/gan_res_lstm_l",
                           f"--mse_dir={w}/exp/mse_res_lstm_l",
                           *extra]) == rc
    for f in ("ablation.md", "ablation.json"):
        assert open(f"{ref}/{f}", "rb").read() == open(f"{w}/{f}",
                                                       "rb").read()
    assert res["derived"] == json.load(open(f"{w}/ablation.json"))[
        "derived"]


def test_mfcc_and_ema_on_the_ablation_corpus(micro_ablation, tmp_path):
    """ablation_mfcc (stages 0-6: MFCC labels and the noisy MFCC over the
    ablation's waves, its table renamed on a pass) and ema_check (one
    iteration; the raw and EMA decodes under their own names, each
    feats.scp rewritten to them) on the micro run's corpus."""
    from rsrgan_tpu_torch.data import ScpReader
    lps = micro_ablation["w"]
    mfcc, ema = str(tmp_path / "mfcc"), str(tmp_path / "ema")
    rc, res = experiments.run_recipe(experiments.build_parser().parse_args([
        "--recipe=ablation_mfcc", f"--lps_workdir={lps}",
        f"--workdir={mfcc}", "--val_size=2", "--gan_epochs=1 1",
        "--mse_epochs=1 1", "--device=cpu"]))
    assert list(res["stage_seconds"]) == [
        "0_extract", "1_prepare", "2_train_gan", "3_train_mse",
        "4_decode", "5_score", "5_proxy", "6_table"]
    assert (res["max_lsd_ratio"], res["min_estoi_delta"]) == (0.9, -1.0)
    table = "ablation_mfcc" if rc == 0 else "ablation"
    assert res["table_json"] == f"{mfcc}/{table}.json"
    assert os.path.exists(f"{mfcc}/{table}.md")
    assert rc == (0 if res["derived"]["gan_lsd_ratio"] < 0.9 else 1)
    for name in ("noisy", "gan", "mse"):
        assert "estoi" not in res["systems"][name]
        assert np.isfinite(res["systems"][name]["lsd_db"])
        assert res["systems"][name]["proxy_fer"] is not None
    for u, m in ScpReader(f"{mfcc}/exp/gan_res_lstm_l/test/feats.scp"):
        assert m.shape[1] == 40 and np.isfinite(m).all()

    rc, res = experiments.run_recipe(experiments.build_parser().parse_args([
        "--recipe=ema_check", f"--lps_workdir={lps}", f"--workdir={ema}",
        "--iters=1", "--device=cpu"]))
    verdict = json.load(open(f"{ema}/ema_check.json"))
    assert rc == 0 and res["verdict"] == verdict
    assert verdict["train_iterations_run"] == 1
    exp = f"{ema}/exp/gan_ema"
    assert not os.path.exists(f"{exp}/test")
    decodes = {}
    for v in ("raw", "ema"):
        with open(f"{exp}/test_{v}/feats.scp") as f:
            assert all(f"{exp}/test_{v}/" in line for line in f)
        decodes[v] = dict(iter(ScpReader(f"{exp}/test_{v}/feats.scp")))
        rows = recipe_stages.read_jsonl(f"{ema}/feats_{v}.jsonl")
        assert verdict[v]["feature_mse"] == pytest.approx(
            np.mean([r["mse"] for r in rows]), rel=1e-12)
    assert decodes["raw"].keys() == decodes["ema"].keys()
    assert any(not np.array_equal(decodes["raw"][u], decodes["ema"][u])
               for u in decodes["raw"])


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        experiments.main(["--recipe=synth_quality", "--workdir=unused"])
    assert not os.path.exists("unused")
