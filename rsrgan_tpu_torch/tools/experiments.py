"""The experiment recipes through the port's CLIs.

    python -m rsrgan_tpu_torch.tools.experiments --recipe=ablation \\
        [--workdir=DIR --num_utts=4000 --val_size=200 \\
         --gan_epochs="18 20" --mse_epochs="20 25" --seeds="777" \\
         --mse_weights="10" --gan_cond=0 --stage=0 --stop_stage=8]
    ... --recipe=ablation_mfcc [--lps_workdir=DIR --workdir=DIR \\
         --val_size=200 --gan_epochs=... --mse_epochs=... --seeds=...]
    ... --recipe=ref_scale [--workdir=DIR --num_utts=104000 \\
         --val_size=300 --rot_block=10 --prefetch=true --seed=777 ...]
    ... --recipe=ema_check [--lps_workdir=DIR --workdir=DIR --iters=50]
    ... --recipe=synth_quality [--workdir=DIR --iters=24]
    ... --recipe=multihost [--workdir=DIR]
    ... --recipe=micro [--workdir=DIR]

Each recipe is the shell recipe of the same name under ``recipes/``
(``run_<recipe>.sh``), stage by stage, each CLI called in this process
with the recipe's flags letter for letter and ``--device`` (default
``cuda``; ``--device=cpu`` runs the kernels' plain twins) added where a
stage computes on the device (train, decode, extract, the proxy). The
recipes' positional arguments and environment (``stage``,
``stop_stage``, ``SEEDS``, ``MSE_WEIGHTS``, ``GAN_COND``, ``NUM_UTTS``,
``ROT_BLOCK``, ``PREFETCH``, ``SEED``, ``iters``, ``LSTM_IMPL``) are the
flags above, with the recipes' defaults; the gate's thresholds are the
environment variables the recipes read (``ABLATION_MAX_LSD_RATIO``,
``ABLATION_MIN_ESTOI_DELTA``). Their sleeps and retries are dropped.

- ``ablation`` (LPS -> LPS): synthetic phone-content speech, corruption,
  LPS features, stores; the flagship LSGAN in two calls into one
  directory (a warm-up epoch at d_lr 1e-3, then the main run at 3e-4,
  which restores the warm-up's checkpoint) for the weight x seed cross,
  the conditioned-D system with ``--gan_cond=1``, the MSE baseline per
  seed; decode, resynthesis, scores and the recognition proxy; the table
  and its gate (``tools.ablation_table``).
- ``ablation_mfcc``: the same on LPS -> 40-d MFCC over an ablation
  workdir's corpus; feature scores only; table ``ablation_mfcc.*``.
- ``ref_scale``: LPS -> MFCC from compressed features, waves and the
  input ark deleted once used, training from rotating resident shards
  (``--feed_rotation_block``, ``--feed_prefetch``); table
  ``ref_scale.*``, renamed before a gate failure is returned.
- ``ema_check``: one GAN checkpoint decoded with raw and EMA parameters
  and scored; the verdict (``ema_check.json``) is printed, not gated.
- ``synth_quality``: the flagship on ``make_synthetic_corpus``; gate:
  enhanced MSE < 0.5 x the predict-the-mean MSE.
- ``multihost``: the frame DNN on a 12-utterance ``make_synthetic_corpus``
  as two processes of one data-parallel world
  (``--coordinator_address=localhost:PORT --num_processes=2
  --process_id=0|1``, a free port), started together; passes when the
  second process exits 0 (the shell's ``wait $p0 $p1``) and a checkpoint
  exists. The JAX recipe gives each process two XLA host devices (a
  4-device mesh); a process of the port is one rank, so the port's world
  is 2 ranks (global batch 16, learning rate x 2), the one-process
  ``--num_gpu=2`` run's.
- ``micro``: ``run_micro.sh``'s stages -1 to 3 and its check: a
  24-utterance ``make_synthetic_corpus`` (257 -> 40), cmvn, split, the
  tr/cv stores and the test store, the flagship at ``--batch_size=2``
  for up to 2 epochs, decode, then "6 enhanced utterances, 40-dim,
  finite". Its stage 4 (``tools/tpu_parity_check.py``, the Pallas
  kernels compiled on a TPU) is not ported: ``chip_smoke.py``'s kernel
  phases hold every hand kernel against its plain twin on the card.

Systems that are done (their ``DONE`` marker) are skipped, as in the
recipes. Prints the CLIs' output, then one JSON line: each stage's
seconds, each system's train frames/s (its ``metrics_train.jsonl``),
the table's rows, the gate's numbers and ``passed``; exits with the
recipe's code.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from rsrgan_tpu_torch.tools import recipe_stages as rs

RECIPES = ("ablation", "ablation_mfcc", "ref_scale", "ema_check",
           "synth_quality", "multihost", "micro")

# each recipe's defaults (its positional arguments and environment);
# workdirs lie under the temporary directory
DEFAULTS = {
    "ablation": dict(workdir="rsrgan_ablation", num_utts=4000,
                     val_size=200, stop_stage=8),
    "ablation_mfcc": dict(lps_workdir="rsrgan_ablation",
                          workdir="rsrgan_ablation_mfcc", val_size=200,
                          stop_stage=6),
    "ref_scale": dict(workdir="rsrgan_ref_scale", num_utts=104000,
                      val_size=300, stop_stage=8),
    "ema_check": dict(lps_workdir="rsrgan_ablation",
                      workdir="rsrgan_ema_check", iters=50, stop_stage=3),
    "synth_quality": dict(workdir="rsrgan_quality", iters=24),
    "multihost": dict(workdir="rsrgan_multihost"),
    "micro": dict(workdir="rsrgan_micro"),
}


def recipe_args(args: argparse.Namespace) -> argparse.Namespace:
    """``args`` with every unset flag at its recipe's default."""
    out = argparse.Namespace(**vars(args))
    for k, v in DEFAULTS[args.recipe].items():
        if getattr(out, k) is None:
            if k in ("workdir", "lps_workdir"):
                v = os.path.join(tempfile.gettempdir(), v)
            setattr(out, k, v)
    return out


def common_flags(train_dir: str, output_dim: int, lstm_impl: str,
                 extra: Tuple[str, ...] = ()) -> List[str]:
    """The ablation recipes' shared generator and data flags."""
    return ["--g_type=res_lstm_l", f"--data_dir={train_dir}",
            f"--tr_list_file={train_dir}/tr.list",
            f"--cv_list_file={train_dir}/cv.list",
            "--input_dim=257", f"--output_dim={output_dim}",
            "--left_context=0", "--right_context=0",
            "--batch_size=8", "--batch_norm=False", "--keep_prob=1.0",
            "--l2_scale=0.0", "--end_improve=0.001",
            f"--lstm_impl={lstm_impl}", *extra]


class System(NamedTuple):
    """A system a recipe trains: ``trainer`` gan_rnn (the flagship
    schedule at MSE weight ``weight``, ``cond``: the conditioned D) or
    rnn (the MSE baseline); ``label``: its ``--extra`` row in the table
    (None: the table's own GAN or MSE row)."""
    name: str
    trainer: str
    dir: str
    seed: str = ""
    weight: str = "10"
    cond: bool = False
    label: Optional[str] = None


def train_calls(common: List[str], s: System, gan_epochs: str,
                mse_epochs: str) -> List[List[str]]:
    """A system's ``cli.train`` calls into its directory: a GAN's two
    (the warm-up epoch at d_lr 1e-3, then the main run at 3e-4), an MSE
    baseline's one."""
    if s.trainer == "rnn":
        mmin, mmax = mse_epochs.split()
        return [["--trainer=rnn", *common, f"--save_dir={s.dir}",
                 f"--seed={s.seed}", "--g_learning_rate=0.0003",
                 f"--min_epoches={mmin}", f"--max_epoches={mmax}"]]
    gmin, gmax = gan_epochs.split()
    return [["--trainer=gan_rnn", *common, f"--save_dir={s.dir}",
             f"--seed={s.seed}",
             *(["--d_conditioned=true"] if s.cond else []),
             "--g_learning_rate=0.00008", f"--d_learning_rate={lr}",
             "--disc_updates=1", "--gen_updates=2",
             f"--init_mse_weight={s.weight}", "--init_disc_noise_std=0.05",
             f"--min_epoches={lo}", f"--max_epoches={hi}"]
            for lr, lo, hi in (("0.001", "1", "1"),
                               ("0.0003", gmin, gmax))]


def extra_args(systems: List[System]) -> List[str]:
    """Stage 8's ``--extra`` rows, in the order of ``systems``."""
    return [f"--extra={s.name}:{s.label}" for s in systems if s.label]


def decode_call(trainer: str, train_dir: str, save_dir: str,
                output_dim: int, lstm_impl: str,
                extra: Tuple[str, ...] = ()) -> List[str]:
    return ["--decode", f"--trainer={trainer}", "--g_type=res_lstm_l",
            f"--data_dir={train_dir}",
            f"--test_list_file={train_dir}/test.list",
            f"--save_dir={save_dir}", *extra,
            "--input_dim=257", f"--output_dim={output_dim}",
            "--batch_size=1", "--decode_batch_size=8",
            f"--lstm_impl={lstm_impl}"]


def synth_gate(clean: Dict[str, np.ndarray],
               enhanced: Dict[str, np.ndarray]) -> dict:
    """``run_synth_quality.sh``'s gate heredoc on {utt: matrix} dicts,
    its arithmetic and its printed line."""
    if clean.keys() != enhanced.keys():
        raise ValueError("decoded utterances differ from the cv labels")
    mse_model, mse_mean = [], []
    for u in clean:
        y, g = np.asarray(clean[u]), np.asarray(enhanced[u])
        if y.shape != g.shape:
            raise ValueError(f"{u}: enhanced {g.shape} vs clean {y.shape}")
        mse_model.append(np.mean((g - y) ** 2))
        mse_mean.append(np.mean((y.mean(axis=0) - y) ** 2))
    mse_model, mse_mean = np.mean(mse_model), np.mean(mse_mean)
    return {"line": f"enhanced-vs-clean MSE: {mse_model:.5f}   "
                    f"predict-mean baseline: {mse_mean:.5f}   "
                    f"ratio: {mse_model / mse_mean:.3f}",
            "mse_model": float(mse_model), "mse_mean": float(mse_mean),
            "ratio": float(mse_model / mse_mean),
            "passed": bool(mse_model < 0.5 * mse_mean)}


def synth_verdict(train_dir: str, save_dir: str) -> dict:
    """``synth_gate`` on the held-out labels and the decode, as the
    heredoc reads them from its two arguments."""
    from rsrgan_tpu_torch.data import ScpReader
    return synth_gate(dict(iter(ScpReader(f"{train_dir}/cv/labels.scp"))),
                      dict(iter(ScpReader(f"{save_dir}/test/feats.scp"))))


def ema_verdict(workdir: str, exp_dir: str, iters: int) -> dict:
    """``run_ema_check.sh``'s verdict heredoc: the dict it prints and
    writes to ``ema_check.json``."""
    def mean_of(path, key):
        return float(np.mean([r[key] for r in rs.read_jsonl(path)
                              if r.get(key) is not None]))

    out = {"iterations": iters}
    for v in ("raw", "ema"):
        out[v] = {"feature_mse": mean_of(f"{workdir}/feats_{v}.jsonl",
                                         "mse"),
                  "lsd_db": mean_of(f"{workdir}/feats_{v}.jsonl", "lsd_db")}
    out["train_iterations_run"] = len(
        rs.read_jsonl(f"{exp_dir}/metrics_train.jsonl"))
    out["delta_mse_ema_minus_raw"] = round(
        out["ema"]["feature_mse"] - out["raw"]["feature_mse"], 5)
    out["verdict"] = ("EMA_OK" if out["ema"]["feature_mse"]
                      <= out["raw"]["feature_mse"] * 1.02 else "EMA_WORSE")
    return out


@contextlib.contextmanager
def env_defaults(forced: Dict[str, str], defaults: Dict[str, str]):
    """The environment with ``forced`` set and each of ``defaults`` set
    where it is unset or empty (the shell's ``${VAR:-default}``),
    restored after."""
    saved = {k: os.environ.get(k) for k in {**forced, **defaults}}
    os.environ.update(forced)
    for k, v in defaults.items():
        if not os.environ.get(k):
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class Runner:
    """One recipe's run: its flags, the stage timer, the CLI calls."""

    def __init__(self, args: argparse.Namespace, assets: Optional[dict],
                 stage_context: Callable):
        self.args = args
        self.dev = [f"--device={args.device}"]
        self.assets = assets or {}
        self.timer = rs.StageTimer(stage_context)
        self.systems: List[System] = []

    def on(self, k: int) -> bool:
        return self.args.stage <= k <= self.args.stop_stage

    def cli(self, name: str, argv: List[str], stage: str,
            device: bool = False) -> None:
        """``python -m rsrgan_tpu_torch.{name} argv``, which must exit 0;
        ``device``: with ``--device``."""
        rs.check_cli(name, argv + (self.dev if device else []), stage)

    def quiet_score(self, argv: List[str], stage: str) -> str:
        """A ``cli.score`` call, its printed lines returned (the recipes
        send them to a file or /dev/null)."""
        return rs.capture_cli("cli.score", argv, stage)

    def sim_assets(self, sim: str, num_utts: int, **kw) -> None:
        from rsrgan_tpu_torch.sim import make_sim_assets
        make_sim_assets(sim, num_utts=num_utts,
                        **{**kw, **self.assets, "alignments": True})

    def simulate(self, sim: str, stage: str) -> None:
        self.cli("cli.simulate", [
            f"--wav_scp={sim}/clean/wav.scp", f"--rir_list={sim}/rir_list",
            f"--noise_list={sim}/noise_list", f"--output_dir={sim}/rvb",
            "--foreground_snrs=5:20", "--background_snrs=5:20",
            "--random_seed=1"], stage)

    def extract(self, wav_scp: str, feat_type: str, out_dir: str,
                name: str, stage: str, cmvn: bool = True,
                compress: bool = False) -> None:
        self.cli("cli.extract", [
            f"--wav_scp={wav_scp}", f"--feat_type={feat_type}",
            *(["--compress"] if compress else []),
            f"--output_dir={out_dir}", f"--name={name}",
            *(["--accumulate_cmvn"] if cmvn else [])], stage, device=True)

    def train(self, systems: List[System], common: List[str],
              stage: str) -> None:
        """Each system's training calls, skipped where its DONE marker is
        there and marked done after."""
        for s in systems:
            if os.path.isfile(f"{s.dir}/DONE"):
                print(f"-- system {s.name} already done --", flush=True)
                continue
            for argv in train_calls(common, s, self.args.gan_epochs,
                                    self.args.mse_epochs):
                self.cli("cli.train", argv, stage, device=True)
            open(f"{s.dir}/DONE", "a").close()

    def decode(self, systems: List[System], train_dir: str,
               output_dim: int, stage: str) -> None:
        for s in systems:
            self.cli("cli.train", decode_call(s.trainer, train_dir, s.dir,
                                              output_dim,
                                              self.args.lstm_impl),
                     stage, device=True)

    def proxy(self, train_dir: str, ali_scp: str,
              evals: List[Tuple[str, str]], out: str, stage: str) -> None:
        self.cli("tools.proxy_asr", [
            f"--train_scp={train_dir}/tr/labels.scp",
            f"--ali_scp={ali_scp}",
            f"--holdout_scp={train_dir}/cv/labels.scp",
            *[t for name, scp in evals for t in ("--eval",
                                                  f"{name}={scp}")],
            "--batch=16384", f"--out={out}"], stage, device=True)

    def table(self, workdir: str, train_dir: str, gan_dir: str,
              mse_dir: str, extra: List[str], stage: str,
              forced: Optional[Dict[str, str]] = None,
              defaults: Optional[Dict[str, str]] = None
              ) -> Tuple[int, dict]:
        """``tools.ablation_table`` in the recipe's environment (see
        ``env_defaults``): its exit code and the thresholds it read."""
        with self.timer.stage(stage), \
                env_defaults(forced or {}, defaults or {}):
            rc = rs.run_cli("tools.ablation_table", [
                workdir, f"--train_dir={train_dir}",
                f"--gan_dir={gan_dir}", f"--mse_dir={mse_dir}", *extra])
            return rc, {
                "max_lsd_ratio": float(os.environ.get(
                    "ABLATION_MAX_LSD_RATIO", "0.45")),
                "min_estoi_delta": float(os.environ.get(
                    "ABLATION_MIN_ESTOI_DELTA", "0.03"))}

    def mfcc_scores(self, w: str, train_dir: str, ali_scp: str,
                    systems: List[System], k: str) -> None:
        """The MFCC recipes' scoring stage ``k``: the noisy MFCC of the
        held-out utterances and each system's decode against the clean
        MFCC, then the recognition proxy."""
        noisy = f"{w}/cv_noisy_mfcc.scp"
        with self.timer.stage(f"{k}_score"):
            rs.filter_scp(f"{train_dir}/cv/inputs.scp",
                          f"{train_dir}/noisy_mfcc.scp", noisy)
            for name, scp in [("noisy", noisy)] + [
                    (s.name, f"{s.dir}/test/feats.scp") for s in systems]:
                self.quiet_score(["--mode", "feats", f"--est_scp={scp}",
                                  f"--ref_scp={train_dir}/cv/labels.scp",
                                  f"--per_utt={w}/feats_{name}.jsonl"],
                                 f"{k}_score")
        with self.timer.stage(f"{k}_proxy"):
            self.proxy(train_dir, ali_scp,
                       [("noisy", noisy)] + [(s.name,
                                              f"{s.dir}/test/feats.scp")
                                             for s in systems],
                       f"{w}/proxy.json", f"{k}_proxy")

    def system_rows(self) -> dict:
        """Each trained system's train frames/s from its metrics rows (a
        GAN's warm-up row first); ``residencies``: the rows of a rotating
        feed (one a shard residency)."""
        out = {}
        for s in self.systems:
            path = f"{s.dir}/metrics_train.jsonl"
            if not os.path.exists(path):
                continue
            rows = rs.read_jsonl(path)
            fps = [r["train_frames_per_sec"] for r in rows]
            out[s.name] = {"trainer": s.trainer, "rows": len(rows),
                         "train_frames_per_s_median": float(np.median(fps)),
                         "train_frames_per_s_last": fps[-1],
                         "residencies": sum("eff_epoch" in r for r in rows),
                         "g_loss_first_last": [rows[0].get("g_loss"),
                                               rows[-1].get("g_loss")]}
        return out


def aggregate_args(seeds: List[str], gan_sys: Callable,
                   mse_sys: Callable) -> List[str]:
    """Stage 8's mean ± spread rows over the seeds (two or more)."""
    if len(seeds) < 2:
        return []
    return [f"--aggregate=LSGAN mean±spread ({len(seeds)} seeds):"
            + ",".join(gan_sys(s) for s in seeds),
            f"--aggregate=MSE mean±spread ({len(seeds)} seeds):"
            + ",".join(mse_sys(s) for s in seeds)]


def rename_table(w: str, name: str) -> None:
    """ablation.{md,json} -> {name}.{md,json} where they are there (the
    recipes' ``mv ... 2>/dev/null || true``)."""
    for ext in ("md", "json"):
        if os.path.exists(f"{w}/ablation.{ext}"):
            os.replace(f"{w}/ablation.{ext}", f"{w}/{name}.{ext}")


def table_result(path: str, rc: int, thresholds: dict) -> dict:
    """The table's rows and derived numbers from its json, beside the
    gate's thresholds."""
    out = {"rc": rc, "passed": rc == 0, "table_json": path, **thresholds}
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
        out.update(systems=data["systems"], derived=data["derived"])
    return out


def run_ablation(r: Runner) -> dict:
    """``recipes/run_ablation.sh``, stages 0-8."""
    a = r.args
    w = a.workdir
    train_dir, sim = f"{w}/data/train", f"{w}/sim"
    seeds, weights = a.seeds.split(), a.mse_weights.split()
    first = seeds[0]

    def gan_sys(wt, s):
        return "gan" if wt == "10" and s == first else f"gan_w{wt}_s{s}"

    def mse_sys(s):
        return "mse" if s == first else f"mse_s{s}"

    def sys_dir(name):
        return f"{w}/exp/{name}_res_lstm_l"

    # the sweep is a cross: weights at the first seed, seeds at weight 10
    gans = [System(gan_sys(wt, s), "gan_rnn", sys_dir(gan_sys(wt, s)), s,
                   wt, label=(None if gan_sys(wt, s) == "gan"
                              else f"LSGAN(w={wt},seed={s})"))
            for s in seeds for wt in weights if s == first or wt == "10"]
    mses = [System(mse_sys(s), "rnn", sys_dir(mse_sys(s)), s,
                   label=None if s == first else f"MSE(seed={s})")
            for s in seeds]
    cond = [System("gan_cond", "gan_rnn", sys_dir("gan_cond"), first, "10",
                   True, f"LSGAN+condD(w=10,seed={first})")
            ] if a.gan_cond == 1 else []
    systems = r.systems = gans + mses + cond

    if r.on(0):
        with r.timer.stage("0_assets"):
            shutil.rmtree(w, ignore_errors=True)
            os.makedirs(train_dir)
            r.sim_assets(sim, a.num_utts, min_dur_s=2.0, max_dur_s=5.0,
                         num_rooms=4, rirs_per_room=3, seed=37)
    if r.on(1):
        with r.timer.stage("1_simulate"):
            r.simulate(sim, "1_simulate")
    if r.on(2):
        with r.timer.stage("2_extract"):
            r.extract(f"{sim}/rvb/wav.scp", "spectrogram", train_dir,
                      "inputs", "2_extract")
            r.extract(f"{sim}/clean/wav.scp", "spectrogram", train_dir,
                      "labels", "2_extract")
    if r.on(3):
        with r.timer.stage("3_prepare"):
            rs.prepare_stores(train_dir, a.val_size, "3_prepare")

    common = common_flags(train_dir, 257, a.lstm_impl)
    if r.on(4):
        with r.timer.stage("4_train_gan"):
            r.train(gans + cond, common, "4_train_gan")
    if r.on(5):
        with r.timer.stage("5_train_mse"):
            r.train(mses, common, "5_train_mse")
    if r.on(6):
        with r.timer.stage("6_decode"):
            r.decode(systems, train_dir, 257, "6_decode")
    if r.on(7):
        with r.timer.stage("7_score"):
            noisy_scp, clean_scp = (f"{w}/cv_noisy_wav.scp",
                                    f"{w}/cv_clean_wav.scp")
            rs.filter_scp(f"{train_dir}/cv/inputs.scp",
                          f"{sim}/rvb/wav.scp", noisy_scp)
            rs.filter_scp(f"{train_dir}/cv/inputs.scp",
                          f"{sim}/clean/wav.scp", clean_scp)
            r.quiet_score(["--mode", "feats",
                           f"--est_scp={train_dir}/cv/inputs.scp",
                           f"--ref_scp={train_dir}/cv/labels.scp",
                           f"--per_utt={w}/feats_noisy.jsonl"], "7_score")
            r.quiet_score(["--mode", "wav", f"--est_scp={noisy_scp}",
                           f"--ref_scp={clean_scp}",
                           f"--per_utt={w}/wav_noisy.jsonl"], "7_score")
            for s in systems:
                r.cli("cli.resynth", [f"--enhanced_scp={s.dir}/test/feats.scp",
                                      f"--wav_scp={noisy_scp}",
                                      f"--out_dir={s.dir}/test/wav"],
                      "7_score")
                r.quiet_score(["--mode", "feats",
                               f"--est_scp={s.dir}/test/feats.scp",
                               f"--ref_scp={train_dir}/cv/labels.scp",
                               f"--per_utt={w}/feats_{s.name}.jsonl"],
                              "7_score")
                r.quiet_score(["--mode", "wav",
                               f"--est_scp={s.dir}/test/wav/wav.scp",
                               f"--ref_scp={clean_scp}",
                               f"--per_utt={w}/wav_{s.name}.jsonl"],
                              "7_score")
        with r.timer.stage("7_proxy"):
            r.proxy(train_dir, f"{sim}/ali.scp",
                    [("noisy", f"{train_dir}/cv/inputs.scp")]
                    + [(s.name, f"{s.dir}/test/feats.scp") for s in systems],
                    f"{w}/proxy.json", "7_proxy")

    if a.stop_stage < 8:
        print(f"stopped at stop_stage={a.stop_stage}", flush=True)
        return {"rc": 0}
    rc, thresholds = r.table(
        w, train_dir, sys_dir("gan"), sys_dir("mse"),
        extra_args(systems)
        + aggregate_args(seeds, lambda s: gan_sys("10", s), mse_sys),
        "8_table")
    return table_result(f"{w}/ablation.json", rc, thresholds)


def run_ablation_mfcc(r: Runner) -> dict:
    """``recipes/run_ablation_mfcc.sh``, stages 0-6, on an ablation
    workdir's corpus."""
    a = r.args
    w = a.workdir
    train_dir = f"{w}/data/train"
    sim, lps_train = f"{a.lps_workdir}/sim", f"{a.lps_workdir}/data/train"
    seeds = a.seeds.split()
    first = seeds[0]

    def gan_sys(s):
        return "gan" if s == first else f"gan_s{s}"

    def mse_sys(s):
        return "mse" if s == first else f"mse_s{s}"

    def sys_dir(name):
        return f"{w}/exp/{name}_res_lstm_l"

    gans = [System(gan_sys(s), "gan_rnn", sys_dir(gan_sys(s)), s, "10.0",
                   label=None if s == first else f"LSGAN(seed={s})")
            for s in seeds]
    mses = [System(mse_sys(s), "rnn", sys_dir(mse_sys(s)), s,
                   label=None if s == first else f"MSE(seed={s})")
            for s in seeds]
    systems = r.systems = gans + mses

    if r.on(0):
        with r.timer.stage("0_extract"):
            shutil.rmtree(w, ignore_errors=True)
            os.makedirs(train_dir)
            # the inputs are the LPS run's own corrupted-LPS arks
            for f in ("inputs.scp", "inputs.cmvn"):
                shutil.copy(f"{lps_train}/{f}", train_dir)
            r.extract(f"{sim}/clean/wav.scp", "mfcc", train_dir, "labels",
                      "0_extract")
            r.extract(f"{sim}/rvb/wav.scp", "mfcc", train_dir,
                      "noisy_mfcc", "0_extract", cmvn=False)
    if r.on(1):
        with r.timer.stage("1_prepare"):
            rs.prepare_stores(train_dir, a.val_size, "1_prepare")

    common = common_flags(train_dir, 40, a.lstm_impl)
    if r.on(2):
        with r.timer.stage("2_train_gan"):
            r.train(gans, common, "2_train_gan")
    if r.on(3):
        with r.timer.stage("3_train_mse"):
            r.train(mses, common, "3_train_mse")
    if r.on(4):
        with r.timer.stage("4_decode"):
            r.decode(systems, train_dir, 40, "4_decode")
    if r.on(5):
        r.mfcc_scores(w, train_dir, f"{sim}/ali.scp", systems, "5")

    if a.stop_stage < 6:
        print(f"stopped at stop_stage={a.stop_stage}", flush=True)
        return {"rc": 0}
    # the rows seed by seed: a seed's GAN, then its MSE
    extra = extra_args(sorted(systems, key=lambda s: seeds.index(s.seed)))
    # no ESTOI (MFCC is not resynthesizable): the LSD ratio alone
    rc, thresholds = r.table(w, train_dir, sys_dir("gan"), sys_dir("mse"),
                             extra + aggregate_args(seeds, gan_sys, mse_sys),
                             "6_table", defaults={
                                 "ABLATION_MIN_ESTOI_DELTA": "-1",
                                 "ABLATION_MAX_LSD_RATIO": "0.9"})
    if rc != 0:
        # the recipe stops here (set -e): the table keeps its name
        return table_result(f"{w}/ablation.json", rc, thresholds)
    rename_table(w, "ablation_mfcc")
    return table_result(f"{w}/ablation_mfcc.json", rc, thresholds)


def run_ref_scale(r: Runner) -> dict:
    """``recipes/run_ref_scale.sh``, stages 0-8, each skipped where its
    DONE marker is there."""
    a = r.args
    w = a.workdir
    train_dir, sim = f"{w}/data/train", f"{w}/sim"
    gan_dir, mse_dir = f"{w}/exp/gan_res_lstm_l", f"{w}/exp/mse_res_lstm_l"
    gan = System("gan", "gan_rnn", gan_dir, str(a.seed), "10.0")
    mse = System("mse", "rnn", mse_dir, str(a.seed))
    systems = r.systems = [gan, mse]

    def todo(k, marker):
        return r.on(k) and not os.path.isfile(marker)

    if todo(0, f"{sim}/DONE_synth"):
        with r.timer.stage("0_assets"):
            shutil.rmtree(w, ignore_errors=True)
            os.makedirs(train_dir)
            r.sim_assets(sim, a.num_utts, min_dur_s=2.0, max_dur_s=5.0,
                         num_rooms=8, rirs_per_room=4, seed=41)
            open(f"{sim}/DONE_synth", "a").close()
    if todo(1, f"{sim}/DONE_rvb"):
        with r.timer.stage("1_simulate"):
            r.simulate(sim, "1_simulate")
            open(f"{sim}/DONE_rvb", "a").close()
    if todo(2, f"{train_dir}/DONE_feats"):
        with r.timer.stage("2_extract"):
            r.extract(f"{sim}/rvb/wav.scp", "spectrogram", train_dir,
                      "inputs", "2_extract", compress=True)
            r.extract(f"{sim}/clean/wav.scp", "mfcc", train_dir, "labels",
                      "2_extract", compress=True)
            r.extract(f"{sim}/rvb/wav.scp", "mfcc", train_dir, "noisy_mfcc",
                      "2_extract", cmvn=False, compress=True)
            open(f"{train_dir}/DONE_feats", "a").close()
            # MFCC targets: no resynthesis, so the waves go
            for d in ("clean", "rvb", "rooms"):
                shutil.rmtree(f"{sim}/{d}", ignore_errors=True)
    if todo(3, f"{train_dir}/DONE_stores"):
        with r.timer.stage("3_prepare"):
            rs.prepare_stores(train_dir, a.val_size, "3_prepare")
            open(f"{train_dir}/DONE_stores", "a").close()
            # the stores carry the payload
            with contextlib.suppress(FileNotFoundError):
                os.remove(f"{train_dir}/inputs.ark")

    common = common_flags(train_dir, 40, a.lstm_impl, (
        f"--feed_rotation_block={a.rot_block}",
        f"--feed_prefetch={a.prefetch}"))
    if todo(4, f"{gan_dir}/DONE"):
        with r.timer.stage("4_train_gan"):
            r.train([gan], common, "4_train_gan")
    if todo(5, f"{mse_dir}/DONE"):
        with r.timer.stage("5_train_mse"):
            r.train([mse], common, "5_train_mse")
    if r.on(6):
        with r.timer.stage("6_decode"):
            r.decode([s for s in systems
                      if not os.path.isfile(f"{s.dir}/test/feats.scp")],
                     train_dir, 40, "6_decode")
    if r.on(7):
        r.mfcc_scores(w, train_dir, f"{sim}/ali.scp", systems, "7")

    if a.stop_stage < 8:
        print(f"stopped at stop_stage={a.stop_stage}", flush=True)
        return {"rc": 0}
    rc, thresholds = r.table(w, train_dir, gan_dir, mse_dir, [], "8_table",
                             forced={"ABLATION_MIN_ESTOI_DELTA": "-1",
                                     "ABLATION_MAX_LSD_RATIO": "0.9"})
    # renamed before a gate failure is returned, so the table always lands
    rename_table(w, "ref_scale")
    return table_result(f"{w}/ref_scale.json", rc, thresholds)


def run_ema_check(r: Runner) -> dict:
    """``recipes/run_ema_check.sh``: train, decode raw and EMA, score,
    and the verdict (which runs whatever the stages)."""
    a = r.args
    w = a.workdir
    train_dir = f"{a.lps_workdir}/data/train"
    exp_dir = f"{w}/exp/gan_ema"
    r.systems = [System("gan_ema", "gan_rnn", exp_dir)]
    if r.on(0):
        with r.timer.stage("0_train"):
            shutil.rmtree(w, ignore_errors=True)
            os.makedirs(w)
            r.cli("cli.train", [
                "--trainer=gan_rnn", "--g_type=res_lstm_l",
                f"--data_dir={train_dir}",
                f"--tr_list_file={train_dir}/tr.list",
                f"--cv_list_file={train_dir}/cv.list",
                "--input_dim=257", "--output_dim=257", "--batch_size=8",
                "--batch_norm=False", "--keep_prob=1.0", "--l2_scale=0.0",
                f"--save_dir={exp_dir}",
                "--g_learning_rate=0.00008", "--d_learning_rate=0.0003",
                "--disc_updates=1", "--gen_updates=2",
                "--init_mse_weight=10.0", "--init_disc_noise_std=0.05",
                f"--min_epoches={a.iters}", f"--max_epoches={a.iters}",
                "--end_improve=-1", f"--lstm_impl={a.lstm_impl}"],
                "0_train", device=True)
    if r.on(1):
        with r.timer.stage("1_decode"):
            for v, ema in (("raw", "false"), ("ema", "true")):
                r.cli("cli.train", decode_call(
                    "gan_rnn", train_dir, exp_dir, 257, a.lstm_impl,
                    (f"--moving_average={ema}",)), "1_decode", device=True)
                shutil.move(f"{exp_dir}/test", f"{exp_dir}/test_{v}")
                # feats.scp holds absolute ark offsets into the old dir
                scp = f"{exp_dir}/test_{v}/feats.scp"
                with open(scp) as f:
                    lines = f.readlines()
                with open(scp, "w") as f:
                    f.writelines(line.replace(f"{exp_dir}/test/",
                                              f"{exp_dir}/test_{v}/", 1)
                                 for line in lines)
    if r.on(2):
        with r.timer.stage("2_score"):
            for v in ("raw", "ema"):
                out = r.quiet_score(["--mode", "feats",
                                     f"--est_scp={exp_dir}/test_{v}/"
                                     "feats.scp",
                                     f"--ref_scp={train_dir}/cv/labels.scp",
                                     f"--per_utt={w}/feats_{v}.jsonl"],
                                    "2_score")
                with open(f"{w}/score_{v}.json", "w") as f:
                    f.write(out)
    with r.timer.stage("3_verdict"):
        verdict = ema_verdict(w, exp_dir, a.iters)
        print(json.dumps(verdict, indent=1), flush=True)
        with open(f"{w}/ema_check.json", "w") as f:
            json.dump(verdict, f, indent=1)
    # the verdict is printed, not gated (the recipe exits 0 either way)
    return {"rc": 0, "verdict": verdict}


def run_synth_quality(r: Runner) -> dict:
    """``recipes/run_synth_quality.sh``: the flagship on a 64-utterance
    synthetic corpus (257 -> 40, B=4), decode, the gate."""
    from rsrgan_tpu_torch.data import synthetic

    a = r.args
    w = a.workdir
    train_dir, save_dir = f"{w}/data/train", f"{w}/exp/gan_res_lstm_l"
    with r.timer.stage("corpus"):
        shutil.rmtree(w, ignore_errors=True)
        os.makedirs(w)
        synthetic.make_synthetic_corpus(train_dir, num_utts=64,
                                        input_dim=257, output_dim=40,
                                        min_len=150, max_len=350, seed=11)
    with r.timer.stage("prepare"):
        rs.prepare_stores(train_dir, 8, "prepare", split_seed=False)
    r.systems = [System("gan", "gan_rnn", save_dir)]
    with r.timer.stage("train"):
        r.cli("cli.train", [
            "--trainer=gan_rnn", "--g_type=res_lstm_l",
            f"--data_dir={train_dir}",
            f"--tr_list_file={train_dir}/tr.list",
            f"--cv_list_file={train_dir}/cv.list",
            f"--save_dir={save_dir}", "--batch_size=4",
            "--g_learning_rate=0.0003", "--d_learning_rate=0.001",
            "--disc_updates=1", "--gen_updates=2", "--init_mse_weight=10.0",
            "--input_dim=257", "--output_dim=40",
            f"--min_epoches={a.iters}", f"--max_epoches={a.iters}",
            "--init_disc_noise_std=0.05", "--lstm_impl=wavefront",
            "--l2_scale=0.0"], "train", device=True)
    with r.timer.stage("decode"):
        r.cli("cli.train", [
            "--decode", "--trainer=gan_rnn", "--g_type=res_lstm_l",
            f"--data_dir={train_dir}",
            f"--test_list_file={train_dir}/test.list",
            f"--save_dir={save_dir}", "--input_dim=257", "--output_dim=40",
            "--batch_size=1", "--decode_batch_size=4",
            "--lstm_impl=wavefront"], "decode", device=True)
    with r.timer.stage("gate"):
        gate = synth_verdict(train_dir, save_dir)
    print(gate["line"], flush=True)
    print("QUALITY CHECK PASSED" if gate["passed"] else
          "FAIL: enhancement did not beat the baseline", flush=True)
    return {"rc": 0 if gate["passed"] else 1, "gate": gate}


def multihost_flags(data_dir: str, save_dir: str, port: int) -> List[str]:
    """``run_multihost.sh``'s ``$common``: the frame DNN's training flags
    and the coordinator of a two-process world (``--process_id``
    follows)."""
    return ["--trainer=dnn", "--g_type=dnn",
            f"--tr_list_file={data_dir}/tr.list",
            f"--cv_list_file={data_dir}/cv.list", f"--save_dir={save_dir}",
            "--input_dim=16", "--output_dim=6", "--batch_size=8",
            "--g_learning_rate=0.001", "--keep_lr=1", "--bf16=false",
            "--l2_scale=0.0", "--min_epoches=1", "--max_epoches=2",
            "--seed=7", f"--coordinator_address=localhost:{port}",
            "--num_processes=2"]


def run_multihost(r: Runner) -> dict:
    """``recipes/run_multihost.sh``: a 12-utterance synthetic corpus (16
    -> 6), its stores, the frame DNN as two processes of one world, the
    checkpoint check and the PASSED line."""
    from rsrgan_tpu_torch.data import synthetic
    from rsrgan_tpu_torch.parallel import free_port

    w = r.args.workdir
    data_dir, save_dir = f"{w}/data", f"{w}/exp"
    with r.timer.stage("corpus"):
        shutil.rmtree(w, ignore_errors=True)
        os.makedirs(w)
        synthetic.make_synthetic_corpus(data_dir, num_utts=12, input_dim=16,
                                        output_dim=6, min_len=30,
                                        max_len=60)
    with r.timer.stage("prepare"):
        r.cli("cli.prepare", ["cmvn", f"--inputs={data_dir}/inputs.cmvn",
                              f"--labels={data_dir}/labels.cmvn",
                              f"--save_dir={data_dir}"], "prepare")
        r.cli("cli.prepare", ["split", "--val_size=4",
                              f"--data_dir={data_dir}", "--seed=1"],
              "prepare")
        for sub in ("tr", "cv"):
            r.cli("cli.prepare", [
                "make-store", f"--inputs={data_dir}/{sub}/inputs.scp",
                f"--labels={data_dir}/{sub}/labels.scp",
                f"--cmvn_dir={data_dir}", f"--output_dir={data_dir}/stores",
                f"--name={sub}"], "prepare")
            with open(f"{data_dir}/{sub}.list", "w") as f:
                f.write(f"{data_dir}/stores/{sub}.rtu\n")
    common = multihost_flags(data_dir, save_dir, free_port())
    with r.timer.stage("train"):
        codes = rs.run_processes("cli.train", [
            [*common, f"--process_id={i}", *r.dev] for i in range(2)])
    r.systems = [System("dnn", "dnn", save_dir)]
    # `wait $p0 $p1` returns the last process's status, which set -e
    # exits with
    rc = codes[-1]
    if rc == 0 and not os.path.isfile(f"{save_dir}/checkpoint"):
        print("FAIL: no checkpoint", flush=True)
        rc = 1
    eval_rows = None
    if rc == 0:
        with open(f"{save_dir}/metrics_eval.jsonl") as f:
            eval_rows = sum(1 for line in f if line.strip("\n"))
        print(f"MULTIHOST RUN PASSED ({eval_rows} eval records)", flush=True)
    return {"rc": rc, "exit_codes": codes, "save_dir": save_dir,
            "eval_records": eval_rows}


MICRO_TEST_UTTS = 6   # the recipe's --val_size: its test store


def micro_verdict(save_dir: str) -> dict:
    """``run_micro.sh``'s check heredoc on the decode: MICRO_TEST_UTTS
    utterances, each 40-dim and finite; its printed line and ``passed``
    (where the heredoc's assert would fail, the reason)."""
    from rsrgan_tpu_torch.data import ScpReader
    r = ScpReader(f"{save_dir}/test/feats.scp")
    bad = [u for u, mat in r
           if mat.shape[1] != 40 or not np.isfinite(mat).all()]
    if len(r) != MICRO_TEST_UTTS or bad:
        return {"line": f"FAIL: {len(r)} utterances, not 40-dim or not "
                        f"finite: {bad}", "passed": False}
    return {"line": f"OK: {len(r)} enhanced utterances, 40-dim, finite.",
            "passed": True}


def run_micro(r: Runner) -> dict:
    """``recipes/run_micro.sh``: stages -1 to 3 and the check of the
    decode; stage 4 is not ported (see the module's docstring)."""
    from rsrgan_tpu_torch.data import synthetic

    w = r.args.workdir
    train_dir, test_dir = f"{w}/data/train", f"{w}/data/test"
    save_dir = f"{w}/exp/gan_res_lstm_l"
    r.systems = [System("gan", "gan_rnn", save_dir)]
    with r.timer.stage("-1_corpus"):
        shutil.rmtree(w, ignore_errors=True)
        os.makedirs(w)
        synthetic.make_synthetic_corpus(train_dir, num_utts=24,
                                        input_dim=257, output_dim=40,
                                        min_len=120, max_len=260, seed=7)
    with r.timer.stage("0_prepare"):
        r.cli("cli.prepare", ["cmvn", f"--inputs={train_dir}/inputs.cmvn",
                              f"--labels={train_dir}/labels.cmvn",
                              f"--save_dir={train_dir}"], "0_prepare")
        r.cli("cli.prepare", ["split", "--val_size=6",
                              f"--data_dir={train_dir}"], "0_prepare")
        os.makedirs(f"{train_dir}/stores", exist_ok=True)
        for sub in ("tr", "cv"):
            r.cli("cli.prepare", [
                "make-store", f"--inputs={train_dir}/{sub}/inputs.scp",
                f"--labels={train_dir}/{sub}/labels.scp",
                f"--cmvn_dir={train_dir}",
                f"--output_dir={train_dir}/stores", f"--name={sub}"],
                "0_prepare")
            with open(f"{train_dir}/{sub}.list", "w") as f:
                f.write(f"{train_dir}/stores/{sub}.rtu\n")
    with r.timer.stage("1_test_store"):
        os.makedirs(test_dir, exist_ok=True)
        r.cli("cli.prepare", [
            "make-store", f"--inputs={train_dir}/cv/inputs.scp",
            f"--cmvn_dir={train_dir}", f"--output_dir={test_dir}",
            "--name=test", "--test"], "1_test_store")
        with open(f"{test_dir}/test.list", "w") as f:
            f.write(f"{test_dir}/test.rtu\n")
    with r.timer.stage("2_train"):
        r.cli("cli.train", [
            "--trainer=gan_rnn", f"--data_dir={train_dir}",
            f"--tr_list_file={train_dir}/tr.list",
            f"--cv_list_file={train_dir}/cv.list", "--g_type=res_lstm_l",
            f"--save_dir={save_dir}", "--batch_size=2",
            "--g_learning_rate=0.00008", "--d_learning_rate=0.001",
            "--disc_updates=1", "--gen_updates=2", "--batch_norm=False",
            "--l2_scale=0.0", "--init_mse_weight=10.0", "--input_dim=257",
            "--output_dim=40", "--left_context=0", "--right_context=0",
            "--min_epoches=1", "--max_epoches=2", "--end_improve=0.001",
            "--init_disc_noise_std=0.05", "--num_gpu=1"], "2_train",
            device=True)
    with r.timer.stage("3_decode"):
        r.cli("cli.train", [
            "--decode", "--trainer=gan_rnn", f"--data_dir={train_dir}",
            f"--test_list_file={test_dir}/test.list", "--g_type=res_lstm_l",
            f"--save_dir={save_dir}", "--batch_norm=False",
            "--input_dim=257", "--output_dim=40", "--left_context=0",
            "--right_context=0", "--batch_size=1", "--keep_prob=1.0",
            "--l2_scale=0.0"], "3_decode", device=True)
    print("stage 4 (tools/tpu_parity_check.py) is not ported: "
          "chip_smoke.py's kernel phases hold every hand kernel against "
          "its plain twin on the card", flush=True)
    with r.timer.stage("verify"):
        check = micro_verdict(save_dir)
    print(check["line"], flush=True)
    if not check["passed"]:
        return {"rc": 1, "check": check}
    print("MICRO RUN PASSED", flush=True)
    return {"rc": 0, "check": check}


RUN = {"ablation": run_ablation, "ablation_mfcc": run_ablation_mfcc,
       "ref_scale": run_ref_scale, "ema_check": run_ema_check,
       "synth_quality": run_synth_quality, "multihost": run_multihost,
       "micro": run_micro}


def run_recipe(args: argparse.Namespace, assets: Optional[dict] = None,
               stage_context: Callable = contextlib.nullcontext
               ) -> Tuple[int, dict]:
    """One recipe through the port: (its exit code, the result line's
    dict). ``assets`` overrides ``make_sim_assets``'s keywords (a
    CPU-sized corpus); ``stage_context(name)`` wraps each stage
    (chip_smoke.py counts kernel launches in it)."""
    from rsrgan_tpu_torch.device import resolve_device

    args = recipe_args(args)
    resolve_device(args.device)   # no card: raise before any stage
    r = Runner(args, assets, stage_context)
    out = RUN[args.recipe](r)
    rc = out.pop("rc")
    result = {"recipe": args.recipe, "workdir": args.workdir,
              "device": args.device, "stage": args.stage,
              "stop_stage": args.stop_stage, **out,
              "systems_trained": r.system_rows(),
              "stage_seconds": r.timer.secs,
              "seconds": r.timer.seconds(), "rc": rc, "passed": rc == 0}
    return rc, result


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rsrgan_tpu_torch.tools.experiments",
                                description=__doc__.splitlines()[0])
    p.add_argument("--recipe", choices=RECIPES, required=True)
    p.add_argument("--workdir", default=None,
                   help="default: the recipe's, under the temporary "
                        "directory")
    p.add_argument("--lps_workdir", default=None,
                   help="ablation_mfcc, ema_check: an ablation workdir "
                        "(stages 0-3 done)")
    p.add_argument("--num_utts", type=int, default=None)
    p.add_argument("--val_size", type=int, default=None)
    p.add_argument("--gan_epochs", default="18 20",
                   help="min max of the main GAN run")
    p.add_argument("--mse_epochs", default="20 25", help="min max")
    p.add_argument("--seeds", default="777",
                   help="ablation recipes: SEEDS, space-separated")
    p.add_argument("--mse_weights", default="10",
                   help="ablation: MSE_WEIGHTS, space-separated")
    p.add_argument("--gan_cond", type=int, default=0,
                   help="ablation: 1 adds the conditioned-D system")
    p.add_argument("--stage", type=int, default=0)
    p.add_argument("--stop_stage", type=int, default=None)
    p.add_argument("--rot_block", type=int, default=10,
                   help="ref_scale: --feed_rotation_block")
    p.add_argument("--prefetch", default="true",
                   help="ref_scale: --feed_prefetch")
    p.add_argument("--seed", type=int, default=777, help="ref_scale")
    p.add_argument("--iters", type=int, default=None,
                   help="ema_check (50), synth_quality (24)")
    p.add_argument("--lstm_impl", default="wavefront")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    rc, result = run_recipe(build_parser().parse_args(argv))
    print(json.dumps(result), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
