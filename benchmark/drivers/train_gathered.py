"""Driver: the CLI's device-feed training loop, for ``--trainer=gan_rnn``
and ``--trainer=rnn``.

Each iteration is what ``cli/train.py``'s loop does for a plan on the
device feed: ``feed.plan``, ``plan_to_device``, then the trainer's
``train_step_gathered``, with no sync beyond what those do. The trainer
is built by the CLI's ``build_trainer`` from the configuration's flags
and the mix's batch; its weights are replaced by the benchmark's own
(``weights.py``); the corpus' tables are made on the card by the mix's
generator (``traffic/<generator>.py``) and held by a ``DeviceFeed``; the
plans are the CLI's (``SequenceBatcher``, ``rank_plans``,
``dispatch_plans``), in its order,
the batcher seeded by the mix's ``order_seed`` (as ``--seed`` seeds it in
the CLI), so that every run trains on the same batch shapes.

Set-up runs the first three plans and keeps what the reference needs,
then one plan of every other padded length (the warm-up). The window
runs the following plans until ``--seconds`` have passed, each
iteration's end marked by a CUDA event on the stream, and closes with a
sync. A traced run then runs the same plans again under the profiler,
at most as many as the window ran, so that the trace's device time is
held against the untraced window's time for the same work (the
profiler slows the host). The reference then follows the first three
iterations.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark import check, harness, roofline, weights

CHECKED_ITERATIONS = 3


class _Index:
    """What the CLI's batcher reads of a store: lengths and widths."""

    def __init__(self, lens: np.ndarray, input_dim: int, output_dim: int):
        self.lengths = lens
        self.input_dim, self.output_dim = input_dim, output_dim
        self.has_labels = True

    def __len__(self) -> int:
        return len(self.lengths)


def _feed(first: np.ndarray, lens: np.ndarray, inputs_tbl, labels_tbl):
    """A ``DeviceFeed`` holding tables the benchmark made on the card."""
    from rsrgan_tpu_torch.data.device_feed import DeviceFeed
    feed = DeviceFeed.__new__(DeviceFeed)
    feed.starts, feed.lengths = first.astype(np.int32), lens.astype(np.int32)
    feed.dtype = inputs_tbl.dtype
    feed.in_dim, feed.out_dim = inputs_tbl.shape[1], labels_tbl.shape[1]
    feed.inputs_tbl, feed.labels_tbl = inputs_tbl, labels_tbl
    return feed


def _nets(state, is_gan: bool):
    return {"g": state.g, "d": state.d} if is_gan else {"g": state.net}


def _snapshot(nets) -> Dict[str, dict]:
    """Copies of each net's parameters, Adam first moment and EMA."""
    out = {}
    for name, net in nets.items():
        with torch.no_grad():
            out[name] = {
                "params": {k: v.detach().clone()
                           for k, v in net.params().items()},
                "mu": {k: v.clone() for k, v in
                       net.opt_state.get("mu", {}).items()},
                "ema": {k: v.clone() for k, v in net.ema.items()}}
    return out


def _launch_counts() -> Dict[str, Dict[str, int]]:
    """The program's launch counters by shape: K2, K3, K4 (train and
    decode) and K1."""
    from rsrgan_tpu_torch.ops import lstm_seq, wavefront
    return {"k2": dict(lstm_seq.lstm_bwd.launches_by_shape),
            "k3": dict(lstm_seq.lstm_bwd_acc.launches_by_shape),
            "k4_train": dict(
                wavefront.lstm_wavefront_fwd_train.launches_by_shape),
            "k1": dict(lstm_seq.lstm_fwd.launches_by_shape)}


def _delta(after, before) -> Dict[str, Dict[str, int]]:
    return {k: {s: n - before[k].get(s, 0) for s, n in after[k].items()
                if n != before[k].get(s, 0)} for k in after}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Session:
    """The program set up for one cell and seed: the trainer built with
    the benchmark's weights, the corpus on the card, the plans, and the
    checked iterations run (their losses and the state after the first
    and after the last kept)."""

    def __init__(self, ctx: harness.Ctx):
        from rsrgan_tpu_torch.cli.train import (build_trainer,
                                                dispatch_plans,
                                                make_hparams, parse_args,
                                                plan_to_device, rank_plans)
        from rsrgan_tpu_torch.data import SequenceBatcher
        from rsrgan_tpu_torch.device import set_precision

        self.ctx = ctx
        cfg, mix, device = ctx.cell.config, ctx.cell.mix, ctx.device
        self.cfg, self.device = cfg, device
        self.ref = harness.reference(cfg["reference"])
        set_precision()
        args, _ = parse_args(cfg["cli"] + [
            f"--batch_size={mix['batch_size']}", f"--seed={ctx.seed}",
            f"--device={device.type}"])
        self.is_gan = is_gan = args.trainer == "gan_rnn"
        self.dtype_name = "bfloat16" if args.bf16 else "float32"
        self.trainer = trainer = build_trainer(
            args, device, torch.bfloat16 if args.bf16 else torch.float32)
        self.init = {"g": weights.make(self.ref.g_shapes(cfg["generator"]),
                                       ctx.seed, 2, device)}
        weights.load(trainer.generator, self.init["g"])
        if is_gan:
            self.init["d"] = weights.make(
                self.ref.d_shapes(cfg["discriminator"]), ctx.seed, 3, device)
            weights.load(trainer.discriminator, self.init["d"])
        self.state = state = trainer.init_state()
        hp = make_hparams(args, 1)
        self.noise_seed = args.seed + 1   # the CLI's D-noise generator
        noise = torch.Generator(device=device).manual_seed(self.noise_seed)

        corpus = harness.generator(mix)
        self.lens = lens = corpus.lengths(mix)
        first = corpus.starts(lens)
        in_tbl, lab_tbl = corpus.tables(
            lens, (args.input_dim, args.output_dim), ctx.seed, device)
        self.feed = feed = _feed(first, lens, in_tbl, lab_tbl)
        batcher = SequenceBatcher(
            _Index(lens, args.input_dim, args.output_dim), args.batch_size,
            args.left_context, args.right_context, shuffle=True,
            seed=mix["order_seed"])
        plans = dispatch_plans([rank_plans(batcher)],
                               max(1, args.steps_per_call))
        left, right = args.left_context, args.right_context

        def step(indices, t_pad):
            with ctx.span("bench.plan"):
                st, le = feed.plan(indices)
                dev = plan_to_device(st, le, device)
            with ctx.span("bench.train_step_gathered"):
                if is_gan:
                    m = trainer.train_step_gathered(
                        state, feed.inputs_tbl, feed.labels_tbl, *dev, hp,
                        noise, t_pad, left, right)
                else:
                    m = trainer.train_step_gathered(
                        state, feed.inputs_tbl, feed.labels_tbl, *dev,
                        hp["g_lr"], t_pad, left, right)
            return m, int(le.sum())
        self.step = step

        # the checked iterations: the first plans, from the seeded weights
        checked = plans[:CHECKED_ITERATIONS]
        self.batches = []
        for indices, t_pad in checked:
            ix = np.asarray(indices)
            self.batches.append((
                corpus.rows(in_tbl, first[ix], lens[ix], t_pad),
                corpus.rows(lab_tbl, first[ix], lens[ix], t_pad),
                torch.as_tensor(lens[ix], dtype=torch.int64, device=device)))
        self.losses: List[dict] = []
        for k, (indices, t_pad) in enumerate(checked):
            m, _ = step(indices, t_pad)
            self.losses.append({n: float(v) for n, v in m.items()})
            if k == 0:
                self.after1 = _snapshot(_nets(state, is_gan))
        self.after = _snapshot(_nets(state, is_gan))
        self.checked_t = {t for _, t in checked}
        self.queue = list(plans[CHECKED_ITERATIONS:])

    def warm(self) -> None:
        """One plan of every padded length the checked ones did not run."""
        queue = self.queue
        for t in sorted({t for _, t in queue} - self.checked_t):
            self.step(*queue.pop(next(i for i, p in enumerate(queue)
                                      if p[1] == t)))
        _sync(self.device)

    def window(self, seconds: float, traced: bool = False,
               most: Optional[int] = None) -> dict:
        """The plans that follow the warm-up, until ``seconds`` have passed
        (or ``most`` iterations have run); then a sync. Each iteration's
        end is a CUDA event on the stream (the host clock on the CPU).
        ``traced``: under the profiler, and each iteration's plan and the
        program's launches by shape are kept."""
        ctx, device, queue = self.ctx, self.device, self.queue
        cuda = device.type == "cuda"
        tracer = ctx.tracer if traced else None
        plans, launches, accum, frames, marks = [], [], [], [], []
        most = len(queue) if most is None else most

        def mark():
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append(ev)
            else:
                marks.append(time.perf_counter())

        if tracer:
            tracer.start()
        host0 = harness.host_counters()
        with ctx.span("bench.window") if tracer else contextlib.nullcontext():
            start = time.monotonic()
            mark()
            while (time.monotonic() - start < seconds
                   and len(frames) < most):
                if len(frames) == len(queue):
                    raise RuntimeError(
                        "the epoch's plans ran out in the window")
                indices, t_pad = queue[len(frames)]
                if tracer:
                    before = _launch_counts()
                m, f = self.step(indices, t_pad)
                mark()
                accum.append(m)
                frames.append(f)
                if tracer:
                    plans.append((indices, t_pad))
                    launches.append(_delta(_launch_counts(), before))
            _sync(device)
            window_s = time.monotonic() - start
        host = harness.host_share(host0, harness.host_counters(),
                                  len(frames))
        events = tracer.stop() if tracer else None
        if cuda:
            iter_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        else:
            iter_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        values = torch.stack([torch.stack([
            torch.as_tensor(v).float().reshape(()) for v in m.values()])
            for m in accum]).cpu()
        per_iter = [{"t_pad": t_pad,
                     "lengths": self.lens[np.asarray(indices)].tolist(),
                     "launches": n}
                    for (indices, t_pad), n in zip(plans, launches)]
        return {"window_s": window_s, "iter_ms": iter_ms,
                "frames": sum(frames), "iterations": len(frames),
                "failed": int((~torch.isfinite(values)).any(dim=1).sum()),
                "per_iter": per_iter, "events": events, "host": host}

    def free(self) -> None:
        """Drop the program's state and the tables."""
        del self.trainer, self.state, self.feed, self.step
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "f32", rows=None) -> dict:
        """The reference over the checked iterations (``ref.train``)."""
        return self.ref.train(self.cfg, self.init, self.batches,
                              self.noise_seed, self.device, precision, rows)

    def faults(self) -> Dict[str, Callable[[], dict]]:
        """The faults a training cell can have, each as the reference
        that has it: every step on the first half of its rows, the mean
        taken over them."""
        half = self.batches[0][0].shape[0] // 2
        return {"half_batch": lambda: self.reference(rows=half)}

    def norms(self, side: Optional[dict]) -> dict:
        """``check.train_norms`` of ``side`` (None: the program)."""
        if side is None:
            side = {"after1": self.after1, "after": self.after}
        return check.train_norms(self.init, side["after1"], side["after"],
                                 self.cfg["hparams"])

    def detail(self, ref: dict) -> dict:
        """The program's worst leaf of each part against ``ref``."""
        return check.worst_leaves(self.norms(None), self.norms(ref))

    def numbers(self, side: Optional[dict], ref: dict) -> dict:
        """``check.training_numbers`` of ``side`` (a reference's output;
        None: the program) against ``ref``."""
        return check.training_numbers(
            self.losses if side is None else side["losses"],
            self.norms(side), ref["losses"], self.norms(ref))


def run(ctx: harness.Ctx) -> dict:
    s = Session(ctx)
    s.warm()
    setup_s = time.monotonic() - ctx.t0
    w = s.window(ctx.seconds)
    traced = (s.window(ctx.seconds, traced=True, most=w["iterations"])
              if ctx.tracer.active else None)
    cuda = ctx.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    probe_ms = harness.host_probe_ms()
    # the program's state freed, the reference follows the checked steps
    s.free()
    numbers = s.numbers(None, s.reference())
    del w["events"], w["per_iter"]
    run = {"kind": "train", "setup_s": setup_s, **w,
           "attempted": w["iterations"], "memory_peak_bytes": peak,
           "checks": check.judge(numbers, ctx.cell.workload["limits"]),
           "numbers": numbers, "dtype_name": s.dtype_name,
           "flops_per_frame": (roofline.gan_iteration_flops(s.cfg)
                               if s.is_gan
                               else roofline.mse_iteration_flops(s.cfg)),
           "probe_ms": probe_ms, "trace": None}
    if traced is not None:
        from benchmark import trace
        events = traced.pop("events")
        # the untraced window's time for the traced iterations' work
        traced["paced_s"] = sum(w["iter_ms"][:traced["iterations"]]) / 1e3
        run["attempted"] += traced["iterations"]
        run["failed"] += traced["failed"]
        run.update(trace=trace.analyse(events), traced=traced)
        run["breakdown"] = trace.breakdown(run["trace"])
    return run
