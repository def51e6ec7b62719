"""Driver: the CLI's frame training loop (``run_frame_training``) for
``--trainer=segan``.

The trainer is built by the CLI's ``build_trainer`` from the
configuration's flags and the mix's batch, with the weights the CLI
draws from ``--seed``. The corpus is drawn by the mix's generator
(``traffic/<generator>.py``) and spliced into the host table that
``FrameBatcher`` holds; the batcher is seeded by the mix's
``order_seed`` (as ``--seed`` seeds it in the CLI). As in the CLI, the
first batch of its first permutation is SEGAN's init example (D's
virtual batch norm statistics), and training walks the next
permutation. Each iteration is the CLI's: the batch gathered from the
table in a ``ThreadedPrefetcher``'s thread, then ``frame_train_step``
(the batch to the card, ``SeganTrainer.train_step``), with no sync
beyond what those do; z and D's noise come from a generator seeded
with ``--seed + 1``.

Set-up runs the first three batches and keeps what the reference needs
(the example, the batches, the program's first gradient of each net
from ``SeganTrainer.grad_log``, its state after the last); every batch
has the same shape, so they warm it, and ``warm`` runs one more. The
window runs the following batches until ``--seconds`` have passed, each
iteration's end marked by a CUDA event on the stream, and closes with a
sync. A traced run then runs the same batches again under the profiler,
at most as many as the window ran, and keeps the convolutions each
iteration called by shape (``ops.modules.conv_calls``, with the kernel
gradients the step takes: ``conv.step_convs``). The reference
(``reference/<reference>.py``, f32, its convolutions unfolded) then
follows the three iterations from the same weights, example, batches
and draws.

The numbers (``numbers``): ``loss_gap``, ``grad_gap``, ``change_gap``
and ``ema_gap`` as ``check.training_numbers`` reads them, with the first
gradient of each leaf taken from ``grad_log`` (RMSProp's first step is
near a sign, so the change does not give it); ``first_loss_gap``, the
same over the losses the first iteration takes before any update (D's,
and G's L1 term: G's adversarial term reads D after its first step);
``d_grad_gap``, the worst leaf of D's first gradient alone (D's update
comes first, on data and a G output without gradient); ``g_grad_gap``,
G's first gradient by its median leaf (the worst leaf swings from seed
to seed: G's first gradient reads D after its first RMSProp step, which
moves each element by about its rate times its gradient's sign, so
where rounding turns a sign D lands elsewhere, and through D a leaf of
G whose L1 terms cancel, a bias summed over every position, moves by a
large share); ``g_grad_dist``, the median leaf's distance ``|p - r|``
over the larger of its reference norm and the median leaf's, where the
reference's first G step reads the program's D after its first step
(``reference``'s ``g_first``), which takes that spread out; and
``vbn_gap``: the largest relative distance of D's reference statistics
from the reference's, ``|p - r| / |r|`` over each buffer (the forward
of G and D at the example, before any update). Those the cell's
workload gives a limit decide ``correct``.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from benchmark import check, conv, harness

CHECKED_ITERATIONS = 3
PREFETCH = 32            # the CLI's prefetch queue
# the first iteration's losses that no update has moved yet
FIRST_LOSSES = ("d_rl_loss", "d_fk_loss", "d_loss", "g_l1_loss")
# The control: the reference with its products in TF32, the precision
# below the configuration's float32 (``calibrate`` asks for it by the
# name of the LSTM cells' control).
CONTROL = "tf32"


def _batcher(inputs: np.ndarray, labels: np.ndarray, batch_size: int,
             seed: int):
    """A ``FrameBatcher`` holding tables the benchmark made."""
    from rsrgan_tpu_torch.data import FrameBatcher
    b = FrameBatcher.__new__(FrameBatcher)
    b.batch_size, b.shuffle, b.drop_remainder = batch_size, True, True
    b._rng = np.random.default_rng(seed)
    b.inputs, b.labels = inputs, labels
    return b


def _conv_counts() -> Dict[str, int]:
    from rsrgan_tpu_torch.ops.modules import conv_calls
    return dict(conv_calls.launches_by_shape)


def _snapshot(net) -> Dict[str, dict]:
    with torch.no_grad():
        return {"params": {k: v.detach().clone()
                           for k, v in net.params().items()},
                "ema": {k: v.clone() for k, v in net.ema.items()}}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Session:
    """The program set up for one cell and seed: the trainer and its
    state, the host table and the batcher, and the checked iterations run
    (their losses, first gradients and the state after them kept)."""

    def __init__(self, ctx: harness.Ctx):
        from rsrgan_tpu_torch.cli.train import (build_trainer,
                                                frame_train_step,
                                                make_hparams, parse_args)
        from rsrgan_tpu_torch.device import set_precision

        self.ctx = ctx
        cfg, mix, device = ctx.cell.config, ctx.cell.mix, ctx.device
        self.cfg, self.device = cfg, device
        self.ref = harness.reference(cfg["reference"])
        set_precision()
        args, _ = parse_args(cfg["cli"] + [
            f"--batch_size={mix['batch_size']}", f"--seed={ctx.seed}",
            f"--device={device.type}"])
        self.trainer = trainer = build_trainer(args, device, torch.float32)
        self.init = {"g": {k: v.detach().clone() for k, v in
                           trainer.generator.named_parameters()},
                     "d": {k: v.detach().clone() for k, v in
                           trainer.discriminator.named_parameters()}}

        corpus = harness.generator(mix)
        lens = corpus.lengths(mix)
        feats, labels = corpus.tables(
            lens, (args.input_dim, args.output_dim), ctx.seed, device)
        table = corpus.spliced(feats, lens, args.left_context,
                               args.right_context)
        del feats
        self.batcher = batcher = _batcher(table, labels, args.batch_size,
                                          mix["order_seed"])
        first = next(batcher.iter_index_batches())
        self.example = torch.from_numpy(
            batcher._make_batch(first)[0]).to(device)
        self.state = state = trainer.init_state(self.example)
        self.vbn = {k: v.detach().reshape(-1).clone() for k, v in
                    trainer.discriminator.named_buffers()}
        hp = make_hparams(args, 1)
        self.rand_seed = args.seed + 1   # the CLI's z and D-noise generator
        rand = torch.Generator(device=device).manual_seed(self.rand_seed)

        def step(x, y):
            with ctx.span("bench.frame_train_step"):
                return frame_train_step(trainer, state, x, y, device, hp,
                                        rand, hp["g_lr"])
        self.step = step

        plans = list(batcher.iter_index_batches())
        trainer.grad_log = []
        self.batches, self.losses = [], []
        for sel in plans[:CHECKED_ITERATIONS]:
            x, y = batcher._make_batch(sel)
            self.batches.append((torch.from_numpy(x).to(device),
                                 torch.from_numpy(y).to(device)))
            m = step(x, y)
            self.losses.append({n: float(v) for n, v in m.items()})
            if len(self.batches) == 1:   # D after its first step
                self.d_first = {k: v.detach().clone()
                                for k, v in state.d.params().items()}
        self.grads = {}
        for net, grads in trainer.grad_log:
            self.grads.setdefault(net, grads)
        trainer.grad_log = None
        self.after = {"g": _snapshot(state.g), "d": _snapshot(state.d)}
        self.queue = plans[CHECKED_ITERATIONS:]

    def warm(self) -> None:
        """One more iteration (the checked ones ran the one shape)."""
        self.step(*self.batcher._make_batch(self.queue.pop(0)))
        _sync(self.device)

    def window(self, seconds: float, traced: bool = False,
               most: Optional[int] = None) -> dict:
        """The batches that follow the warm-up through the prefetch
        thread, until ``seconds`` have passed (or ``most`` iterations have
        run); then a sync. Each iteration's end is a CUDA event on the
        stream (the host clock on the CPU). ``traced``: under the
        profiler, and each iteration's convolutions by shape are kept."""
        from rsrgan_tpu_torch.data import ThreadedPrefetcher
        ctx, device, queue = self.ctx, self.device, self.queue
        cuda = device.type == "cuda"
        tracer = ctx.tracer if traced else None
        per_iter, accum, frames, marks = [], [], [], []
        most = len(queue) if most is None else most
        stop = threading.Event()

        def produce():
            for sel in queue[:most]:
                if stop.is_set():
                    return
                yield self.batcher._make_batch(sel)

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
            batches = iter(ThreadedPrefetcher(produce(), PREFETCH))
            while (time.monotonic() - start < seconds
                   and len(frames) < most):
                if len(frames) == len(queue):
                    raise RuntimeError(
                        "the epoch's batches ran out in the window")
                x, y = next(batches)
                if tracer:
                    before = _conv_counts()
                m = self.step(x, y)
                mark()
                accum.append(m)
                frames.append(len(x))
                if tracer:
                    after = _conv_counts()
                    per_iter.append({"convs": conv.step_convs({
                        k: n - before.get(k, 0) for k, n in after.items()
                        if n != before.get(k, 0)}, self.cfg)})
            _sync(device)
            window_s = time.monotonic() - start
        host = harness.host_share(host0, harness.host_counters(),
                                  len(frames))
        events = tracer.stop() if tracer else None
        stop.set()
        for _ in batches:   # the prefetch thread's last batches
            pass
        if cuda:
            iter_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        else:
            iter_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        values = torch.stack([torch.stack([
            torch.as_tensor(v).float().reshape(()) for v in m.values()])
            for m in accum]).cpu()
        return {"window_s": window_s, "iter_ms": iter_ms,
                "frames": sum(frames), "iterations": len(frames),
                "failed": int((~torch.isfinite(values)).any(dim=1).sum()),
                "per_iter": per_iter, "events": events, "host": host}

    def free(self) -> None:
        """Drop the program's state and the host table."""
        del self.trainer, self.state, self.batcher, self.step
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "f32", rows=None,
                  g_backward: Optional[str] = None) -> dict:
        """The reference over the checked iterations (``ref.train``), its
        z and noise drawn as the program drew them; ``"fp8"`` asks for
        the control (``CONTROL``). ``"g_first"``: G's first gradient of
        the first iteration run again against the program's D after its
        first step."""
        if precision == "fp8":
            precision = CONTROL

        def draws():
            gen = torch.Generator(device=self.device).manual_seed(
                self.rand_seed)
            return lambda shape: torch.randn(shape, generator=gen,
                                             device=self.device)
        out = self.ref.train(self.cfg, self.init, self.example,
                             self.batches, draws(), precision, rows,
                             g_backward=g_backward)
        out["g_first"] = self.ref.train(
            self.cfg, self.init, self.example, self.batches[:1], draws(),
            precision, rows, g_backward=g_backward,
            d_first=self.d_first)["grads"]["g"]
        return out

    def faults(self) -> Dict[str, Callable[[], dict]]:
        """The faults a training cell can have, each as the reference
        that has it: every step on the first half of its rows; G's
        backward products in TF32 (its forward and D's in f32)."""
        half = self.batches[0][0].shape[0] // 2
        return {"half_batch": lambda: self.reference(rows=half),
                "g_grad_tf32": lambda: self.reference(g_backward=CONTROL)}

    def norms(self, side: Optional[dict]) -> dict:
        """Leaf norms of a side's first gradients and changes (None: the
        program), in ``check.train_norms``' layout."""
        if side is None:
            side = {"grads": self.grads, "after": self.after}
        out = {"grad": {}, "change": {}}
        for net, p0 in self.init.items():
            out["grad"][net] = check.norms(side["grads"][net])
            out["change"][net] = check.norms(check.diff(
                side["after"][net]["params"], p0))
            out["change"][f"{net}.ema"] = check.norms(check.diff(
                side["after"][net]["ema"], p0))
        return out

    def detail(self, ref: dict) -> dict:
        """The program's worst leaf of each part against ``ref``; and in
        each net's worst change leaf the element whose change differs
        most: its index, the program's and the reference's change and
        first gradient there, and the share of the leaf's elements whose
        change has the other sign."""
        out = check.worst_leaves(self.norms(None), self.norms(ref))
        dist = self.g_first_dist(None, ref)
        name = max(dist, key=dist.get)
        out["g_first:g"] = [name, dist[name]]
        for net, init in self.init.items():
            name = out[f"change:{net}"][0]
            p0 = init[name].double().reshape(-1)
            mine = self.after[net]["params"][name].double().reshape(-1) - p0
            theirs = ref["after"][net]["params"][name].double().reshape(
                -1) - p0
            i = int((mine - theirs).abs().argmax())
            out[f"change_element:{net}"] = [
                name, i, float(mine[i]), float(theirs[i]),
                float(self.grads[net][name].reshape(-1)[i]),
                float(ref["grads"][net][name].reshape(-1)[i]),
                float((torch.sign(mine) != torch.sign(theirs)).double()
                      .mean())]
        return out

    def g_first_dist(self, side: Optional[dict], ref: dict
                     ) -> Dict[str, float]:
        """Each leaf of G's first gradient (None: the program's, else
        ``side["g_first"]``) against ``ref["g_first"]``, both read against
        the program's D after its first step: ``|p - r|`` over the larger
        of the leaf's reference norm and the median leaf's."""
        mine = self.grads["g"] if side is None else side["g_first"]
        theirs = check.norms(ref["g_first"])
        median = float(np.median(list(theirs.values())))
        dist = check.norms(check.diff(mine, ref["g_first"]))
        return {k: dist[k] / max(r, median, 1e-30)
                for k, r in theirs.items()}

    def numbers(self, side: Optional[dict], ref: dict) -> dict:
        """The compared numbers of ``side`` (a reference's output; None:
        the program) against ``ref``."""
        mine, theirs = self.norms(side), self.norms(ref)
        losses = self.losses if side is None else side["losses"]
        out = check.training_numbers(losses, mine, ref["losses"], theirs)
        first = ref["losses"][0]
        out["first_loss_gap"] = max(
            abs(losses[0][k] - first[k]) / max(abs(first[k]), 1e-30)
            for k in FIRST_LOSSES)
        out["d_grad_gap"] = check.worst_gap(mine["grad"]["d"],
                                            theirs["grad"]["d"])
        gaps = check.leaf_gaps(mine["grad"]["g"], theirs["grad"]["g"])
        out["g_grad_gap"] = float(np.median(list(gaps.values())))
        dist = self.g_first_dist(side, ref)
        out["g_grad_dist"] = float(np.median(list(dist.values())))
        vbn = self.vbn if side is None else side["vbn"]
        out["vbn_gap"] = max(
            float((vbn[k].double() - r.double()).norm()
                  / r.double().norm().clamp(min=1e-30))
            for k, r in ref["vbn"].items())
        return out


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
           "numbers": numbers, "dtype_name": "float32",
           "flops_per_frame": conv.segan_iteration_flops(s.cfg),
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
