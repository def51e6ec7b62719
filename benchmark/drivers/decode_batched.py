"""Driver: the CLI's batched decode (``cli/train.py`` ``_decode_batched``
at ``--decode_batch_size`` > 1), the enhancement a decode user runs.

G is built as ``run_decode`` builds it, from the configuration's flags,
with the benchmark's weights (``weights.py``); ``infer`` is
``run_decode``'s closure on one card. The test set is made on the card
from the seed by the mix's generator (``traffic/<generator>.py``) and
held on the host, as the decode's store is; the target CMVN's means and
deviations are drawn from the seed as plain arrays, from which the
program gets its ``Cmvn`` and the reference denormalises by itself. No
ark is written: a recorder takes ``_decode_batched``'s rows in the
writer's place and keeps those of a sample of utterances drawn from the
seed (the longest among them).

Set-up decodes the whole test set once (every shape of the traffic).
The window decodes it again, pass after pass, until ``--seconds`` have
passed. A traced run then decodes as many passes again at most under
the profiler, so that the trace's device time is held against the
untraced window's time for the same work (the profiler slows the
host). Then the reference decodes the sample in f32 and every pass's
rows of it are compared.
"""

from __future__ import annotations

import contextlib
import gc
import io
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from benchmark import check, harness, roofline, weights

REF_ROWS = 32  # rows of a reference block


class _HostStore:
    """The test store: utterance ids, lengths and host rows."""

    def __init__(self, rows: np.ndarray, first: np.ndarray,
                 lens: np.ndarray):
        self.rows, self.first, self.lengths = rows, first, lens
        self.input_dim = rows.shape[1]
        self.utt_ids = [f"utt{i:06d}" for i in range(len(lens))]

    def __len__(self) -> int:
        return len(self.lengths)

    def inputs(self, i: int) -> np.ndarray:
        s = int(self.first[i])
        return self.rows[s:s + int(self.lengths[i])]


class _Recorder:
    """Takes the writer's place: counts the rows and the passes, and keeps
    the sampled utterances' rows of every pass."""

    def __init__(self, sample_ids):
        self.kept = {u: [] for u in sample_ids}
        self.count = self.passes = 0

    def write_next_utt(self, ark_path, utt_id, mat) -> None:
        self.count += 1
        if utt_id in self.kept:
            self.kept[utt_id].append(mat)


def sample(lens: np.ndarray, k: int, seed: int) -> np.ndarray:
    """``k`` utterance indices drawn from ``seed``, the longest first."""
    rng = np.random.default_rng(harness.stream_seed(seed, 5))
    longest = int(np.argmax(lens))
    rest = rng.choice(np.delete(np.arange(len(lens)), longest),
                      size=min(k, len(lens)) - 1, replace=False)
    return np.concatenate([[longest], np.sort(rest)]).astype(np.int64)


def labels_cmvn(dim: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """The target CMVN's means, N(0, 4), and deviations, uniform in
    [0.5, 4] (float64)."""
    rng = np.random.default_rng(harness.stream_seed(seed, 4))
    return rng.normal(0.0, 4.0, dim), rng.uniform(0.5, 4.0, dim)


class Session:
    """The program set up for one cell and seed: G with the benchmark's
    weights, the test set on the host, ``infer`` and the recorder."""

    def __init__(self, ctx: harness.Ctx):
        from rsrgan_tpu_torch.cli.train import (_decode_batched, parse_args,
                                                resolve_lstm_impl)
        from rsrgan_tpu_torch.data.cmvn import Cmvn
        from rsrgan_tpu_torch.device import set_precision
        from rsrgan_tpu_torch.models import get_generator

        self.ctx = ctx
        cfg, mix, device = ctx.cell.config, ctx.cell.mix, ctx.device
        self.cfg, self.device = cfg, device
        self.ref = harness.reference(cfg["reference"])
        set_precision()
        args, _ = parse_args(cfg["cli"] + [
            "--decode", f"--decode_batch_size={mix['batch_size']}",
            f"--seed={ctx.seed}", f"--device={device.type}"])
        self.dtype_name = "bfloat16" if args.bf16 else "float32"
        gen = get_generator(args.g_type, input_dim=args.input_dim,
                            output_dim=args.output_dim,
                            left_context=args.left_context,
                            right_context=args.right_context,
                            batch_norm=args.batch_norm,
                            compute_dtype=torch.bfloat16 if args.bf16
                            else torch.float32,
                            lstm_impl=resolve_lstm_impl(args))
        self.params = weights.make(self.ref.g_shapes(cfg["generator"]),
                                   ctx.seed, 2, device)
        weights.load(gen, self.params)
        self.gen = gen = gen.to(device).eval()

        corpus = harness.generator(mix)
        self.lens = lens = corpus.lengths(mix)
        (table,) = corpus.tables(lens, (args.input_dim,), ctx.seed, device)
        self.store = store = _HostStore(table.cpu().numpy(),
                                        corpus.starts(lens), lens)
        del table
        self.mean, self.std = labels_cmvn(args.output_dim, ctx.seed)
        cmvn = Cmvn(mean=self.mean.copy(), stddev=self.std.copy())
        self.picked = sample(lens, int(mix["check_sample"]), ctx.seed)
        self.calls = calls = []
        self.tracing = False

        @torch.no_grad()
        def infer(inputs: np.ndarray, lengths: np.ndarray) -> np.ndarray:
            with ctx.span("bench.infer"):
                x = torch.from_numpy(inputs).to(device)
                out = gen(x, torch.from_numpy(lengths).to(device))
                res = out.float().cpu().numpy()
            if self.tracing:
                calls.append({"t_pad": int(inputs.shape[1]),
                              "lengths": lengths.tolist()})
            return res

        def decode_pass(writer) -> None:
            with contextlib.redirect_stdout(io.StringIO()):
                _decode_batched(args, store, infer, cmvn, writer, "",
                                row_quant=1)
            writer.passes += 1
        self.decode_pass = decode_pass
        self.rec = _Recorder([store.utt_ids[i] for i in self.picked])

    def warm(self) -> None:
        """The whole test set once (every shape of the traffic), into the
        recorder."""
        self.decode_pass(self.rec)

    def window(self, seconds: float, traced: bool = False,
               most: Optional[int] = None) -> dict:
        """Whole passes over the test set until ``seconds`` have passed
        (or ``most`` passes have run), each ending in the copy of its
        last batch to the host. ``traced``: under the profiler, with each
        decode batch's shape kept."""
        from rsrgan_tpu_torch.ops import wavefront
        ctx = self.ctx
        tracer = ctx.tracer if traced else None
        most = most or 1 << 30
        self.calls.clear()
        self.tracing = traced
        launches0 = wavefront.lstm_wavefront_fwd.launches
        ends = []
        if tracer:
            tracer.start()
        host0 = harness.host_counters()
        with ctx.span("bench.window") if tracer else contextlib.nullcontext():
            start = time.monotonic()
            while time.monotonic() - start < seconds and len(ends) < most:
                with ctx.span("bench._decode_batched") if tracer \
                        else contextlib.nullcontext():
                    self.decode_pass(self.rec)
                ends.append(time.monotonic() - start)
            window_s = time.monotonic() - start
        host = harness.host_share(host0, harness.host_counters(),
                                  len(ends))
        events = tracer.stop() if tracer else None
        self.tracing = False
        passes = len(ends)
        return {"window_s": window_s, "passes": passes,
                "pass_s": [b - a for a, b in zip([0.0] + ends, ends)],
                "frames": passes * int(self.lens.sum()),
                "calls": list(self.calls),
                "k4_launches": wavefront.lstm_wavefront_fwd.launches
                - launches0, "events": events, "host": host}

    def free(self) -> None:
        del self.gen, self.decode_pass
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "f32") -> dict:
        """The reference's denormalised rows of each sampled utterance."""
        out, store, lens = {}, self.store, self.lens
        for b in range(0, len(self.picked), REF_ROWS):
            ix = self.picked[b:b + REF_ROWS]
            n = lens[ix]
            x = torch.zeros((len(ix), int(n.max()), store.input_dim),
                            dtype=torch.float32)
            for r, i in enumerate(ix):
                x[r, :n[r]] = torch.from_numpy(store.inputs(int(i)))
            y = self.ref.decode(self.cfg, self.params, x.to(self.device),
                                torch.as_tensor(n, device=self.device),
                                precision).cpu().numpy()
            for r, i in enumerate(ix):
                out[store.utt_ids[i]] = [
                    y[r, :n[r]].astype(np.float64) * self.std + self.mean]
        return out

    def faults(self) -> Dict[str, Callable[[], dict]]:
        """None as a reference: the decode's faults are planted in the
        program (the tests)."""
        return {}

    def detail(self, ref: dict) -> dict:
        return {}

    def _compare(self, side: dict, ref: dict, passes: int) -> Tuple[
            float, int]:
        """The worst ``check.decode_gap`` of ``side``'s rows (``passes``
        of each sampled utterance) against ``ref``'s, and how many were
        missing or not finite."""
        worst, failed = 0.0, 0
        for utt, (want,) in ref.items():
            got = side.get(utt, [])
            failed += max(0, passes - len(got))
            for mat in got:
                if not np.isfinite(mat).all():
                    failed += 1
                worst = max(worst, check.decode_gap(mat, want, self.mean,
                                                    self.std))
        return worst, failed

    def failed(self, ref: dict) -> int:
        """The program's sampled rows that never came or are not finite."""
        return self._compare(self.rec.kept, ref, self.rec.passes)[1]

    def numbers(self, side: Optional[dict], ref: dict) -> dict:
        """The worst gap of ``side``'s rows (a reference's output; None:
        every pass of the program's) against ``ref``'s; infinite where a
        row is missing or not finite."""
        worst, failed = (self._compare(side, ref, 1) if side is not None
                         else self._compare(self.rec.kept, ref,
                                            self.rec.passes))
        return {"out_rel_rms": worst if failed == 0 else float("inf")}


def run(ctx: harness.Ctx) -> dict:
    s = Session(ctx)
    s.warm()
    setup_s = time.monotonic() - ctx.t0
    w = s.window(ctx.seconds)
    traced = (s.window(ctx.seconds, traced=True, most=w["passes"])
              if ctx.tracer.active else None)
    cuda = ctx.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    probe_ms = harness.host_probe_ms()
    s.free()
    ref = s.reference()
    numbers = s.numbers(None, ref)
    del w["events"], w["calls"], w["k4_launches"]
    passes = w["passes"] + (traced["passes"] if traced else 0)
    run = {"kind": "decode", "setup_s": setup_s, **w,
           "attempted": passes * len(s.lens), "failed": s.failed(ref),
           "memory_peak_bytes": peak,
           "checks": check.judge(numbers, ctx.cell.workload["limits"]),
           "numbers": numbers, "dtype_name": s.dtype_name,
           "flops_per_frame": roofline.decode_flops(s.cfg),
           "generator": s.cfg["generator"], "probe_ms": probe_ms,
           "trace": None}
    if traced is not None:
        from benchmark import trace
        events = traced.pop("events")
        # the untraced window's time for as many passes
        traced["paced_s"] = sum(w["pass_s"][:traced["passes"]])
        run.update(trace=trace.analyse(events), traced=traced)
        run["breakdown"] = trace.breakdown(run["trace"])
    return run
