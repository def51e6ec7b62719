"""The readers of the program's spans and counters
(``rsrgan_tpu_torch.spans``): each on a hand-made record and run, with
hand-worked self times, the profiler's stretch and the counts; None for
an untraced run, for the other kind of cell and for a program without
spans; and a traced run of a tiny cell on the CPU, which reports what
its record holds."""

import sys

import pytest
import torch
from bench_tiny import tiny_cell

from benchmark import harness, run
from rsrgan_tpu_torch import spans

TRAIN = ("host_ms_per_iter.feed.train", "host_ms_per_iter.optimizer.train",
         "host_ms_per_iter.glue.train", "host_ms_per_iter.launch.train",
         "host_waits_per_iter.train")
DECODE = ("host_ms_per_batch.assemble.decode",
          "host_ms_per_batch.launch.decode")
MS = 1_000_000   # ns


def S(i, name, thread, start_ms, end_ms, parent=None, unit=1):
    return spans.Span(i, name, thread, int(start_ms * MS), int(end_ms * MS),
                      parent, unit)


def C(n, unit=1):
    return spans.Count("host_wait", 1, 0, n, unit)


# Two iterations' worth, ms. Main thread (1): the step 0-10 holding the
# gather 0.1-0.4, the backward 1-4, the clip 4-4.5, the update 5-6 and
# the apply 6-6.5; after it the next plan 10-10.2 and its upload
# 10.2-10.3. The autograd thread (2): the stack's backward 1-4 holding a
# layer's 1.5-3.5 holding K2's launch 2-3, which holds its upload
# 2.1-2.3 and its call 2.5-2.6. Self ms: feed 0.3 + 0.2 + 0.1 = 0.6; opt
# 0.5 + 1 + 0.5 = 2; glue 1 + 1 = 2; launch 0.7 + 0.2 + 0.1 = 1; the
# step and the backward (not read) 6 and 3. Waits: 2 + 2 + 2 = 6.
TRAIN_RECORD = spans.Reading(
    [S(1, "feed.gather", 1, 0.1, 0.4, 0),
     S(3, "train.backward", 1, 1, 4, 0),
     S(4, "opt.clip", 1, 4, 4.5, 0),
     S(5, "opt.update", 1, 5, 6, 0),
     S(6, "opt.apply", 1, 6, 6.5, 0),
     S(0, "train.step", 1, 0, 10),
     S(12, "launch.upload", 2, 2.1, 2.3, 11),
     S(13, "launch.call", 2, 2.5, 2.6, 11),
     S(11, "launch.k2", 2, 2, 3, 10),
     S(10, "glue.layer_bwd", 2, 1.5, 3.5, 9),
     S(9, "glue.stack_bwd", 2, 1, 4),
     S(20, "feed.plan", 1, 10, 10.2),
     S(21, "feed.to_device", 1, 10.2, 10.3)],
    [C(2), C(2), C(2, unit=2)], 0)
# the profiler stretched the window twice: 0.5 s of untraced time for
# the 2 iterations the 1 s traced window ran
TRAIN_RUN = {"kind": "train", "trace": {"window_s": 1.0},
             "traced": {"iterations": 2, "paced_s": 0.5}}
TRAIN_WANT = {"host_ms_per_iter.feed.train": 0.6 / 2 * 0.5,
              "host_ms_per_iter.optimizer.train": 2.0 / 2 * 0.5,
              "host_ms_per_iter.glue.train": 2.0 / 2 * 0.5,
              "host_ms_per_iter.launch.train": 1.0 / 2 * 0.5,
              "host_waits_per_iter.train": 3.0}

# Two decode batches, ms: each (0-5, 5-10) holds its assembly 0-1, G's
# stack 1-2 holding K4's launch 1.2-1.8 (its packing 1.3-1.5 and upload
# 1.5-1.6 inside) and the denormalisation 3-3.5. Self ms a batch:
# assembly and denormalisation 1.5; launch 0.3 + 0.2 + 0.1 = 0.6.
DECODE_RECORD = spans.Reading(
    [s for b in range(2) for s in (
        S(10 * b + 1, "decode.assemble", 1, 5 * b, 5 * b + 1, 10 * b,
          b + 1),
        S(10 * b + 4, "launch.pack", 1, 5 * b + 1.3, 5 * b + 1.5,
          10 * b + 3, b + 1),
        S(10 * b + 5, "launch.upload", 1, 5 * b + 1.5, 5 * b + 1.6,
          10 * b + 3, b + 1),
        S(10 * b + 3, "launch.k4_decode", 1, 5 * b + 1.2, 5 * b + 1.8,
          10 * b + 2, b + 1),
        S(10 * b + 2, "glue.stack_fwd", 1, 5 * b + 1, 5 * b + 2, 10 * b,
          b + 1),
        S(10 * b + 6, "decode.denormalize", 1, 5 * b + 3, 5 * b + 3.5,
          10 * b, b + 1),
        S(10 * b, "decode.batch", 1, 5 * b, 5 * b + 5, None, b + 1))],
    [C(2, 1), C(2, 2)], 0)
# 0.8 s of untraced time for the pass the 1 s traced window ran
DECODE_RUN = {"kind": "decode", "trace": {"window_s": 1.0},
              "traced": {"passes": 1, "paced_s": 0.8}}
DECODE_WANT = {"host_ms_per_batch.assemble.decode": 1.5 * 0.8,
               "host_ms_per_batch.launch.decode": 0.6 * 0.8}


def reader(name):
    return harness.metric_reader(name)


@pytest.mark.parametrize("name", TRAIN + DECODE)
def test_reader_of_a_hand_made_record(monkeypatch, name):
    decode = name in DECODE
    monkeypatch.setattr(spans, "read", lambda: (
        DECODE_RECORD if decode else TRAIN_RECORD))
    want = (DECODE_WANT if decode else TRAIN_WANT)[name]
    assert reader(name)(DECODE_RUN if decode else TRAIN_RUN) == \
        pytest.approx(want)
    # nothing for an untraced run or for the other kind of cell
    untraced = dict(DECODE_RUN if decode else TRAIN_RUN, trace=None)
    assert reader(name)(untraced) is None
    assert reader(name)(TRAIN_RUN if decode else DECODE_RUN) is None


@pytest.mark.parametrize("name", TRAIN + DECODE)
def test_reader_without_spans_reads_nothing(monkeypatch, name):
    """A program without the module (the parent of the change that
    brought it), an empty record, or one past its cap: None."""
    import rsrgan_tpu_torch
    decode = name in DECODE
    the_run = DECODE_RUN if decode else TRAIN_RUN
    full = DECODE_RECORD if decode else TRAIN_RECORD
    monkeypatch.setattr(spans, "read",
                        lambda: spans.Reading([], [], 0))
    assert reader(name)(the_run) is None
    monkeypatch.setattr(spans, "read", lambda: full._replace(dropped=1))
    assert reader(name)(the_run) is None
    monkeypatch.delattr(rsrgan_tpu_torch, "spans")
    monkeypatch.setitem(sys.modules, "rsrgan_tpu_torch.spans", None)
    assert reader(name)(the_run) is None


@pytest.mark.parametrize("cell,names", [
    ("mse_b16", ("host_ms_per_iter.feed.train",
                 "host_ms_per_iter.optimizer.train",
                 "host_ms_per_iter.glue.train",
                 "host_waits_per_iter.train")),
    ("decode_b8", ("host_ms_per_batch.assemble.decode",))])
def test_a_traced_run_reports_the_spans(cell, names):
    """A traced run of a tiny cell on the CPU: the readers find the
    record the traced window left and report it (no launch on the CPU,
    so no ``launch.*`` span; no blocking copy either)."""
    spans.clear()
    rc, line, _ = run.execute(harness.manifest(), tiny_cell(cell, f32=True),
                              2 ** 31 + 5, 0.3, True, torch.device("cpu"),
                              0.0)
    assert rc == 0 and line["correct"]
    got = line["metrics"]
    for name in names:
        assert name in got and got[name]["value"] >= 0, name
    launch = ("host_ms_per_iter.launch.train" if cell == "mse_b16"
              else "host_ms_per_batch.launch.decode")
    assert launch not in got
    if cell == "mse_b16":
        assert got["host_waits_per_iter.train"]["value"] == 0
        assert got["host_ms_per_iter.optimizer.train"]["value"] > 0
    spans.clear()
