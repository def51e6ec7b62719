"""The port's spans and counters (``rsrgan_tpu_torch/spans.py``): off
they record nothing and never enter ``record_function``; armed they
record nesting, threads, units and counts, within their cap; under a
``torch.profiler`` they are armed and land in its trace; the train and
decode paths reach the spans of their layers; on the card a kernel
launch counts its blocking copies, which only the first launch of a
shape makes.

The file imports torch and the port only; its ``cuda`` test runs on the
card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_spans.py
"""

import argparse
import json
import threading
import time

import numpy as np
import pytest
import torch

from rsrgan_tpu_torch import spans
from rsrgan_tpu_torch.cli import train as port_train
from rsrgan_tpu_torch.data import SequenceBatcher, StoreWriter, UtteranceStore
from rsrgan_tpu_torch.data import device_feed as pfeed
from rsrgan_tpu_torch.data.cmvn import Cmvn
from rsrgan_tpu_torch.models.discriminators import LstmDiscriminator
from rsrgan_tpu_torch.models.recurrent import ResLstmGenerator
from rsrgan_tpu_torch.ops import _build
from rsrgan_tpu_torch.training import GanTrainer, MseTrainer

IN, OUT, GU, DU = 9, 4, 13, 10
LENS = [7, 12, 9, 5, 11, 8, 10, 6]
HP = {"g_lr": 1e-3, "d_lr": 1e-3, "mse_lambda": 10.0,
      "disc_noise_std": 0.05, "d_real": 1.0, "d_fake": 0.0}
CPU = torch.device("cpu")


@pytest.fixture
def record():
    """An empty record, disarmed again after the test."""
    spans.disable()
    spans.clear()
    yield
    spans.disable()
    spans.clear()


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

def test_off_records_nothing_and_never_enters_record_function(
        record, monkeypatch):
    entered = []

    class Tripwire:
        def __init__(self, name):
            entered.append(name)

    monkeypatch.setattr(torch.profiler, "record_function", Tripwire)
    assert not spans.armed()
    first = spans.span("train.step")
    with first:
        with spans.span("launch.k2"):
            spans.count("host_wait", 2)
    assert spans.span("opt.update") is first   # the shared no-op
    assert entered == []
    reading = spans.read()
    assert reading.spans == [] and reading.counts == []
    assert reading.dropped == 0


def test_armed_records_nesting_threads_units_and_counts(record,
                                                        monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    spans.enable()
    assert spans.armed()
    seen = {}

    def autograd_like():
        with spans.span("glue.stack_bwd"):
            spans.count("host_wait")
        seen["tid"] = threading.get_native_id()

    with spans.span("train.step"):
        with spans.span("train.g_update"):
            with spans.span("opt.update"):
                time.sleep(0.002)
                spans.count("host_wait", 2)
            worker = threading.Thread(target=autograd_like)
            worker.start()
            worker.join(timeout=10)
            assert not worker.is_alive()
    with spans.span("train.step"):
        pass
    assert entered == []   # armed without a profiler: no ranges
    r = spans.read()
    by = {s.name: s for s in r.spans}
    step = [s for s in r.spans if s.name == "train.step"]
    assert len(step) == 2 and step[1].unit == step[0].unit + 1
    main = threading.get_native_id()
    assert by["train.step"].parent is None
    assert by["train.g_update"].parent == step[0].id
    assert by["opt.update"].parent == by["train.g_update"].id
    assert by["opt.update"].thread == main
    # the other thread: no parent there, the step's unit
    assert by["glue.stack_bwd"].thread == seen["tid"] != main
    assert by["glue.stack_bwd"].parent is None
    assert {s.unit for s in r.spans if s.name != "train.step"} == {
        step[0].unit}
    assert [(c.name, c.n, c.unit) for c in r.counts] == [
        ("host_wait", 2, step[0].unit), ("host_wait", 1, step[0].unit)]
    assert r.total("host_wait") == 3 and r.units("train.step") == 2
    dur = {s.name: s.end_ns - s.start_ns for s in r.spans[:4]}
    self_ns = r.self_ns()
    assert dur["opt.update"] >= 2_000_000
    assert self_ns["opt.update"] == dur["opt.update"]
    assert self_ns["train.g_update"] == (dur["train.g_update"]
                                         - dur["opt.update"])
    # the other thread's span is not the g_update's child
    assert self_ns["glue.stack_bwd"] == dur["glue.stack_bwd"]
    assert spans.read() == r   # reading keeps the record


def test_self_time_of_a_hand_made_record():
    """Self time sums over threads and subtracts only a span's own
    children: ns 0-100 a step holding an update 10-70 holding a clip
    20-30 and an apply 40-60; on another thread a backward 15-55
    holding a launch 20-50."""
    S = spans.Span
    r = spans.Reading([S(1, "opt.clip", 1, 20, 30, 2, 1),
                       S(3, "opt.apply", 1, 40, 60, 2, 1),
                       S(2, "train.g_update", 1, 10, 70, 0, 1),
                       S(0, "train.step", 1, 0, 100, None, 1),
                       S(5, "launch.k2", 2, 20, 50, 4, 1),
                       S(4, "glue.stack_bwd", 2, 15, 55, None, 1),
                       S(6, "opt.clip", 1, 200, 205, None, 2)], [], 0)
    assert r.self_ns() == {"opt.clip": 15, "opt.apply": 20,
                           "train.g_update": 30, "train.step": 40,
                           "launch.k2": 30, "glue.stack_bwd": 10}


def test_the_cap_holds(record, monkeypatch):
    monkeypatch.setattr(spans, "CAP", 5)
    spans.enable()
    for _ in range(4):
        with spans.span("feed.plan"):
            pass
    spans.count("host_wait")
    spans.count("host_wait")
    with spans.span("feed.plan"):
        pass
    r = spans.read()
    assert len(r.spans) + len(r.counts) == 5 and r.dropped == 2
    spans.clear()
    assert spans.read() == spans.Reading([], [], 0)


def test_profiler_arms_the_spans_and_traces_them(record, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.armed()
        with spans.span("train.step"):
            with spans.span("opt.update"):
                torch.ones(3).sum()
            spans.count("host_wait")
    assert not spans.armed()
    with spans.span("feed.plan"):   # off again: not recorded
        pass
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    rows = [e for e in events if e.get("cat") == "user_annotation"]
    assert {"train.step", "opt.update"} <= {e["name"] for e in rows}
    step = next(e for e in rows if e["name"] == "train.step")
    update = next(e for e in rows if e["name"] == "opt.update")
    assert step["ts"] <= update["ts"] and (
        update["ts"] + update["dur"] <= step["ts"] + step["dur"])
    r = spans.read()
    assert [s.name for s in r.spans] == ["opt.update", "train.step"]
    assert r.total("host_wait") == 1


def test_count_launch_updates_the_wrapper():
    def wrapper():
        pass
    wrapper.launches, wrapper.launches_by_shape = 0, {}
    wrapper.launches_by_route = {}
    spans.count_launch(wrapper, "U=3,P=2,B=4", "rowgroup")
    spans.count_launch(wrapper, "U=3,P=2,B=4", "resident")
    spans.count_launch(wrapper, "U=3,P=2,B=8", "resident")
    assert wrapper.launches == 3
    assert wrapper.launches_by_shape == {"U=3,P=2,B=4": 2, "U=3,P=2,B=8": 1}
    assert wrapper.launches_by_route == {"rowgroup": 1, "resident": 2}
    plain = argparse.Namespace(launches=0, launches_by_shape={})
    spans.count_launch(plain, "L=2")
    assert plain.launches == 1 and plain.launches_by_shape == {"L=2": 1}


# ---------------------------------------------------------------------------
# the train and decode paths on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def store(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("spans") / "tr.rtu")
    rng = np.random.default_rng(5)
    with StoreWriter(path) as w:
        for i, n in enumerate(LENS):
            w.add(f"u{i}", rng.normal(size=(n, IN)).astype(np.float32),
                  rng.normal(size=(n, OUT)).astype(np.float32))
    return UtteranceStore([path])


def trainer(kind: str):
    gen = torch.Generator().manual_seed(0)
    g = ResLstmGenerator(IN, OUT, variant="l", cell_size=GU,
                         lstm_impl="wavefront", generator=gen)
    if kind == "mse":
        return MseTrainer(g, output_dim=OUT, l2_scale=1e-3,
                          max_grad_norm=15.0)
    d = LstmDiscriminator(input_dim=OUT, cell_size=DU, num_projection=OUT,
                          lstm_impl="wavefront", generator=gen)
    return GanTrainer(g, d, output_dim=OUT, input_dim=IN, l2_scale=1e-3)


# what the CPU path reaches of each layer's spans (the launch.* spans are
# the kernels' host side, on the card only)
TRAIN_SPANS = {"feed.plan", "feed.to_device", "feed.gather", "train.step",
               "train.backward", "opt.clip", "opt.update", "opt.apply",
               "glue.stack_fwd", "glue.stack_bwd", "glue.layer_bwd"}
GAN_SPANS = TRAIN_SPANS | {"train.d_update", "train.g_update",
                           "glue.seq_fwd", "glue.seq_bwd"}


@pytest.mark.parametrize("kind", ["mse", "gan"])
def test_gathered_train_step_records_its_spans(record, store, kind):
    """Two iterations of the device-feed loop (``feed.plan``,
    ``plan_to_device``, ``train_step_gathered``), armed: every span the
    CPU path reaches, two units, the optimizer once per update, no
    blocking copy on the CPU."""
    tr = trainer(kind)
    state = tr.init_state()
    feed = pfeed.DeviceFeed(store, device=CPU)
    batcher = SequenceBatcher(store, 4, shuffle=True, seed=2)
    plans = list(batcher.iter_index_batches())[:2]
    spans.enable()
    for indices in plans:
        st, le = feed.plan(indices)
        t_pad = port_train.plan_key(np.asarray(le), 20)[0]
        dev = port_train.plan_to_device(st, le, CPU)
        if kind == "gan":
            tr.train_step_gathered(state, feed.inputs_tbl, feed.labels_tbl,
                                   *dev, HP, None, t_pad, 0, 0)
        else:
            tr.train_step_gathered(state, feed.inputs_tbl, feed.labels_tbl,
                                   *dev, HP["g_lr"], t_pad, 0, 0)
    r = spans.read()
    names = {s.name for s in r.spans}
    assert names == (GAN_SPANS if kind == "gan" else TRAIN_SPANS)
    assert r.units("train.step") == 2
    updates = 3 if kind == "gan" else 1
    assert r.units("opt.update") == 2 * updates
    assert r.units("train.backward") == 2 * updates
    assert r.total("host_wait") == 0
    steps = [s for s in r.spans if s.name == "train.step"]
    assert steps[1].unit == steps[0].unit + 1
    # every span inside a step carries the step's unit
    for s in r.spans:
        for step in steps:
            if step.start_ns <= s.start_ns and s.end_ns <= step.end_ns:
                assert s.unit == step.unit, s.name


def test_batched_decode_records_its_spans(record, store):
    """``_decode_batched`` over eight utterances at B=3, armed: within
    the pass, the order by padded length, a ``decode.batch`` unit a
    batch, its assembly and denormalisation inside, G's forward on the
    stack, the rows to the writer."""
    g = ResLstmGenerator(IN, OUT, variant="l", cell_size=GU,
                         lstm_impl="wavefront",
                         generator=torch.Generator().manual_seed(0)).eval()

    @torch.no_grad()
    def infer(inputs, lengths):
        return g(torch.from_numpy(inputs), torch.from_numpy(lengths)).numpy()

    class Writer:
        def __init__(self):
            self.rows = {}

        def write_next_utt(self, ark_path, utt_id, mat):
            self.rows[utt_id] = mat

    args = argparse.Namespace(decode_batch_size=3, left_context=0,
                              right_context=0)
    cmvn = Cmvn(mean=np.zeros(OUT), stddev=np.ones(OUT))
    writer = Writer()
    spans.enable()
    port_train._decode_batched(args, store, infer, cmvn, writer, "")
    r = spans.read()
    assert len(writer.rows) == len(LENS)
    assert {s.name for s in r.spans} == {
        "decode.pass", "decode.order", "decode.batch", "decode.assemble",
        "decode.denormalize", "glue.stack_fwd", "decode.write"}
    batches = [s for s in r.spans if s.name == "decode.batch"]
    assert len(batches) == 3   # 8 utterances in one 128-frame bucket
    assert [b.unit for b in batches] == list(range(
        batches[0].unit, batches[0].unit + 3))
    for name in ("decode.assemble", "decode.denormalize", "glue.stack_fwd"):
        inner = [s for s in r.spans if s.name == name]
        assert len(inner) == 3
        assert [s.unit for s in inner] == [b.unit for b in batches]
    assert all(s.parent in {b.id for b in batches} for s in r.spans
               if s.name in ("decode.assemble", "decode.denormalize"))


# ---------------------------------------------------------------------------
# on the card: the blocking copies of each launch
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available() or _build.find_nvcc() is None:
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def inside(r, span, name):
    """The counts of ``name`` on ``span``'s thread while it was open."""
    return sum(c.n for c in r.counts if c.name == name
               and c.thread == span.thread
               and span.start_ns <= c.t_ns <= span.end_ns)


@pytest.mark.cuda
def test_host_waits_per_launch_match_the_launch_counters(record,
                                                         cuda_device,
                                                         monkeypatch):
    """K4 (train and decode), K1 on both routes, K2 and K3 on its
    row-group and resident routes, and an Adam update, armed, twice over
    the same shapes from an empty cache of device constants
    (``ops/resident.py``). First pass: a launch copies each of its
    constants (the unit index and the bounds of a K2, K4 or resident-route
    K1/K3 launch, the rows of a row-group K1/K3 launch) that no launch
    before it copied, one ``host_wait`` and one ``launch.setup_miss``
    each; second pass: no launch copies anything, each reuses its two
    constants or its one (``launch.setup_hit``). An Adam update of one
    state, on the fused path (``ops/optim.py``), copies its tables in its
    first update (one ``host_wait``, in ``opt.upload``) and nothing in the
    second. The launch spans hold the plan, the packing, the uploads and
    the call."""
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    from rsrgan_tpu_torch.ops import resident
    from rsrgan_tpu_torch.ops import wavefront as wf
    from rsrgan_tpu_torch.ops.wavefront_stack import _kernel_args
    from rsrgan_tpu_torch.training.state import NetState

    monkeypatch.setattr(resident, "_CONSTANTS", {})
    gen = torch.Generator().manual_seed(3)
    dev = cuda_device

    def u(*shape):
        return (torch.rand(shape, generator=gen) - 0.5).to(dev)

    def layer(T, B, U, P, cdt):
        lens = torch.full((B,), T, dtype=torch.int32, device=dev)
        return (u(T, B, 4 * U).to(cdt), lens, u(P, 4 * U).to(cdt),
                u(U, P).to(cdt), u(4 * U), u(U), u(U), u(U))

    bf16 = torch.bfloat16
    routes = {"k1": ls.lstm_fwd, "k2": ls.lstm_bwd, "k3": ls.lstm_bwd_acc,
              "k4_train": wf.lstm_wavefront_fwd_train,
              "k4_decode": wf.lstm_wavefront_fwd}
    net = NetState(torch.nn.Linear(3, 2).to(dev), "adam", 15.0)

    def one_pass(table_copies):
        before = {k: (w.launches, dict(getattr(w, "launches_by_route", {})))
                  for k, w in routes.items()}
        spans.clear()
        spans.enable()
        for T, B, U, P in ((9, 16, 256, 40), (9, 32, 256, 40),
                           (9, 16, 760, 257), (9, 32, 760, 257)):
            xw, lens, w_h, proj, bias, wi, wf_, wo = layer(T, B, U, P, bf16)
            out, c, h, acts = ls.lstm_fwd(xw, lens, w_h, proj, bias, wi,
                                          wf_, wo)
            dout = u(T, B, P)
            ls.lstm_layer_bwd(acts, lens, dout, c, h, w_h, proj, wi, wf_,
                              wo)
        x = u(9, 8, 40)
        params = [{"kernel": u(80, 4 * 256), "bias": u(4 * 256),
                   "proj_kernel": u(256, 40), "w_i_diag": u(1, 256),
                   "w_f_diag": u(1, 256), "w_o_diag": u(1, 256)}
                  for _ in range(2)]
        xw1, wx, wh, proj, bias, wi, wf_, wo, _ = _kernel_args(x, params,
                                                               1.0, bf16)
        lens = torch.full((8,), 9, dtype=torch.int32, device=dev)
        wf.lstm_wavefront_fwd_train(xw1, lens, x, wx, wh, proj, bias, wi,
                                    wf_, wo, residual=False)
        wf.lstm_wavefront_fwd(xw1, lens, x, wx, wh, proj, bias, wi, wf_, wo,
                              residual=False)
        net.apply_gradients({k: torch.ones_like(p) for k, p in
                             net.params().items()}, 1e-3, 0.999)
        torch.cuda.synchronize()
        spans.disable()
        r = spans.read()
        launched = {k: w.launches - before[k][0] for k, w in routes.items()}
        by_route = {k: {n: m - before[k][1].get(n, 0) for n, m in
                        getattr(w, "launches_by_route", {}).items()}
                    for k, w in routes.items()}
        assert launched == {"k1": 4, "k2": 2, "k3": 2, "k4_train": 1,
                            "k4_decode": 1}
        assert by_route["k1"] == {"rowgroup": 2, "resident": 2}
        assert by_route["k3"] == {"rowgroup": 1, "resident": 1}
        per_launch = {k: [(inside(r, s, "host_wait"),
                           inside(r, s, "launch.setup_miss"),
                           inside(r, s, "launch.setup_hit"))
                          for s in r.spans if s.name == f"launch.{k}"]
                      for k in routes}
        assert {k: len(v) for k, v in per_launch.items()} == launched
        assert [inside(r, s, "host_wait") for s in r.spans
                if s.name == "opt.upload"] == [1] * table_copies
        assert [inside(r, s, "host_wait") for s in r.spans
                if s.name in ("opt.clip", "opt.update")] == [0, 0]
        assert r.total("opt.fused") == 1
        waits = sum(w for v in per_launch.values() for w, _, _ in v)
        assert r.total("host_wait") == waits + table_copies
        return r, per_launch

    # (host_wait, launch.setup_miss, launch.setup_hit) of each launch, in
    # launch order: K1 on D at 16 and 32 rows, then at G width; K3 on D at
    # 32 rows reads K1's 32 rows, K3's resident walk K2's 16-row G slices,
    # K1 at G width at 32 rows its 16-row slices, K4 decode K4 train's
    r, first = one_pass(1)
    assert first == {"k1": [(1, 1, 0), (1, 1, 0), (2, 2, 0), (0, 0, 2)],
                     "k2": [(2, 2, 0), (2, 2, 0)],
                     "k3": [(0, 0, 1), (0, 0, 2)],
                     "k4_train": [(2, 2, 0)], "k4_decode": [(0, 0, 2)]}
    assert r.total("launch.setup_miss") == len(resident._CONSTANTS) == 10
    names = {s.name for s in r.spans}
    assert {"launch.plan", "launch.pack", "launch.upload",
            "launch.call"} <= names
    r, second = one_pass(0)
    assert second == {"k1": [(0, 0, 1), (0, 0, 1), (0, 0, 2), (0, 0, 2)],
                      "k2": [(0, 0, 2), (0, 0, 2)],
                      "k3": [(0, 0, 1), (0, 0, 2)],
                      "k4_train": [(0, 0, 2)], "k4_decode": [(0, 0, 2)]}
    assert r.total("host_wait") == 0 and r.units("launch.upload") == 0
    assert len(resident._CONSTANTS) == 10
