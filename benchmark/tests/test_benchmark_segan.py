"""The cells this benchmark adds: SEGAN's frame cell (``segan_b256``,
driver ``train_frames``) and the four-card flagship (``gan_b8x4``,
driver ``train_gathered_dp``). Their files resolve by name; the frame
traffic follows ``--seed`` and its table is ``FrameBatcher``'s; the
convolutions' operations and bytes and SEGAN's model FLOPs against
numbers worked out by hand; the new readers on synthetic traces; tiny
runs on the CPU come out ``correct`` when sound and not when broken
underneath; the yardstick imports nothing of the program."""

import ast
import os

import numpy as np
import pytest
import torch
from bench_tiny_cells import tiny_segan_cell

from benchmark import conv, harness, roofline, run
from benchmark.traffic import frames

MAN = harness.manifest()
NEW = ["segan_b256", "gan_b8x4"]
HBM = 3.35e12


@pytest.mark.parametrize("name", NEW)
def test_new_cells_resolve(name):
    cell = harness.cell(name, MAN)
    assert cell.entry["chips"] in (1, 4)
    four = [w for w in MAN["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(MAN["workloads"]) // 4)
    driver = harness.driver(cell.workload["driver"])
    assert callable(driver.run) and callable(driver.Session)
    for m in ("warm", "window", "free", "reference", "faults", "numbers",
              "detail"):
        assert callable(getattr(driver.Session, m))
    assert set(cell.workload["limits"])
    assert harness.reference(cell.config["reference"]).g_shapes
    assert callable(harness.generator(cell.mix).lengths)
    e2e = [m["name"] for m in harness.metrics_for(MAN, name, False)]
    assert {"setup_s", "train_frames_per_s", "train_iter_ms_p95"} <= set(e2e)
    for m in harness.metrics_for(MAN, name, True):
        assert m["moves"] in e2e
        assert callable(harness.metric_reader(m["name"]))


def test_segan_configuration_states_the_recipe():
    """The flags the program is built from say what the reference is
    told, at the published widths; the leaves number G's 47,229,689 and
    D's 24,403,298 parameters."""
    from rsrgan_tpu_torch.cli.train import parse_args, segan_depths
    cfg = harness.cell("segan_b256", MAN).config
    args, unknown = parse_args(cfg["cli"])
    assert not unknown and cfg["reduced"] == []
    g, d, hp = cfg["generator"], cfg["discriminator"], cfg["hparams"]
    assert args.trainer == "segan" and args.g_type == g["type"] == "ae"
    assert (args.input_dim, args.output_dim) == (g["input_dim"],
                                                 g["output_dim"])
    assert (args.left_context, args.right_context) == (
        g["left_context"], g["right_context"])
    assert list(segan_depths(args)) == g["enc_depths"] == d["num_fmaps"]
    assert d["input_width"] == 257 * 7 + 40
    assert (args.g_learning_rate, args.d_learning_rate) == (hp["g_lr"],
                                                            hp["d_lr"])
    assert args.init_l1_weight == hp["l1_weight"]
    assert args.init_disc_noise_std == hp["disc_noise_std"]
    assert (args.disc_updates, args.gen_updates) == (hp["disc_updates"],
                                                     hp["gen_updates"])
    assert args.bias_deconv == g["bias_deconv"]
    assert args.bias_downconv == g["bias_downconv"]
    assert args.bias_d_conv == d["bias_conv"] and args.g_nl == g["g_nl"]
    assert cfg["precision"] == "float32"
    ref = harness.reference(cfg["reference"])
    count = [sum(int(np.prod(s)) for s in shapes.values()) for shapes in
             (ref.g_shapes(g), ref.d_shapes(d))]
    assert count == [47_229_689, 24_403_298]


def test_frames_follow_the_seed_and_are_the_batchers_table():
    from rsrgan_tpu_torch.data import FrameBatcher
    mix = dict(harness.cell("segan_b256", MAN).mix, utterances=12,
               min_frames=5, max_frames=9)
    lens = frames.lengths(mix)
    a = frames.tables(lens, (6, 2), 11, "cpu")
    b = frames.tables(lens, (6, 2), 11, "cpu")
    c = frames.tables(lens, (6, 2), 12, "cpu")
    assert a[0].shape == (int(lens.sum()), 6) and a[1].shape[1] == 2
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    first = frames.starts(lens)

    class Store:
        has_labels = True

        def __len__(self):
            return len(lens)

        def inputs(self, i):
            return a[0][first[i]:first[i] + lens[i]]

        def labels(self, i):
            return a[1][first[i]:first[i] + lens[i]]

    want = FrameBatcher(Store(), 4, 3, 3).inputs
    got = frames.spliced(a[0], lens, 3, 3, threads=3)
    assert got.dtype == np.float32 and np.array_equal(got, want)


def test_convolution_parts_by_hand():
    """in 2, out 3, width 4, stride 2, 5 positions, one row: 3 outputs;
    2 * 3 * 2 * 4 * 3 = 144 FLOPs a part; bytes x 40 + kernel 96 + y
    36. Transposed: 10 outputs, each of the 5 inputs meets the kernel
    once: 240 FLOPs; y 120."""
    key = "in=2,out=3,k=4,stride=2,L=5,rows=1,transposed=0,dx=1,dw=1"
    assert conv.conv_parts(roofline.parse_key(key)) == [
        ("fwd", 144.0, 172), ("dx", 144.0, 172), ("dw", 144.0, 172)]
    t = roofline.parse_key(key.replace("transposed=0", "transposed=1")
                           .replace("dx=1", "dx=0"))
    assert conv.out_length(t) == 10
    assert conv.conv_parts(t) == [("fwd", 240.0, 256), ("dw", 240.0, 256)]
    assert conv.conv_bound_ms(key) == pytest.approx(3 * 172 / HBM * 1e3)
    big = "in=512,out=1024,k=31,stride=2,L=2,rows=256,transposed=0,dx=0,dw=0"
    flops = 2 * 256 * 1 * 512 * 31 * 1024
    assert conv.conv_bound_ms(big) == pytest.approx(flops / 67e12 * 1e3)


def test_segan_model_flops_by_hand():
    """G's forward a row: its 22 convolutions and dec_out, 328,241,280
    FLOPs (0.33 G); D's, 170,743,042; an iteration: the D step (G, and
    D twice with its backward but its first input's gradient) and the G
    step (G with its backward but its first input's gradient, D with
    its input gradients only)."""
    cfg = harness.cell("segan_b256", MAN).config
    g, d = cfg["generator"], cfg["discriminator"]
    enc = conv.g_convs(g)[:11]
    assert enc[0] == dict(rows=1, **{"in": 1}, out=16, k=20, stride=2,
                          L=1799, transposed=0)
    assert conv.g_convs(g)[-1]["L"] == 900 and conv.g_convs(g)[11]["in"] \
        == 2048
    gf, df = 328_241_280, 170_743_042
    g_first, d_first = 2 * 900 * 20 * 16, 2 * 920 * 31 * 16
    d_step = gf + 2 * (3 * df - d_first)
    g_step = 3 * gf - g_first + 2 * df
    assert conv.segan_iteration_flops(cfg) == d_step + g_step \
        == 2_676_508_176


def test_step_convs_by_hand():
    """The program's keys of one iteration at the configuration's widths
    (rows 256): G's recorded calls take their kernel's gradient, its
    unrecorded ones (the D step's G) none; D's first layer by ``dx``
    (data: the D step's two calls; G's output: the G step's); D's other
    layers 2 of every 3 calls (1 D step, 1 G step)."""
    cfg = harness.cell("segan_b256", MAN).config

    def key(c, o, k, L, grad, dx, t=0):
        return (f"in={c},out={o},k={k},stride=2,L={L},rows=256,"
                f"transposed={t},grad={grad},dx={dx}")
    counts = {key(1, 16, 20, 1799, 0, 0): 1, key(1, 16, 20, 1799, 1, 0): 1,
              key(2048, 512, 20, 2, 1, 1, 1): 1,
              key(1, 16, 31, 1839, 1, 0): 2, key(1, 16, 31, 1839, 1, 1): 1,
              key(16, 32, 31, 920, 1, 1): 3}
    got = conv.step_convs(counts, cfg)
    assert got == {key(1, 16, 20, 1799, 0, 0) + ",dw=0": 1,
                   key(1, 16, 20, 1799, 1, 0) + ",dw=1": 1,
                   key(2048, 512, 20, 2, 1, 1, 1) + ",dw=1": 1,
                   key(1, 16, 31, 1839, 1, 0) + ",dw=1": 2,
                   key(1, 16, 31, 1839, 1, 1) + ",dw=0": 1,
                   key(16, 32, 31, 920, 1, 1) + ",dw=1": 2,
                   key(16, 32, 31, 920, 1, 1) + ",dw=0": 1}
    assert [p for p, _, _ in conv.conv_parts(roofline.parse_key(
        key(16, 32, 31, 920, 1, 1) + ",dw=0"))] == ["fwd", "dx"]
    with pytest.raises(ValueError):
        conv.step_convs({key(16, 32, 31, 920, 1, 1): 4}, cfg)


CUDNN = ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_"
         "tilesize256x64x8_stage3_warpsize2x2x1_g1_ffma_aligna4_alignc4_"
         "execute_kernel__5x_cudnn")
LEGACY = "void cudnn::detail::dgrad_engine<float, 512, 6, 5, 3, 3, 3, false>"
GEMM = ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize32x32x8_stage3_"
        "warpsize1x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas")
NCCL = ("ncclDevKernel_AllReduce_Sum_f32_RING_LL("
        "ncclDevKernelArgsStorage<4096ul>)")


def test_the_new_readers_on_a_synthetic_trace():
    key = "in=512,out=1024,k=31,stride=2,L=2,rows=256,transposed=0,dx=1,dw=1"
    trace = {"device_s_by_name": {CUDNN: 2e-3, LEGACY: 1e-3, GEMM: 5e-3,
                                  NCCL: 4e-3},
             "window_s": 1.0, "busy_s": 0.5, "launches": 10}
    run_ = {"kind": "train", "trace": trace, "traced": {
        "iterations": 2, "paced_s": 1.0,
        "per_iter": [{"convs": {key: 1}}, {"convs": {key: 2}}]}}
    read = harness.metric_reader
    assert read("conv_ms_per_iter.train")(run_) == pytest.approx(1.5)
    assert read("comm_ms_per_iter.train")(run_) == pytest.approx(2.0)
    want = 3 * conv.conv_bound_ms(key) / 1e3 / 3e-3 * 100
    assert read("roofline.conv.train")(run_) == pytest.approx(want)
    # a run without counts or without such rows: nothing to read
    bare = dict(run_, traced=dict(run_["traced"], per_iter=[{"k2": {}}]))
    assert read("roofline.conv.train")(bare) is None
    empty = dict(run_, trace=dict(trace, device_s_by_name={GEMM: 1e-3}))
    for name in ("conv_ms_per_iter.train", "comm_ms_per_iter.train",
                 "roofline.conv.train"):
        assert read(name)(empty) is None
        assert read(name)(dict(run_, trace=None)) is None


def execute(cell, trace=False, seed=2 ** 31 + 11):
    rc, line, _ = run.execute(MAN, cell, seed, 0.3, trace,
                              torch.device("cpu"), 0.0)
    assert rc == 0
    return line


def test_a_sound_segan_run_is_correct():
    line = execute(tiny_segan_cell(), trace=True)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    got = line["metrics"]
    for name in ("host_ms_per_iter.feed.train",
                 "host_ms_per_iter.optimizer.train", "idle_share.train",
                 "launches_per_iter.train", "mfu.train",
                 "host_ms_per_iter.segan.train"):
        assert name in got, name
    assert got["host_waits_per_iter.train"]["value"] == 0   # the CPU
    assert "conv_ms_per_iter.train" not in got   # no device rows here


def _unchanged_state(monkeypatch):
    from rsrgan_tpu_torch.training.state import NetState
    monkeypatch.setattr(NetState, "apply_gradients",
                        lambda self, grads, lr, ema_decay: None)


def _half_batch(monkeypatch):
    from rsrgan_tpu_torch.training.segan import SeganTrainer
    orig = SeganTrainer.train_step

    def half(self, state, x, y, *rest):
        h = max(1, x.shape[0] // 2)
        return orig(self, state, x[:h], y[:h], *rest)
    monkeypatch.setattr(SeganTrainer, "train_step", half)


def _unflipped_kernel(monkeypatch):
    """The transposed convolutions scatter through the kernel as it is,
    not reversed along its width (``ConvTranspose1d``'s docstring)."""
    import torch.nn.functional as F

    from rsrgan_tpu_torch.ops.modules import ConvTranspose1d

    def forward(self, x):
        y = F.conv_transpose1d(x, self.kernel.permute(1, 2, 0), self.bias,
                               stride=self.stride, padding=self.padding,
                               output_padding=max(self.extra, 0))
        return y[..., :x.shape[-1] * self.stride] if self.extra < 0 else y
    monkeypatch.setattr(ConvTranspose1d, "forward", forward)


def _scaled_g_grads(monkeypatch):
    """G's gradients a quarter too large, their signs right: RMSProp's
    first steps are near a sign, so only the gradient itself shows it."""
    from rsrgan_tpu_torch.training.segan import SeganTrainer
    orig = SeganTrainer._update

    def update(self, tag, net, loss, metrics, lr):
        if tag != "g":
            return orig(self, tag, net, loss, metrics, lr)
        apply = net.apply_gradients

        def scaled(grads, lr, ema_decay):
            grads = {k: 1.25 * g for k, g in grads.items()}
            if self.grad_log is not None:
                self.grad_log[-1] = (tag, grads)
            return apply(grads, lr, ema_decay)
        net.apply_gradients = scaled
        try:
            return orig(self, tag, net, loss, metrics, lr)
        finally:
            del net.apply_gradients
    monkeypatch.setattr(SeganTrainer, "_update", update)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch,
                                   _unflipped_kernel, _scaled_g_grads])
def test_a_segan_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    line = execute(tiny_segan_cell())
    assert not line["correct"], line["checks"]


def test_calibrate_reads_the_g_side_fault():
    """The reference with G's backward products in TF32 is one of the
    cell's faults: it leaves every forward and D's step as they were
    (the first iteration's losses and D's first gradient read 0) and
    moves G's first gradient, read against the program's D after its
    first step, by far more than the program's own distance."""
    import time

    from benchmark import calibrate
    from benchmark.trace import Tracer
    dev = torch.device("cpu")
    ctx = harness.Ctx(cell=tiny_segan_cell(), seed=2 ** 31 + 5, seconds=0.0,
                      tracer=Tracer(False, dev), device=dev,
                      t0=time.monotonic())
    got = calibrate.readings(ctx, False, True)
    fault, program = got["g_grad_tf32"], got["program"]
    assert fault["first_loss_gap"] == fault["d_grad_gap"] == 0.0
    assert fault["g_grad_dist"] > 100 * program["g_grad_dist"]
    for part in ("g_first:g", "change_element:g", "change_element:d"):
        assert part in got["detail"], part


@pytest.mark.parametrize("path", ["reference/segan.py", "conv.py",
                                  "traffic/frames.py"])
def test_the_yardstick_imports_nothing_of_the_program(path):
    tree = ast.parse(open(os.path.join(harness.BENCH_DIR, path)).read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    assert not tops & {"rsrgan_tpu_torch", "rsrgan_tpu", "jax", "flax"}
