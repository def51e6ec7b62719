"""The port's measurement tools (rsrgan_tpu_torch/tools: kernel_bench,
profile_step, serve_bench, io_bench) and ``tools.experiments
--recipe=micro`` on the CPU, against the repo's tools and recipe.

- kernel_bench's five segment functions against the JAX tool's, rebuilt
  here on ``rsrgan_tpu.ops.wavefront_stack.lstm_stack_wavefront``
  (Pallas in interpreter mode) at L=2, U=16, P=8, B=3, T=7, f32, on the
  same numpy parameters: forwards to 1e-5, gradients to 2e-4 (the
  ladder's, tests/test_pallas_lstm.py);
- profile_step's report of a synthetic Chrome trace: the rollup, the
  launches and busy share a step, the idle gaps, the host time by port
  function; and a real CPU trace;
- serve_bench's ``bench`` against the JAX tool's on both packages'
  StreamingEnhancer at one lane, 10-frame chunks: the same keys;
- io_bench on both packages: the same stages (less ark-bcm-c++) and
  frame totals on the same seed;
- ``--recipe=micro``: its calls against run_micro.sh's own (the shell
  under a recording ``python``), and a run on the CPU;
- every tool's default device (cuda) raises without a card, and no new
  module imports jax or rsrgan_tpu.
"""

import ast
import contextlib
import json
import os
import runpy
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rsrgan_tpu.ops.wavefront_stack import lstm_stack_wavefront as jax_stack
from rsrgan_tpu_torch.tools import (experiments, io_bench, kernel_bench,
                                    profile_step, serve_bench)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L_, U_, P_, B_, T_ = 2, 16, 8, 3, 7
LENS = [7, 5, 2]
LENS2 = [7, 5, 2, 6, 3, 1]
FWD_TOL, GRAD_TOL = 1e-5, 2e-4


def jax_segments():
    """The JAX tool's segment functions (its main()'s closures), on
    ragged lengths, f32."""
    lg = jnp.asarray(LENS, jnp.int32)
    ld2 = jnp.asarray(LENS2, jnp.int32)
    f32 = jnp.float32

    def g_infer(x, ps):
        return jax_stack(x, lg, ps, residual=True, compute_dtype=f32,
                         save_acts=False)

    def g_fwd(x, ps):
        return jax_stack(x, lg, ps, residual=True, compute_dtype=f32)

    def g_fwdbwd(x, ps):
        def loss(p):
            y = jax_stack(x, lg, p, residual=True, compute_dtype=f32)
            return jnp.sum(y * y)
        return jax.grad(loss)(ps)[0]["kernel"]

    def d_fwd2b(x, ps):
        return jax_stack(x, ld2, ps, residual=False, compute_dtype=f32)

    def d_fwdbwd(x, ps):
        def loss(xin):
            y = jax_stack(xin, lg, ps, residual=False, compute_dtype=f32)
            return jnp.sum(y * y)
        return jax.grad(loss)(x)

    return {"g_infer": g_infer, "g_fwd": g_fwd, "g_fwdbwd": g_fwdbwd,
            "d_fwd2b": d_fwd2b, "d_fwdbwd": d_fwdbwd}


@pytest.mark.parametrize("segment", list(kernel_bench.SEGMENTS))
def test_kernel_bench_segment_matches_jax_tool(segment):
    rng = np.random.default_rng(3)
    params = kernel_bench.make_params(rng, L_, P_, U_, P_, scale=0.5)
    rows = 2 * B_ if segment == "d_fwd2b" else B_
    x = rng.normal(size=(rows, T_, P_)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_segments()[segment](
            jnp.asarray(x), [{k: jnp.asarray(v) for k, v in p.items()}
                             for p in params]))
    lens = torch.tensor(LENS2 if segment == "d_fwd2b" else LENS)
    got = kernel_bench.SEGMENTS[segment](
        torch.from_numpy(x), lens, kernel_bench.to_device(params, "cpu"),
        torch.float32)
    assert got.shape == want.shape
    tol = GRAD_TOL if segment.endswith("bwd") else FWD_TOL
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol)
    assert np.abs(want).max() > 10 * tol


def test_kernel_bench_main_on_the_cpu(capsys, monkeypatch):
    """The whole tool at full width, B=2, T=4, one application a window:
    the card line, a line a segment, the JSON line."""
    monkeypatch.setattr(kernel_bench, "K", 1)
    assert kernel_bench.main(["2", "4", "--device=cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("cpu")
    names = ["g_infer", "g_fwd", "g_fwdbwd", "d_fwd2b", "d_fwdbwd", "full"]
    assert [ln.split()[0] for ln in lines[1:-1]] == names
    assert all("ms" in ln and "frames/s" in ln for ln in lines[1:-1])
    out = json.loads(lines[-1])
    assert out["metric"] == "kernel_bench_ms"
    assert all(out[n] > 0 for n in names)


def test_kernel_bench_full_step_loads_the_segment_parameters():
    """``full``'s G and D carry the segments' numpy LSTM parameters
    (models/bridge.py), and its dense layers are seeded."""
    rng = np.random.default_rng(0)
    g_np = kernel_bench.make_params(rng, **kernel_bench.G_SIZES)
    d_np = kernel_bench.make_params(rng, **kernel_bench.D_SIZES)
    trainer = kernel_bench.flagship_trainer(g_np, d_np, "cpu")
    g = dict(trainer.generator.named_parameters())
    d = dict(trainer.discriminator.named_parameters())
    for k in range(4):
        for name, v in g_np[k].items():
            assert np.array_equal(g[f"lstm_cell_{k + 1}.{name}"].detach()
                                  .numpy(), v)
    for k in range(2):
        assert np.array_equal(
            d[f"StackedLstm_0.cell_{k}.kernel"].detach().numpy(),
            d_np[k]["kernel"])
    again = kernel_bench.flagship_trainer(g_np, d_np, "cpu")
    assert torch.equal(g["forward_out.kernel"],
                       dict(again.generator.named_parameters())[
                           "forward_out.kernel"])


# --------------------------------------------------------------------------
# profile_step
# --------------------------------------------------------------------------

def X(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def py(path, fn, ts, dur, tid=1):
    return X("python_function", f"{path}(10): {fn}", ts, dur, tid)


def synthetic_trace(path):
    """Two 10 ms steps. Device rows a step (µs): the resident kernel
    3000, a cuBLAS product 1000, a reduction 500, an elementwise 1000, a
    device copy 500 and a set 100 (6 rows, busy 6100 in two runs: idle
    2100 before them, 300 between, 1500 after). Host a step: lstm_fwd's
    frame 4000 µs holding pack_fwd_weights 1000 µs and the plan 500 µs
    (both inside it), an aten op 300 µs and a copy's runtime call 100 µs
    inside the packing, three
    kernel launches (20 µs each, two of them inside lstm_fwd), and the
    train step's frame around it all; and on another thread (the
    autograd engine) a backward frame of 2000 µs. The program's spans a
    step: the step around it all, the launch's around lstm_fwd, holding
    the packing (1000 µs, an upload of 100 inside), the plan (500) and
    the call (40); the optimizer's update (300) and apply (100) and the
    feed's gather (50); on the other thread the stack's backward."""
    ev = [{"ph": "M", "name": "process_name", "pid": 1, "tid": 0}]
    for s in range(2):
        t = 100_000 + s * 10_000
        ev += [X("user_annotation", f"profile_step#{s}", t, 10_000),
               py("/x/rsrgan_tpu_torch/training/gan.py", "train_step",
                  t + 10, 9_900),
               py("rsrgan_tpu_torch/ops/lstm_seq.py", "lstm_fwd",
                  t + 100, 4_000),
               py("rsrgan_tpu_torch/ops/lstm_seq.py", "pack_fwd_weights",
                  t + 200, 1_000),
               py("rsrgan_tpu_torch/ops/lstm_seq.py", "rowgroup_plan",
                  t + 1_300, 500),
               py("torch/nn/modules/module.py", "_call_impl", t + 210, 5),
               X("user_annotation", "train.step", t + 10, 9_900),
               X("user_annotation", "feed.gather", t + 20, 50),
               X("user_annotation", "launch.k1", t + 100, 4_000),
               X("user_annotation", "launch.pack", t + 200, 1_000),
               X("user_annotation", "launch.upload", t + 250, 100),
               X("user_annotation", "launch.plan", t + 1_300, 500),
               X("user_annotation", "launch.call", t + 1_990, 40),
               X("user_annotation", "opt.update", t + 8_500, 300),
               X("user_annotation", "opt.apply", t + 8_850, 100),
               X("user_annotation", "glue.stack_bwd", t + 6_000, 2_000,
                 tid=2),
               X("cpu_op", "aten::copy_", t + 300, 300),
               X("cuda_runtime", "cudaMemcpyAsync", t + 450, 100),
               X("cpu_op", "aten::mm", t + 5_000, 200),
               X("cuda_runtime", "cudaLaunchCooperativeKernel", t + 2_000,
                 20),
               X("cuda_runtime", "cudaLaunchKernel", t + 3_000, 20),
               X("cuda_runtime", "cudaLaunchKernel", t + 6_000, 20),
               py("rsrgan_tpu_torch/ops/wavefront_stack.py", "backward",
                  t + 6_000, 2_000, tid=2),
               X("kernel", "void wavefront_resident_kernel<__nv_bfloat16>"
                 "(ResidentParams)", t + 2_100, 3_000, tid=7),
               X("kernel", "sm90_xmma_gemm_bf16bf16_bf16f32", t + 5_100,
                 1_000, tid=7),
               X("kernel", "void at::native::reduce_kernel<512, 1>",
                 t + 8_000, 500, tid=7),
               X("kernel", "void at::native::vectorized_elementwise_kernel"
                 "<4, at::native::AddFunctor<float>>", t + 6_100, 1_000,
                 tid=7),
               X("gpu_memcpy", "Memcpy DtoD (Device -> Device)", t + 7_100,
                 500, tid=7),
               X("gpu_memset", "Memset (Device)", t + 7_600, 100, tid=7)]
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


def test_profile_step_report_of_a_synthetic_trace(tmp_path, capsys):
    path = tmp_path / "trace.json"
    synthetic_trace(path)
    assert profile_step.main(["--trace", str(path), "2"]) == 0
    text = capsys.readouterr().out
    out = json.loads(text.strip().splitlines()[-1])
    assert out["metric"] == "profile_step" and out["step_ranges"] == 2
    assert out["rollup_ms_per_step"] == pytest.approx({
        "hand kernel wavefront_resident_kernel": 3.0,
        "cuBLAS products": 1.0,
        "other elementwise/glue": 1.0,
        "copies/slices": 0.6,
        "reductions (loss/clip/EMA)": 0.5})
    assert "3.000 ms/step (49.2%)  hand kernel wavefront_resident_kernel" \
        in text
    assert out["wall_ms_per_step"] == pytest.approx(10.0)
    assert out["device_busy_ms_per_step"] == pytest.approx(6.1)
    assert out["device_busy_share"] == pytest.approx(0.61)
    assert out["launch_calls_per_step"] == 3
    assert out["device_rows_per_step"] == 6
    # the longest gaps first (the first step's last gap runs into the
    # second step's first), each with the innermost port frame at its
    # middle: both long ones 1050 µs into a step, inside the packing
    gaps = out["idle_gaps"]
    assert [(g["at_ms"], g["ms"]) for g in gaps] == pytest.approx([
        (8.5, 3.6), (0.0, 2.1), (18.5, 1.5), (7.7, 0.3), (17.7, 0.3)])
    assert [g["host_in"] for g in gaps[:2]] == [
        ["ops/lstm_seq.py:pack_fwd_weights"]] * 2
    # the last gap's middle (7.85 ms into the step): the main thread in
    # train_step, the other in the backward
    assert gaps[3]["host_in"] == [
        "training/gan.py:train_step",
        "ops/wavefront_stack.py:backward [other thread]"]
    assert out["idle_ms_per_step"] == pytest.approx(3.9)
    by_fn = out["host_ms_per_step_by_function"]
    assert by_fn == pytest.approx({
        "training/gan.py:train_step": 9.9 - 4.0,
        "ops/lstm_seq.py:lstm_fwd": 4.0 - 1.0 - 0.5,
        "ops/lstm_seq.py:pack_fwd_weights": 1.0,
        "ops/lstm_seq.py:rowgroup_plan": 0.5,
        "ops/wavefront_stack.py:backward [other thread]": 2.0})
    split = out["host_split_ms_per_step"]
    assert split["launch calls"] == pytest.approx(0.06)
    assert split["waits for the device (cudaMemcpy*, *Synchronize)"] == \
        pytest.approx(0.1)
    # the spans' self time: the packing less the upload inside it
    assert split["weight packing (launch.pack)"] == pytest.approx(0.9)
    assert split["plans (launch.plan)"] == pytest.approx(0.5)
    assert split["uploads (launch.upload)"] == pytest.approx(0.1)
    assert split["launch setup (launch.call)"] == pytest.approx(0.04)
    assert split["optimizer (opt.*)"] == pytest.approx(0.4)
    assert split["feed (feed.*)"] == pytest.approx(0.05)
    assert split["top-level aten ops"] == pytest.approx(0.5)
    assert split["copies (top-level aten::copy_/to/clone/contiguous)"] == \
        pytest.approx(0.3)


def test_profile_step_prints_the_setup_hit_share(tmp_path, capsys):
    """The share of reused device constants that a profiled run hands
    ``report``, on the line after the launch setup's row."""
    path = tmp_path / "trace.json"
    synthetic_trace(path)
    line = profile_step.report(str(path), 2, {
        "launch_setup_hits": 199, "launch_setup_misses": 1,
        "launch_setup_hit_share": 0.995})
    text = capsys.readouterr().out.splitlines()
    row = next(i for i, t in enumerate(text) if "(launch.call)" in t)
    assert text[row + 1].split() == [
        "0.9950", "share", "of", "the", "launches'", "device", "constants",
        "reused", "(launch.setup_hit:", "199", "hits,", "1", "misses)"]
    assert line["launch_setup_hit_share"] == 0.995


def test_profile_step_on_the_cpu(tmp_path, capsys, monkeypatch):
    """A real trace (CPU activity, with_stack) of two full-width steps
    at B=2, T=6: the steps' ranges, and the host time in the port's
    frames, the trainer's update among them."""
    path = tmp_path / "t.json"
    monkeypatch.setattr(profile_step, "STEPS", 2)
    assert profile_step.main(["2", "6", f"--out={path}",
                              "--device=cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["step_ranges"] == 2 and out["B"] == 2
    assert out["unprofiled_wall_ms_per_step"] > 0
    by_fn = out["host_ms_per_step_by_function"]
    assert "training/state.py:update" in by_fn
    assert "ops/wavefront.py:lstm_wavefront_fwd_reference" in by_fn
    assert sum(by_fn.values()) <= out["wall_ms_per_step"] * 1.01
    # the program's spans are in the trace: the optimizer's host time
    assert out["host_split_ms_per_step"]["optimizer (opt.*)"] > 0
    # the twins launch nothing: no device constant to count
    assert (out["launch_setup_hits"], out["launch_setup_misses"],
            out["launch_setup_hit_share"]) == (0, 0, None)
    again = profile_step.report(str(path), 2)
    assert again["host_ms_per_step_by_function"] == pytest.approx(by_fn)


# --------------------------------------------------------------------------
# serve_bench
# --------------------------------------------------------------------------

def jax_bench():
    """The JAX tool's ``bench`` alone (its module configures a compile
    cache and builds a full-width model on import)."""
    src = open(os.path.join(REPO, "tools", "serve_bench.py")).read()
    tree = ast.parse(src)
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "bench")
    ns = {"np": np, "jnp": jnp, "time": time, "IN_DIM": 257,
          "FRAME_MS": 10.0}
    exec(compile(ast.Module([fn], []), "serve_bench.py", "exec"), ns)
    return ns["bench"]


def narrow_tree(rng, U=16, P=257, out=40):
    tree = {f"lstm_cell_{k + 1}": {
        "kernel": rng.normal(0, 0.05, (2 * P, 4 * U)).astype(np.float32),
        "bias": np.zeros(4 * U, np.float32),
        "proj_kernel": rng.normal(0, 0.05, (U, P)).astype(np.float32),
        **{f"w_{g}_diag": rng.normal(0, 0.05, (1, U)).astype(np.float32)
           for g in "ifo"}} for k in range(4)}
    tree["forward_out"] = {
        "kernel": rng.normal(0, 0.05, (P, out)).astype(np.float32),
        "bias": np.zeros(out, np.float32)}
    return tree


def test_serve_bench_keys_and_realtime_as_the_jax_tool():
    from rsrgan_tpu.serving import StreamingEnhancer as JaxEnhancer
    from rsrgan_tpu_torch.serving import StreamingEnhancer
    tree = narrow_tree(np.random.default_rng(0))
    want = jax_bench()(JaxEnhancer(jax.tree_util.tree_map(jnp.asarray,
                                                          tree)), 1, 10, 3)
    got = serve_bench.bench(StreamingEnhancer(tree, device="cpu"), 1, 10, 3)
    assert list(got) == list(want)
    assert {k: type(v) for k, v in got.items()} == \
        {k: type(v) for k, v in want.items()}
    assert got["metric"] == "stream_step_latency_ms"
    assert (got["lanes"], got["chunk_frames"], got["chunk_audio_ms"]) == \
        (1, 10, 100.0)
    assert got["realtime_p99"] == (got["p99"] < got["chunk_audio_ms"])
    assert got["p50"] <= got["p95"] <= got["p99"]
    assert got["frames_per_sec_synced"] > 0 and got["pipelined_mean"] > 0


def test_serve_bench_grid_is_the_jax_tools():
    """The (lanes, chunk_frames) loops of the JAX tool's main()."""
    src = open(os.path.join(REPO, "tools", "serve_bench.py")).read()
    main = next(n for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    loops = {n.target.id: ast.literal_eval(n.iter) for n in ast.walk(main)
             if isinstance(n, ast.For)}
    assert (serve_bench.LANES, serve_bench.CHUNK_FRAMES) == (
        loops["lanes"], loops["chunk_frames"])


# --------------------------------------------------------------------------
# io_bench
# --------------------------------------------------------------------------

@contextlib.contextmanager
def unit_clock(monkeypatch):
    """time.perf_counter returning 0, 1, 2, ...: every stage's dt is 1
    s, so its frames/s is its frame total."""
    ticks = iter(range(10 ** 6))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
    yield
    monkeypatch.undo()


@pytest.mark.parametrize("num_utts", [12, 64])
def test_io_bench_stages_and_frames_as_the_jax_tool(monkeypatch, capsys,
                                                     num_utts):
    with unit_clock(monkeypatch):
        got = io_bench.run(num_utts, 400)
    with unit_clock(monkeypatch):
        monkeypatch.setattr(sys, "argv", ["io_bench.py", str(num_utts)])
        capsys.readouterr()
        runpy.run_path(os.path.join(REPO, "tools", "io_bench.py"),
                       run_name="__main__")
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert want.pop("metric") == "io_bench_frames_per_sec"
    want.pop("ark-bcm-c++", None)
    assert got == want
    assert list(got) == ["ark-plain", "ark-bcm-np", "store-build",
                         "store-scan", "batcher-0ctx", "batcher",
                         "prefetch"]
    assert got["ark-plain"] > 0
    # 12 utterances fill no B=16 bucket; 64 do
    assert (got["batcher"] > 0) == (num_utts == 64)


def test_io_bench_main_prints_the_jax_line(capsys):
    assert io_bench.main(["12", "50", "--device=cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("cpu")
    assert json.loads(lines[-1])["metric"] == "io_bench_frames_per_sec"


# --------------------------------------------------------------------------
# --recipe=micro
# --------------------------------------------------------------------------

def test_micro_calls_letter_for_letter(tmp_path, monkeypatch):
    """run_micro.sh under the recording shims against the runner: every
    CLI call, the corpus generator's keywords and the check heredoc's
    argument; the shell's stage 4 (tools/tpu_parity_check.py) is the
    one call the runner does not make."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_experiments import rooted, runner_calls, shell_calls
    sh, run = tmp_path / "sh", tmp_path / "run"
    want = shell_calls(tmp_path, "micro", [f"{sh}/micro"], {})
    checked = []
    monkeypatch.setattr(experiments, "micro_verdict", lambda d: (
        checked.append(d), {"line": "", "passed": True})[1])
    got = runner_calls(monkeypatch, ["--recipe=micro",
                                     f"--workdir={run}/micro"])
    got += [[["heredoc", d], {}] for d in checked]
    assert want[-2] == [["tools/tpu_parity_check.py"], {}]
    del want[-2]
    assert rooted(got, [run]) == rooted(want, [sh])
    modules = [c[0] for c, _ in want]
    assert modules[0] == "make_synthetic_corpus"
    assert modules.count("rsrgan_tpu.cli.prepare") == 5
    assert modules.count("rsrgan_tpu.cli.train") == 2
    assert modules[-1] == "heredoc"


def test_micro_on_the_cpu(tmp_path, capsys):
    """Stages -1 to 3 through the port's CLIs on the CPU: the flagship
    at B=2 trains up to 2 epochs and decodes the 6 held-out utterances,
    which the recipe's check passes."""
    from rsrgan_tpu_torch.data import ScpReader
    w = str(tmp_path / "micro")
    assert experiments.main(["--recipe=micro", f"--workdir={w}",
                             "--device=cpu"]) == 0
    text = capsys.readouterr().out
    res = json.loads(text.strip().splitlines()[-1])
    assert "MICRO RUN PASSED" in text and "tpu_parity_check" in text
    assert list(res["stage_seconds"]) == ["-1_corpus", "0_prepare",
                                          "1_test_store", "2_train",
                                          "3_decode", "verify"]
    assert res["passed"] and res["check"]["passed"]
    assert 1 <= res["systems_trained"]["gan"]["rows"] <= 2
    mats = dict(iter(ScpReader(f"{w}/exp/gan_res_lstm_l/test/feats.scp")))
    assert len(mats) == 6
    assert all(m.shape[1] == 40 and np.isfinite(m).all()
               for m in mats.values())


def test_micro_verdict_fails_a_wrong_decode(tmp_path):
    from rsrgan_tpu_torch.data import ArkWriter
    d = tmp_path / "test"
    d.mkdir()
    with ArkWriter(str(d / "feats.scp")) as w:
        for i in range(6):
            m = np.zeros((5, 40), np.float32)
            if i == 3:
                m[2, 1] = np.nan
            w.write_next_utt(str(d / "feats.ark"), f"u{i}", m)
    out = experiments.micro_verdict(str(tmp_path))
    assert not out["passed"] and "u3" in out["line"]


# --------------------------------------------------------------------------
# devices and imports
# --------------------------------------------------------------------------

TOOLS = ("io_bench", "kernel_bench", "profile_step", "serve_bench")


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_defaults_to_the_card(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    main = {"io_bench": io_bench, "kernel_bench": kernel_bench,
            "profile_step": profile_step,
            "serve_bench": serve_bench}[tool].main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["1"])


NEW_MODULES = ("rsrgan_tpu_torch.tools.card",
               "rsrgan_tpu_torch.tools.io_bench",
               "rsrgan_tpu_torch.tools.kernel_bench",
               "rsrgan_tpu_torch.tools.profile_step",
               "rsrgan_tpu_torch.tools.serve_bench",
               "rsrgan_tpu_torch.tools.experiments")


@pytest.mark.parametrize("module", NEW_MODULES)
def test_module_imports_neither_jax_nor_the_jax_package(module):
    path = os.path.join(REPO, *module.split(".")) + ".py"
    for node in ast.walk(ast.parse(open(path).read())):
        names = ([a.name for a in node.names]
                 if isinstance(node, ast.Import) else
                 [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        assert not any(n.split(".")[0] in ("jax", "rsrgan_tpu", "flax")
                       for n in names), (module, names)
    code = ("import sys\n"
            "for name in ('jax', 'flax', 'rsrgan_tpu'):\n"
            "    sys.modules[name] = None\n"
            f"import {module}\n"
            "assert not any(n.split('.')[0] in ('jax', 'rsrgan_tpu')\n"
            "               for n in sys.modules if sys.modules[n])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
