"""The trace's reduction and the per-layer readers on a synthetic
trace."""

import pytest

from benchmark import harness, trace

K2 = ("void (anonymous namespace)::lstm_bwd_resident_kernel<"
      "__nv_bfloat16, false>((anonymous namespace)::BwdParams)")
K3 = ("void (anonymous namespace)::lstm_bwd_resident_kernel<"
      "__nv_bfloat16, true>((anonymous namespace)::BwdParams)")
GEMM = "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8"

# µs: a 1000 µs window; the device busy 100-300 (K2), 250-400 (a gemm,
# overlapping), 700-800 (K3); spans: a step 0-600, a plan 600-900
EVENTS = [("span", "bench.window", 0.0, 1000.0),
          ("span", "bench.train_step_gathered", 0.0, 600.0),
          ("span", "bench.plan", 600.0, 300.0),
          ("kernel", K2, 100.0, 200.0),
          ("kernel", GEMM, 250.0, 150.0),
          ("kernel", K3, 700.0, 100.0),
          ("memcpy", "Memcpy HtoD (Pageable -> Device)", 1200.0, 50.0),
          ("runtime", "cudaLaunchKernel", 90.0, 5.0),
          ("runtime", "cudaLaunchCooperativeKernel", 95.0, 5.0),
          ("runtime", "cudaMemcpyAsync", 600.0, 5.0),
          ("runtime", "cudaLaunchKernel", 2000.0, 5.0)]


def test_analyse_window_busy_gaps():
    t = trace.analyse(EVENTS)
    assert t["window_s"] == pytest.approx(1e-3)
    assert t["busy_s"] == pytest.approx(400e-6)      # 100-400, 700-800
    assert t["launches"] == 2                         # in the window
    assert t["device_s_by_name"][K2] == pytest.approx(200e-6)
    assert "Memcpy HtoD (Pageable -> Device)" not in t["device_s_by_name"]
    # idle: 0-100 (step), 400-700 (its middle 550: the step), 800-1000
    # (the plan)
    assert t["gaps"] == [["bench.train_step_gathered", pytest.approx(3e-4)],
                         ["bench.plan", pytest.approx(2e-4)],
                         ["bench.train_step_gathered", pytest.approx(1e-4)]]
    b = trace.breakdown(t)
    assert b["device_ops"][0] == [K2, pytest.approx(200e-6)]
    assert len(b["idle_gaps"]) == 3


def test_analyse_needs_one_window():
    with pytest.raises(ValueError):
        trace.analyse(EVENTS[1:])


def test_hand_kernels_and_patterns():
    assert trace.is_hand_kernel(K2) and not trace.is_hand_kernel(GEMM)
    t = trace.analyse(EVENTS)
    k2 = harness.metric_reader("roofline.k2.train")
    # the untraced window: 2 iterations, 100 frames in 1 ms; the traced
    # one ran the same 2, which the untraced window took 1 ms for
    run = {"kind": "train", "trace": t, "dtype_name": "bfloat16",
           "iterations": 2, "frames": 100, "window_s": 1e-3,
           "flops_per_frame": 1e9,
           "traced": {"iterations": 2, "paced_s": 1e-3, "per_iter": [
               {"t_pad": 200, "lengths": [150, 200],
                "launches": {"k2": {"U=760,P=257,B=2": 4}, "k3": {}}}]}}
    from benchmark.roofline import bwd_bound
    want = 4 * bwd_bound(760, 257, 2, 200, [150, 200], "bfloat16",
                         acc=False)["bound_ms"] / 1e3 / 200e-6 * 100
    assert k2(run) == pytest.approx(want)
    assert harness.metric_reader("roofline.k3.train")(run) is None
    assert harness.metric_reader("idle_share.train")(run) == \
        pytest.approx(60.0)
    assert harness.metric_reader("launches_per_iter.train")(run) == 1.0
    assert harness.metric_reader("library_ms_per_iter.train")(run) == \
        pytest.approx(150e-6 * 1e3 / 2)
    assert harness.metric_reader("mfu.train")(run) == pytest.approx(
        100 * 1e11 / (1e-3 * 989e12))
    assert harness.metric_reader("mfu.decode")(run) is None


def test_idle_share_reads_the_untraced_pace():
    """The profiler stretched the traced window (1 ms) to twice the time
    the untraced window took for the same iterations (0.5 ms): the
    device's 0.4 ms busy leave 20% idle, not the traced window's 60%;
    the MFU is of the untraced window."""
    t = trace.analyse(EVENTS)
    run = {"kind": "train", "trace": t, "iterations": 4, "frames": 200,
           "window_s": 1e-3, "flops_per_frame": 1e9,
           "traced": {"iterations": 2, "paced_s": 0.5e-3, "per_iter": []}}
    assert harness.metric_reader("idle_share.train")(run) == \
        pytest.approx(20.0)
    assert harness.metric_reader("mfu.train")(run) == pytest.approx(
        100 * 2e11 / (1e-3 * 989e12))
    dec = {"kind": "decode", "trace": t, "passes": 2, "frames": 300,
           "window_s": 2e-3, "flops_per_frame": 1e9,
           "traced": {"passes": 1, "paced_s": 0.8e-3}}
    assert harness.metric_reader("idle_share.decode")(dec) == \
        pytest.approx(50.0)
    assert harness.metric_reader("mfu.decode")(dec) == pytest.approx(
        100 * 3e11 / (2e-3 * 989e12))


def test_a_traced_run_reads_its_window():
    """A traced run on the CPU: the profiler's trace read back, the window
    found, the per-layer metrics that have something to read reported."""
    import torch
    from bench_tiny import tiny_cell

    from benchmark import run
    rc, line, _ = run.execute(harness.manifest(),
                              tiny_cell("mse_b16", f32=True), 3, 0.3, True,
                              torch.device("cpu"), 0.0)
    assert rc == 0 and line["correct"]
    assert line["device"]["window_s"] > 0.2
    assert "launches_per_iter.train" in line["metrics"]
    assert "idle_share.train" in line["metrics"]
    assert line["breakdown"]["idle_gaps"][0][0].startswith("bench.")


def test_host_share_from_two_readings():
    a = {"t": 0.0, "process_s": 1.0, "main_s": 0.5,
         "threads": {"python/1": 0, "omp/2": 0}}
    tick = __import__("os").sysconf("SC_CLK_TCK")
    b = {"t": 2.0, "process_s": 5.0, "main_s": 2.0,
         "threads": {"python/1": 3 * tick, "omp/2": tick,
                     "new/3": 2 * tick}}
    h = harness.host_share(a, b, 10)
    assert h["main_cpu_pct"] == pytest.approx(75.0)
    assert h["main_cpu_ms_per_unit"] == pytest.approx(150.0)
    assert h["process_cores"] == pytest.approx(2.0)
    assert h["top_threads"] == "python/1=3.00s new/3=2.00s omp/2=1.00s"
    now = harness.host_counters()
    assert now["t"] > 0 and set(now) == set(a)
    assert any(k.endswith(f"/{__import__('os').getpid()}")
               for k in now["threads"])
    assert harness.host_probe_ms(1000) > 0
