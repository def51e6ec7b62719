"""The manifest and the cell files found by name: every cell, metric,
configuration, traffic mix and driver of BENCHMARK.json resolves, and
the manifest keeps to the contract's shapes."""

import re

import pytest

from benchmark import harness
from benchmark.roofline import PEAK_FLOPS

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = harness.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


def test_manifest_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    names += CELLS + [c["name"] for c in MAN["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_resolve(name):
    cell = harness.cell(name, MAN)
    assert cell.entry["chips"] == 1
    driver = harness.driver(cell.workload["driver"])
    assert callable(driver.run) and callable(driver.Session)
    assert set(cell.workload["limits"])
    assert harness.reference(cell.config["reference"]).g_shapes
    assert callable(harness.generator(cell.mix).lengths)
    e2e = [m["name"] for m in harness.metrics_for(MAN, name, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = harness.metrics_for(MAN, name, True)
    assert per_layer
    moved = {m["moves"] for m in per_layer}
    assert moved <= set(e2e)
    for m in harness.metrics_for(MAN, name, False) + per_layer:
        assert callable(harness.metric_reader(m["name"]))


PROTOCOL = ("warm", "window", "free", "reference", "faults", "numbers",
            "detail")


@pytest.mark.parametrize("driver", sorted(
    {harness.cell(n, MAN).workload["driver"] for n in CELLS}))
def test_drivers_share_one_protocol(driver):
    """``run`` and ``calibrate`` drive every cell's Session alike."""
    session = harness.driver(driver).Session
    assert all(callable(getattr(session, m, None)) for m in PROTOCOL)


def test_a_mix_names_its_generator():
    mod = harness.generator({"generator": "corpus"})
    assert mod.__name__ == "benchmark.traffic.corpus"
    with pytest.raises(ModuleNotFoundError):
        harness.generator({"generator": "no_such_generator"})


@pytest.mark.parametrize("name", [c["name"] for c in MAN["configs"]])
def test_config_flags_state_the_hyper_parameters(name):
    """The CLI flags the program is built from say what the reference
    is told."""
    from rsrgan_tpu_torch.cli.train import parse_args
    entry = next(c for c in MAN["configs"] if c["name"] == name)
    cfg = harness.read_json(f"{harness.ROOT}/{entry['file']}")
    assert cfg["reduced"] == entry["reduced"] == []
    args, unknown = parse_args(cfg["cli"])
    assert not unknown
    g, hp = cfg["generator"], cfg["hparams"]
    assert (args.input_dim, args.output_dim) == (g["input_dim"],
                                                 g["output_dim"])
    assert g["num_proj"] == g["input_dim"]   # res_lstm_l's residual
    assert args.g_type == g["type"] and args.keep_prob == 1.0
    assert args.bf16 == (cfg["precision"] == "bfloat16")
    assert cfg["precision"] in PEAK_FLOPS
    assert args.g_learning_rate == hp["g_lr"]
    assert args.l2_scale == hp["l2_scale"]
    if hp["trainer"] == "gan":
        d = cfg["discriminator"]
        assert args.trainer == "gan_rnn"
        assert args.d_learning_rate == hp["d_lr"]
        assert (args.disc_updates, args.gen_updates) == (
            hp["disc_updates"], hp["gen_updates"])
        assert args.init_mse_weight == hp["mse_weight"]
        assert args.init_disc_noise_std == d["noise_std"]
        assert d["input_dim"] == g["output_dim"]
    else:
        assert args.trainer == "rnn"


def test_metrics_for_follows_workloads_lists():
    assert [m["name"] for m in harness.metrics_for(MAN, "mse_b16", True)
            if m["name"].startswith("roofline")] == ["roofline.k2.train"]
    assert "decode_frames_per_s" not in [
        m["name"] for m in harness.metrics_for(MAN, "gan_b8", False)]


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        harness.cell("no_such_cell", MAN)
