"""The four-card flagship's driver (``train_gathered_dp``) on the CPU:
four gloo ranks, 2 rows each, the rates x 4. A sound run is ``correct``
with the replicas equal and three all-reduces an iteration; a fault in
rank 0's update or batch (this process is rank 0) is not."""

import pytest
import torch
from bench_tiny_cells import tiny_dp_cell

from benchmark import harness, run
from benchmark.drivers.train_gathered_dp import scaled_cell

MAN = harness.manifest()


def execute(trace=False, seed=2 ** 31 + 13):
    rc, line, _ = run.execute(MAN, tiny_dp_cell(), seed, 0.3, trace,
                              torch.device("cpu"), 0.0)
    assert rc == 0
    return line


def test_a_rank_sees_the_global_batch_and_the_scaled_rates():
    cell = harness.cell("gan_b8x4", MAN)
    s = scaled_cell(cell, 4)
    assert s.mix["batch_size"] == 32 == 4 * cell.mix["batch_size"]
    hp, hp0 = s.config["hparams"], cell.config["hparams"]
    assert (hp["g_lr"], hp["d_lr"]) == (hp0["g_lr"] * 4, hp0["d_lr"] * 4)
    from rsrgan_tpu_torch.cli.train import make_hparams, parse_args
    args = parse_args(s.config["cli"])[0]
    want = make_hparams(parse_args(cell.config["cli"])[0], 4)
    assert make_hparams(args, 1)["g_lr"] == want["g_lr"] == hp["g_lr"]
    assert make_hparams(args, 1)["d_lr"] == want["d_lr"] == hp["d_lr"]


def test_a_sound_run_is_correct_and_counts_its_all_reduces():
    line = execute(trace=True)
    assert line["correct"], line["checks"]
    assert line["checks"]["replica_gap"]["value"] == 0.0
    assert line["device"]["count"] == 4
    comm = dict(line["breakdown"]["comm"])
    assert comm["all_reduce_per_iter"] == 3.0   # 1 D and 2 G updates
    assert comm["bytes_per_iter"] > 0
    for name in ("host_ms_per_iter.feed.train", "host_ms_per_iter.glue.train",
                 "host_ms_per_iter.optimizer.train", "idle_share.train"):
        assert name in line["metrics"], name
    from rsrgan_tpu_torch.parallel import current_world
    assert current_world().world == 1   # the world is left


def _unchanged_state(monkeypatch):
    from rsrgan_tpu_torch.training.state import NetState
    monkeypatch.setattr(NetState, "apply_gradients",
                        lambda self, grads, lr, ema_decay: None)


def _half_batch(monkeypatch):
    from rsrgan_tpu_torch.training.gan import GanTrainer
    orig = GanTrainer.train_step_gathered

    def half(self, state, it, lt, starts, lengths, *rest):
        h = max(1, len(starts) // 2)
        return orig(self, state, it, lt, starts[:h], lengths[:h], *rest)
    monkeypatch.setattr(GanTrainer, "train_step_gathered", half)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch])
def test_a_fault_on_rank_0_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    line = execute()
    assert not line["correct"], line["checks"]
