"""A whole run with the timed path broken underneath (the program, not
the harness) comes out not ``correct``, once for each fault that a cell
can have; a sound run comes out ``correct``. The look for a card is
skipped (``run.execute`` on the CPU); the cells are cut to a tiny size
and run in f32, the limits are the committed ones. One card: no exchange
between chips to leave out."""

import pytest
import torch
from bench_tiny import tiny_cell

from benchmark import harness, run

MAN = harness.manifest()


def execute(name: str, seed: int = 2 ** 31 + 11):
    rc, line, _ = run.execute(MAN, tiny_cell(name, f32=True), seed, 0.3,
                              False, torch.device("cpu"), 0.0)
    assert rc == 0
    return line


def unchanged_state(monkeypatch):
    """Every update returns the state as it was."""
    from rsrgan_tpu_torch.training.state import NetState
    monkeypatch.setattr(NetState, "apply_gradients",
                        lambda self, grads, lr, ema_decay: None)


def half_batch_train(monkeypatch):
    """Each step sees the first half of its rows: the mean over them."""
    from rsrgan_tpu_torch.training.gan import GanTrainer
    from rsrgan_tpu_torch.training.mse import MseTrainer
    for cls in (GanTrainer, MseTrainer):
        orig = cls.train_step_gathered

        def half(self, state, it, lt, starts, lengths, *rest, _orig=orig):
            h = max(1, len(starts) // 2)
            return _orig(self, state, it, lt, starts[:h], lengths[:h],
                         *rest)
        monkeypatch.setattr(cls, "train_step_gathered", half)


def _patch_g(monkeypatch, change):
    from rsrgan_tpu_torch.models.recurrent import ResLstmGenerator
    orig = ResLstmGenerator.forward

    def forward(self, *args, **kwargs):
        return change(orig(self, *args, **kwargs))
    monkeypatch.setattr(ResLstmGenerator, "forward", forward)


def altered_answer(monkeypatch):
    """The first row of every decoded batch is off by 0.5."""
    def change(out):
        out = out.clone()
        out[0] += 0.5
        return out
    _patch_g(monkeypatch, change)


def half_batch_decode(monkeypatch):
    """The second half of every decoded batch is left out (zeros)."""
    def change(out):
        out = out.clone()
        out[(out.shape[0] + 1) // 2:] = 0.0
        return out
    _patch_g(monkeypatch, change)


def swapped_cmvn(monkeypatch):
    """The outputs are denormalised with the means and deviations
    swapped."""
    from rsrgan_tpu_torch.data.cmvn import Cmvn
    monkeypatch.setattr(Cmvn, "denormalize",
                        lambda self, feats: feats * self.mean + self.stddev)


@pytest.mark.parametrize("name", ["gan_b8", "mse_b16", "decode_b8"])
def test_a_sound_run_is_correct(name):
    line = execute(name)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0


@pytest.mark.parametrize("name,fault", [
    ("gan_b8", unchanged_state), ("gan_b8", half_batch_train),
    ("gan_b32", unchanged_state), ("gan_b32", half_batch_train),
    ("mse_b16", unchanged_state), ("mse_b16", half_batch_train),
    ("decode_b8", altered_answer), ("decode_b8", half_batch_decode),
    ("decode_b8", swapped_cmvn)])
def test_a_fault_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    line = execute(name)
    assert not line["correct"], line["checks"]
