"""SEGAN's spans and counters, and the frame loop's step
(``cli.train.frame_train_step``): one ``train.step`` unit an iteration
holding the updates, the backward passes, the optimizer and the model's
parts; every convolution counted by shape with the gradients its
backward computes; the frame feed's spans; the step the CLI and the
benchmark share, equal to the trainers' own steps and counting its two
blocking copies off the CPU."""

import numpy as np
import pytest
import torch

from rsrgan_tpu_torch import spans
from rsrgan_tpu_torch.cli.train import frame_train_step
from rsrgan_tpu_torch.data import FrameBatcher
from rsrgan_tpu_torch.models.segan import (SeganAEGenerator,
                                           SeganDiscriminator)
from rsrgan_tpu_torch.ops.modules import conv_calls
from rsrgan_tpu_torch.training.segan import SeganTrainer

W, U, DEPTHS, B = 64, 8, (4, 8, 8, 16), 8
HP = {"g_lr": 1e-3, "d_lr": 1e-3, "disc_noise_std": 0.0, "l1_lambda": 100.0}


def trainer(seed=3):
    gen = torch.Generator().manual_seed(seed)
    return SeganTrainer(
        SeganAEGenerator(W, U, enc_depths=DEPTHS, bias_deconv=True,
                         generator=gen),
        SeganDiscriminator(W + U, num_fmaps=DEPTHS, generator=gen),
        disc_updates=1, gen_updates=1)


def batch(seed=2):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(B, W, generator=gen), torch.randn(B, U, generator=gen)


@pytest.fixture
def armed():
    spans.clear()
    spans.enable()
    yield
    spans.disable()
    spans.clear()


def test_a_train_step_is_one_unit_of_spans(armed):
    tr = trainer()
    state = tr.init_state(batch(1)[0])
    spans.clear()
    tr.train_step(state, *batch(), HP, torch.Generator().manual_seed(5))
    r = spans.read()
    assert r.units("train.step") == 1 and not r.dropped
    names = [s.name for s in r.spans]
    for name, n in (("train.d_update", 1), ("train.g_update", 1),
                    ("train.backward", 2), ("segan.g_enc", 2),
                    ("segan.g_dec", 2), ("segan.d", 3),
                    ("segan.vbn", 3 * len(DEPTHS)), ("opt.update", 2)):
        assert names.count(name) == n, name
    step = next(s for s in r.spans if s.name == "train.step")
    assert all(s.unit == step.unit for s in r.spans)
    by_id = {s.id: s for s in r.spans}
    for s in r.spans:
        if s.name == "segan.vbn":
            assert by_id[s.parent].name == "segan.d"


def _key(c_in, c_out, k, stride, length, transposed, grad, dx, rows=B):
    return (f"in={c_in},out={c_out},k={k},stride={stride},L={length},"
            f"rows={rows},transposed={transposed},grad={grad},dx={dx}")


def test_an_iteration_counts_each_convolution_by_shape():
    """G (kwidth 20) on 64 positions: encoder 64 -> 32 -> 16 -> 8 -> 4,
    decoder from 4 back (z doubles the deepest code's channels, each skip
    the next layer's input); D (kwidth 31) on 72: 72 -> 36 -> 18 -> 9 ->
    5, then its 1-channel convolution. The D update's G runs without
    gradient (nothing recorded); D's two forwards are recorded with every
    input's gradient but the first (data); the G update's G with every
    input's but its first; its D with every input's (to reach G). The
    key leaves the kernels' gradients to the step (the benchmark's
    ``conv.step_convs``)."""
    tr = trainer()
    state = tr.init_state(batch(1)[0])
    before = dict(conv_calls.launches_by_shape)
    tr.train_step(state, *batch(), HP, torch.Generator().manual_seed(5))
    got = {k: n - before.get(k, 0) for k, n in
           conv_calls.launches_by_shape.items() if n != before.get(k, 0)}
    want = {}

    def add(key, n=1):
        want[key] = want.get(key, 0) + n

    enc = [(1, 4, 64), (4, 8, 32), (8, 8, 16), (8, 16, 8)]
    dec = [(32, 8, 4), (16, 8, 8), (16, 4, 16), (8, 1, 32)]
    for grad in (0, 1):
        for i, (c, o, length) in enumerate(enc):
            add(_key(c, o, 20, 2, length, 0, grad, int(grad and i > 0)))
        for c, o, length in dec:
            add(_key(c, o, 20, 2, length, 1, grad, grad))
    d = [(1, 4, 72), (4, 8, 36), (8, 8, 18), (8, 16, 9)]
    for i, (c, o, length) in enumerate(d):
        add(_key(c, o, 31, 2, length, 0, 1, int(i > 0)), 2)   # D update
        add(_key(c, o, 31, 2, length, 0, 1, 1))               # G update
    add(_key(16, 1, 31, 1, 5, 0, 1, 1), 3)
    assert got == want


class _Store:
    """What ``FrameBatcher`` reads of a store: four utterances."""

    has_labels = True

    def __init__(self):
        rng = np.random.default_rng(0)
        self.x = [rng.standard_normal((n, 5), dtype=np.float32)
                  for n in (6, 9, 7, 8)]
        self.y = [rng.standard_normal((len(a), 3), dtype=np.float32)
                  for a in self.x]

    def __len__(self):
        return len(self.x)

    def inputs(self, i):
        return self.x[i]

    def labels(self, i):
        return self.y[i]


def test_the_frame_feed_has_its_spans(armed):
    spans.clear()
    b = FrameBatcher(_Store(), 4, 1, 1, seed=3)
    assert [s.name for s in spans.read().spans] == ["feed.frames"]
    x, y = next(iter(b))
    assert x.shape == (4, 15) and y.shape == (4, 3)
    assert [s.name for s in spans.read().spans] == ["feed.frames"] * 2


class _Recorder:
    """A trainer that is none of the three: the MSE call's shape."""

    def train_step(self, state, x, y, masks, lr):
        return {"x": x, "y": y, "masks": masks, "lr": lr}


def test_frame_train_step_counts_two_blocking_copies_off_the_cpu(armed):
    x = np.ones((2, 3), np.float32)
    y = np.zeros((2, 1), np.float32)
    spans.clear()
    got = frame_train_step(_Recorder(), None, x, y, torch.device("meta"),
                           {}, None, 0.5)
    assert got["x"].device.type == "meta" and got["lr"] == 0.5
    r = spans.read()
    assert r.total("host_wait") == 2
    assert [s.name for s in r.spans] == ["feed.to_device"]
    spans.clear()
    frame_train_step(_Recorder(), None, x, y, torch.device("cpu"), {}, None,
                     0.5)
    assert spans.read().total("host_wait") == 0


def test_frame_train_step_is_the_trainers_step():
    """SEGAN through ``frame_train_step`` and through its own
    ``train_step`` from the same state: the same losses and parameters,
    bit for bit."""
    x, y = batch()
    out = []
    for shared in (True, False):
        tr = trainer()
        state = tr.init_state(batch(1)[0])
        rand = torch.Generator().manual_seed(5)
        if shared:
            m = frame_train_step(tr, state, x.numpy(), y.numpy(),
                                 torch.device("cpu"), HP, rand, 0.0)
        else:
            m = tr.train_step(state, x, y, HP, rand)
        out.append((m, {k: p.detach().clone() for k, p in
                        tr.generator.named_parameters()}))
    (m1, p1), (m2, p2) = out
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
