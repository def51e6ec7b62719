"""The traffic and the weights are deterministic from ``--seed``; every
seed trains on the same batch shapes in the same order."""

import numpy as np
import torch

from benchmark import harness, weights
from benchmark.reference import res_lstm
from benchmark.traffic import corpus

MIX = dict(harness.cell("gan_b8").mix, utterances=500)


def test_lengths_are_the_mix_s():
    a = corpus.lengths(MIX)
    assert np.array_equal(a, corpus.lengths(MIX)) and len(a) == 500
    assert not np.array_equal(a, corpus.lengths(dict(MIX, lengths_seed=1)))
    assert a.min() >= MIX["min_frames"] and a.max() <= MIX["max_frames"]


def test_every_seed_trains_on_the_same_batch_shapes():
    """The plans come from the mix alone; only the values follow the
    seed."""
    from bench_tiny import tiny_cell, tiny_ctx

    from benchmark.drivers.train_gathered import Session

    def shapes(seed):
        s = Session(tiny_ctx(tiny_cell("mse_b16", f32=True), seed=seed))
        return ([(len(ix), t) for ix, t in s.queue],
                [b[2].tolist() for b in s.batches], s.batches[0][0])

    (q1, l1, x1), (q2, l2, x2) = shapes(2 ** 31 + 1), shapes(17)
    assert q1 == q2 and l1 == l2
    assert not torch.equal(x1, x2)


def test_tables_deterministic_with_a_zero_row():
    lens = corpus.lengths(MIX)[:40]
    x1, y1 = corpus.tables(lens, (6, 3), 11, "cpu")
    x2, y2 = corpus.tables(lens, (6, 3), 11, "cpu")
    x3, _ = corpus.tables(lens, (6, 3), 12, "cpu")
    assert x1.shape == (int(lens.sum()) + 1, 6) and y1.shape[1] == 3
    assert torch.equal(x1, x2) and torch.equal(y1, y2)
    assert not torch.equal(x1, x3)
    assert not x1[-1].any() and not y1[-1].any()


def test_rows_are_the_utterances():
    lens = np.array([3, 5, 2], np.int32)
    (x,) = corpus.tables(lens, (4,), 1, "cpu")
    first = corpus.starts(lens)
    assert first.tolist() == [0, 3, 8]
    r = corpus.rows(x, first[[2, 0]], lens[[2, 0]], 6)
    assert torch.equal(r[0, :2], x[8:10]) and not r[0, 2:].any()
    assert torch.equal(r[1, :3], x[0:3])


def test_weights_deterministic_biases_zero():
    g = harness.cell("gan_b8").config["generator"]
    shapes = res_lstm.g_shapes(dict(g, input_dim=8, num_proj=8,
                                    cell_size=16, output_dim=4))
    a = weights.make(shapes, 9, 2, "cpu")
    b = weights.make(shapes, 9, 2, "cpu")
    c = weights.make(shapes, 9, 3, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["lstm_cell_1.kernel"], c["lstm_cell_1.kernel"])
    assert {tuple(v.shape) for v in a.values()} >= {(16, 64), (64,)}
    assert not a["lstm_cell_2.bias"].any()
    assert abs(float(a["lstm_cell_1.kernel"].std()) - weights.SCALE) < 0.01
