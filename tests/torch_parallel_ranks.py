"""What each rank of a spawned gloo world runs for
tests/test_torch_parallel.py and tests/test_torch_cli_parallel.py (the
port and torch only, so a rank starts quickly): the port's trainers at
the tests' narrow widths, one data-parallel train step from a given state
on this rank's rows, and the collectives against their one-process
meaning. Each rank writes what it found to ``out_dir/rank{r}.pkl``."""

import os
import pickle

import numpy as np
import torch

from rsrgan_tpu_torch.models.discriminators import LstmDiscriminator
from rsrgan_tpu_torch.models.feedforward import DnnGenerator
from rsrgan_tpu_torch.models.recurrent import (BnLstmGenerator,
                                               ResLstmGenerator)
from rsrgan_tpu_torch.models.segan import (SeganAEGenerator,
                                           SeganDiscriminator)
from rsrgan_tpu_torch.parallel import (all_reduce_mean, current_world,
                                       gather_rows, global_moments,
                                       initialize, local_draws, make_world,
                                       replicate, shard_batch, shutdown)
from rsrgan_tpu_torch.training import (GanTrainer, MseTrainer, SeganTrainer,
                                       checkpoints)

IN, OUT, T = 9, 4, 9
GU, DU = 13, 10                 # res_lstm_l G: 4 x LSTM(13, proj 9); D
SPLICE = 5                      # the DNN's spliced frames
BN_U, BN_P, BN_LAYERS = 12, 5, 2
SEGAN_W_IN, SEGAN_W_OUT, SEGAN_ENC = 32, 8, (4, 8)


def port_trainer(kind: str, impl: str = "wavefront", keep_prob: float = 1.0,
                 seed: int = 0):
    """The port's trainer of a step case, weights drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    if kind == "gan":
        g = ResLstmGenerator(IN, OUT, variant="l", cell_size=GU,
                             lstm_impl=impl, keep_prob=keep_prob,
                             generator=gen)
        d = LstmDiscriminator(input_dim=OUT, cell_size=DU,
                              num_projection=OUT, lstm_impl=impl,
                              keep_prob=keep_prob, generator=gen)
        tr = GanTrainer(g, d, output_dim=OUT, input_dim=IN, l2_scale=1e-3)
        tr.seed_dropout(seed + 2, "cpu")
        return tr
    if kind == "mse":
        g = ResLstmGenerator(IN, OUT, variant="l", cell_size=GU,
                             lstm_impl=impl, generator=gen)
        return MseTrainer(g, output_dim=OUT, l2_scale=1e-3,
                          max_grad_norm=15.0)
    if kind == "dnn_bn":
        g = DnnGenerator(IN * SPLICE, OUT, units=8, hidden_layers=2,
                         batch_norm=True, generator=gen)
        return MseTrainer(g, output_dim=OUT, l2_scale=1e-3,
                          max_grad_norm=None, sequence_mode=False)
    if kind == "bnlstm":
        g = BnLstmGenerator(IN, OUT, cell_size=BN_U, num_projection=BN_P,
                            num_layers=BN_LAYERS, generator=gen)
        return MseTrainer(g, output_dim=OUT, l2_scale=1e-3,
                          max_grad_norm=15.0)
    if kind == "segan":
        kw = dict(enc_depths=SEGAN_ENC, kwidth=5, bias_deconv=True)
        return SeganTrainer(
            SeganAEGenerator(SEGAN_W_IN, SEGAN_W_OUT, generator=gen, **kw),
            SeganDiscriminator(SEGAN_W_IN + SEGAN_W_OUT,
                               num_fmaps=SEGAN_ENC, kwidth=5,
                               generator=gen),
            disc_updates=1, gen_updates=1)
    raise ValueError(kind)


def init_state(tr, kind: str):
    """The trainer's initial state (SEGAN's from a zero example)."""
    if kind == "segan":
        return tr.init_state(torch.zeros(2, SEGAN_W_IN))
    return tr.init_state()


class RecordedRows:
    """Normals recorded at the global batch, handed out in order, each
    cut to this rank's rows (SEGAN's z and D noise in a test)."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, shape):
        world = current_world()
        full = self.draws.pop(0)
        return torch.from_numpy(full.reshape(
            (world.world, -1) + full.shape[1:])[world.rank]).reshape(shape)


def run_step(case: dict, tr, st):
    """One train step of ``case`` on this rank's rows; (metrics, the
    gradients of the first update)."""
    kind = case["kind"]
    world = current_world()
    arrays = tuple(None if a is None else torch.from_numpy(np.asarray(a))
                   for a in case["batch"])
    x, y, lens = (None if a is None else shard_batch(world, a)
                  for a in arrays)
    tr.grad_log = []
    if kind == "gan":
        noise = case.get("noise_seed")
        noise = (None if noise is None
                 else torch.Generator().manual_seed(noise))
        m = tr.train_step(st, x, y, lens, case["hp"], noise)
    elif kind == "segan":
        m = tr.train_step(st, x, y, case["hp"], RecordedRows(case["draws"]))
    else:
        m = tr.train_step(st, x, y, lens, case["lr"])
    first = tr.grad_log[0]
    grads = first[1] if isinstance(first, tuple) else first
    return ({k: float(v) for k, v in m.items()},
            {k: g.numpy() for k, g in grads.items()})


def step_rank(rank: int, world: int, address: str, case_path: str,
              out_dir: str) -> int:
    """One data-parallel step of the pickled case: the bridged state
    (replicated from rank 0), this rank's rows; writes the metrics, the
    first update's gradients and the state after the step."""
    torch.set_num_threads(1)
    initialize(address, world, rank)
    try:
        make_world(torch.device("cpu"))
        with open(case_path, "rb") as f:
            case = pickle.load(f)
        kind = case["kind"]
        tr = port_trainer(kind, keep_prob=case.get("keep_prob", 1.0))
        st = init_state(tr, kind)
        if case.get("state") is not None:
            checkpoints.load_state_tree(st, case["state"])
        nets = (st.g, st.d) if hasattr(st, "g") else (st.net,)
        for net in nets:
            replicate(current_world(), net.tensors())
        metrics, grads = run_step(case, tr, st)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump({"metrics": metrics, "grads": grads,
                         "state": checkpoints.state_tree(st)}, f)
        return 0
    finally:
        shutdown()


def collectives_rank(rank: int, world: int, address: str,
                     out_dir: str) -> int:
    """The collectives on this rank's part of seeded data: the means,
    moments (and their gradients), gathered rows, replicated tensors and
    draws, for the test to hold against the one-process results."""
    torch.set_num_threads(1)
    initialize(address, world, rank)
    try:
        w = make_world(torch.device("cpu"))
        rng = np.random.default_rng(0)
        x_all = torch.from_numpy(rng.normal(size=(4 * world, 3, 5))
                                 .astype(np.float32))
        x = shard_batch(w, x_all).clone().requires_grad_(True)
        out = {}
        mean, mean_sq = global_moments(x, (0, 1))
        c_mean, c_var = global_moments(x, (0,), centred=True)
        loss = (mean * torch.arange(5.0)).sum() + mean_sq.sum() \
            + (c_var * c_mean).sum()
        (grad,) = torch.autograd.grad(loss, x)
        out["moments"] = [t.detach().numpy() for t in
                          (mean, mean_sq, c_mean, c_var)]
        out["grad"] = gather_rows(w, grad).numpy()
        out["mean"] = all_reduce_mean(w, {
            "a": torch.full((2, 2), float(rank)),
            "b": torch.tensor(rank, dtype=torch.int32) * 2})
        state = [torch.full((3,), float(rank) + 1.0)]
        replicate(w, state)
        out["replicated"] = state[0].numpy()
        draws = local_draws(torch.Generator().manual_seed(9), parts=2)
        out["rand"] = draws.rand((2 * 3, 2)).numpy()
        out["randn"] = draws.randn((2 * 3, 2)).numpy()
        out["collectives"] = w.collectives
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        return 0
    finally:
        shutdown()


def failing_rank(rank: int, world: int, address: str) -> int:
    """Rank 1 fails at once; the others wait in a collective for it."""
    initialize(address, world, rank)
    w = make_world(torch.device("cpu"))
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    w.all_reduce_sum_(torch.zeros(1))
    return 0


def sleeping_rank(rank: int, world: int, address: str) -> int:
    """A rank that outlives any test's time limit."""
    import time
    time.sleep(600)
    return 0
