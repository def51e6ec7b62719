"""What each rank of a spawned gloo world runs for
tests/test_torch_tensor_parallel.py (the port and torch only, so a rank
starts quickly): a (data, model) world (``make_world(...,
model_parallel=m)``), a state placed by ``shard_state``, one train step on
this rank's rows, the whole state tree after it (``state_tree`` gathers
the sharded leaves, a collective of every rank), and what each rank kept.
Each rank writes what it found to ``out_dir/rank{r}.pkl``; rank 0 also
writes the checkpoint under ``out_dir/ckpt``."""

import hashlib
import os
import pickle

import numpy as np
import torch
from torch import nn

import torch_parallel_ranks as ranks
from rsrgan_tpu_torch.models import flatten_tree, get_generator
from rsrgan_tpu_torch.models.discriminators import LstmDiscriminator
from rsrgan_tpu_torch.models.recurrent import ResLstmGenerator
from rsrgan_tpu_torch.parallel import (current_world, initialize,
                                       make_world, model_block, replicate,
                                       shard_batch, shard_state, shutdown)
from rsrgan_tpu_torch.training import (GanTrainer, MseTrainer, NetState,
                                       checkpoints)

# tests/test_parallel.py's tiny dims
TINY_IN, TINY_OUT, TINY_U, TINY_DU, TINY_DP = 8, 4, 8, 8, 4


def trainer(model: str):
    """The port's trainer of a case; the weights come from the state the
    case hands in (or from seed 0)."""
    gen = torch.Generator().manual_seed(0)
    if model == "flagship":
        g = ResLstmGenerator(257, 40, variant="l", cell_size=760,
                             generator=gen)
        d = LstmDiscriminator(input_dim=40, cell_size=256, num_projection=40,
                              lstm_impl="wavefront", generator=gen)
        return GanTrainer(g, d, output_dim=40, input_dim=257)
    if model == "tiny":
        g = ResLstmGenerator(TINY_IN, TINY_OUT, variant="l",
                             cell_size=TINY_U, generator=gen)
        d = LstmDiscriminator(input_dim=TINY_OUT, cell_size=TINY_DU,
                              num_projection=TINY_DP, lstm_impl="wavefront",
                              generator=gen)
        return GanTrainer(g, d, output_dim=TINY_OUT, input_dim=TINY_IN)
    if model == "lstm":      # --trainer=rnn --g_type=lstm at full width
        g = get_generator("lstm", input_dim=257, output_dim=40,
                          generator=gen)
        return MseTrainer(g, output_dim=40, l2_scale=1e-5,
                          max_grad_norm=15.0)
    return ranks.port_trainer(model)   # bnlstm, dnn_bn, segan


def nets(st):
    return {k: getattr(st, k) for k in ("g", "d", "net") if hasattr(st, k)}


def kept(st) -> dict:
    """{net: {leaf: [EMA, mu, nu] as numpy}} of every sharded leaf, as
    this rank holds them (RMSProp: no mu; SGD: neither)."""
    out = {}
    for name, ns in nets(st).items():
        trees = [ns.ema] + [ns.opt_state[f] for f in ("mu", "nu")
                            if f in ns.opt_state]
        out[name] = {k: [t[k].numpy().copy() for t in trees]
                     for k in ns.shards}
    return out


def blocks_of(tree: dict, st, world) -> dict:
    """``kept``'s layout cut from a whole state tree: this rank's model
    block of each sharded leaf's EMA and moments."""
    out = {}
    for name, ns in nets(st).items():
        node = tree[name]
        core = node["opt_state"]["1"]
        trees = [flatten_tree(node["ema"])] + [
            flatten_tree(core[f]) for f in ("mu", "nu") if f in core]
        out[name] = {k: [model_block(world, torch.from_numpy(
            np.asarray(t[k])), axis).numpy() for t in trees]
            for k, axis in ns.shards.items()}
    return out


def digest(tree: dict) -> str:
    """The sha256 of a state tree's checkpoint bytes."""
    return hashlib.sha256(checkpoints.msgpack_serialize(tree)).hexdigest()


def same_blocks(a: dict, b: dict) -> bool:
    return (a.keys() == b.keys() and all(
        a[n].keys() == b[n].keys() and all(
            all(np.array_equal(x, y) for x, y in zip(a[n][k], b[n][k]))
            for k in a[n]) for n in a))


def step(case: dict, tr, st):
    """One train step of ``case`` on this rank's rows: (metrics, the
    first update's gradients as numpy)."""
    if case["kind"] == "segan":
        world = current_world()
        x, y = (shard_batch(world, torch.from_numpy(a))
                for a in case["batch"][:2])
        tr.grad_log = []
        m = tr.train_step(st, x, y, case["hp"],
                          torch.Generator().manual_seed(case["seed"]))
        return ({k: float(v) for k, v in m.items()},
                {k: g.numpy() for k, g in tr.grad_log[0][1].items()})
    return ranks.run_step(case, tr, st)


def tp_rank(rank: int, world: int, address: str, model_parallel: int,
            case_path: str, out_dir: str) -> int:
    """The case's step in a world of ``world // model_parallel`` data x
    ``model_parallel`` model ranks, from its state, placed by
    ``shard_state(..., tensor_parallel=True)``: G's eval output on this
    rank's rows before the step (with ``infer``); the metrics, the first
    update's gradients and the collectives of the step; the element count
    of each sharded leaf's EMA and moments against the whole leaf's; the
    whole tree after the step (rank 0 saves it as a checkpoint, every
    rank its digest); whether what each rank kept is its block of that
    tree, and is again once the tree is restored into the sharded state
    (``kept``: the restored blocks themselves, with ``keep_arrays``)."""
    torch.set_num_threads(1)
    initialize(address, world, rank)
    try:
        w = make_world(torch.device("cpu"), model_parallel)
        with open(case_path, "rb") as f:
            case = pickle.load(f)
        tr = trainer(case["model"])
        st = ranks.init_state(tr, case["kind"])
        if case.get("state") is not None:
            checkpoints.load_state_tree(st, case["state"])
        shard_state(w, st, tensor_parallel=True)
        out = {"shards": {k: dict(ns.shards) for k, ns in nets(st).items()},
               "groups": (w.data_group is None, w.model_group is None),
               "layout": (w.data_rank, w.data_size, w.model_rank, w.model)}
        if case.get("infer"):
            x, _, lens = case["batch"]
            xl, ll = (shard_batch(w, torch.from_numpy(a)) for a in (x, lens))
            with torch.no_grad():
                out["infer"] = tr.generator(xl, ll, False).numpy()
        before = w.collectives
        out["metrics"], out["grads"] = step(case, tr, st)
        out["step_collectives"] = w.collectives - before
        out["numel"] = {n: {k: ([b.size for b in v],
                                int(nets(st)[n].module.get_parameter(k)
                                    .numel()))
                            for k, v in leaves.items()}
                        for n, leaves in kept(st).items()}
        tree = checkpoints.state_tree(st)
        out["digest"] = digest(tree)
        if rank == 0:
            checkpoints.save_checkpoint(os.path.join(out_dir, "ckpt"), "TP",
                                        tree, 1)
        want = blocks_of(tree, st, w)
        out["kept_is_block"] = same_blocks(kept(st), want)
        checkpoints.load_state_tree(st, tree)
        out["restored_is_block"] = same_blocks(kept(st), want)
        if case.get("keep_arrays"):
            out["kept"] = kept(st)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        return 0
    finally:
        shutdown()


class CellNet(nn.Module):
    """One parameter in an LSTM cell's place: ``cell.kernel`` [2, 8]."""

    def __init__(self):
        super().__init__()
        self.cell = nn.Module()
        self.cell.kernel = nn.Parameter(torch.zeros(2, 8))


def clip_update(grad: np.ndarray, world=None) -> np.ndarray:
    """``cell.kernel`` after one SGD step (lr 1, ``max_grad_norm`` 1) on
    ``grad``; sharded over the model axis when ``world`` has one."""
    ns = NetState(CellNet(), "sgd", max_grad_norm=1.0)
    if world is not None:
        ns.shard(world)
    ns.apply_gradients({"cell.kernel": torch.from_numpy(grad)}, 1.0, 0.5)
    return ns.params()["cell.kernel"].detach().numpy().copy()


def clip_rank(rank: int, world: int, address: str, grad_path: str,
              out_dir: str) -> int:
    """``clip_update`` on a data 1 x model 2 world: the shards, the
    gathered parameter."""
    torch.set_num_threads(1)
    initialize(address, world, rank)
    try:
        w = make_world(torch.device("cpu"), world)
        grad = np.load(grad_path)
        ns = NetState(CellNet(), "sgd", max_grad_norm=1.0)
        ns.shard(w)
        out = {"shards": dict(ns.shards), "param": clip_update(grad, w)}
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        return 0
    finally:
        shutdown()


def dp_counts_rank(rank: int, world: int, address: str, case_path: str,
                   out_dir: str) -> int:
    """``model_parallel=1``: no group is made, ``shard_state(...,
    tensor_parallel=True)`` shards nothing, and a step from it makes the
    collectives of the data-parallel path (``replicate``, then the step),
    which runs second from the same state: both counts and both states."""
    torch.set_num_threads(1)
    initialize(address, world, rank)
    try:
        w = make_world(torch.device("cpu"), 1)
        with open(case_path, "rb") as f:
            case = pickle.load(f)
        out = {"groups": (w.data_group, w.model_group), "model": w.model}
        for path in ("shard_state", "replicate"):
            tr = trainer(case["model"])
            st = ranks.init_state(tr, case["kind"])
            checkpoints.load_state_tree(st, case["state"])
            before = w.collectives
            if path == "shard_state":
                shard_state(w, st, tensor_parallel=True)
            else:
                for ns in nets(st).values():
                    replicate(w, ns.tensors())
            step(case, tr, st)
            out[path] = {"collectives": w.collectives - before,
                         "shards": {k: dict(ns.shards)
                                    for k, ns in nets(st).items()},
                         "digest": digest(checkpoints.state_tree(st))}
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        return 0
    finally:
        shutdown()
