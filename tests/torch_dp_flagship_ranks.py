"""What each rank of tests/test_torch_dp_flagship.py's gloo world runs
(the port and torch only): the flagship's trainer at narrow widths, one
iteration on this rank's rows of the global batch at the rates x the
world, the all-reduces counted (``spans``). Each rank writes what it
holds after the iteration to ``out_dir/rank{r}.pkl``."""

import os
import pickle

import torch

from rsrgan_tpu_torch import spans
from rsrgan_tpu_torch.models.discriminators import LstmDiscriminator
from rsrgan_tpu_torch.models.recurrent import ResLstmGenerator
from rsrgan_tpu_torch.parallel import (initialize, make_world, shard_batch,
                                       shutdown)
from rsrgan_tpu_torch.training import GanTrainer

IN, OUT = 9, 4                  # res_lstm_l: the projection is the input
GU, DU = 13, 10


def trainer(weights):
    """The flagship's G and D (``lstm_impl`` auto: the kernels' twins on
    the CPU) with ``weights`` loaded by name, f32."""
    g = ResLstmGenerator(IN, OUT, variant="l", cell_size=GU,
                         compute_dtype=torch.float32)
    d = LstmDiscriminator(input_dim=OUT, cell_size=DU, num_projection=OUT,
                          compute_dtype=torch.float32)
    for module, tree in ((g, weights["g"]), (d, weights["d"])):
        params = dict(module.named_parameters())
        assert set(params) == set(tree)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(torch.as_tensor(tree[k]))
    return GanTrainer(g, d, output_dim=OUT, input_dim=IN, l2_scale=0.0)


def step_rank(rank: int, world: int, address: str, case_path: str,
              out_dir: str) -> int:
    torch.set_num_threads(1)
    initialize(address, world, rank)
    try:
        world = make_world(torch.device("cpu"))
        with open(case_path, "rb") as f:
            case = pickle.load(f)
        tr = trainer(case["weights"])
        state = tr.init_state()
        x, y, lens = (shard_batch(world, torch.as_tensor(a))
                      for a in case["batch"])
        spans.clear()
        spans.enable()
        try:
            m = tr.train_step(state, x, y, lens, case["hp"],
                              torch.Generator().manual_seed(case["noise"]))
            r = spans.read()
        finally:
            spans.disable()
            spans.clear()
        out = {"metrics": {k: float(v) for k, v in m.items()},
               "g": {k: p.detach().clone() for k, p in
                     state.g.params().items()},
               "d": {k: p.detach().clone() for k, p in
                     state.d.params().items()},
               "mu": {k: v.clone() for k, v in
                      state.g.opt_state["mu"].items()},
               "all_reduces": r.units("comm.all_reduce"),
               "bytes": r.total("comm.bytes")}
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        shutdown()
    return 0
