"""The port's tensor parallelism (JAX's model axis: ``make_mesh(...,
model_parallel=m)``, ``lstm_param_sharding``, ``shard_state(...,
tensor_parallel=True)``) against the JAX package and against the port's
data-parallel and one-process steps, on the CPU in spawned gloo worlds
(tests/torch_tp_ranks.py).

* Placement, leaf by leaf: the port's ``lstm_param_sharding`` on its
  parameter names against JAX's rule on ``make_mesh(8,
  model_parallel=2)`` for every leaf of res_lstm_l at full width, lstm,
  bnlstm, LSTM-D, the DNN and SEGAN's generators; on the flagship state,
  JAX's ``shard_state`` placement of params, EMA and Adam moments against
  the port's, 6 kernels, 6 biases and 6 projections sharded
  (tests/test_parallel.py:113-114).
* The clip: a gradient whose halves are each under ``max_grad_norm`` but
  whose whole norm is over it is clipped as the whole.
* The flagship at full width (B=4, T=12, f32): data 2 x model 2 bit for
  bit the port's data-parallel step at world 2 (metrics, gradients, the
  checkpoint's bytes), and within tests/test_parallel.py:116-131's
  tolerances of JAX's one-device step (metrics 1e-3 (1 + |a|), G params
  atol 5e-4); each rank keeps half of every sharded leaf's EMA and
  moments, its own half.
* tests/test_parallel.py's tiny dims, data 1 x model 2: the step within
  1e-4 of JAX's and inference within 1e-5; the checkpoint byte-equal to
  the port's one-process run's; restored into the sharded state, each
  rank keeps its block.
* ``--trainer=rnn --g_type=lstm``'s step under data 1 x model 2, bit for
  bit the one-process step.
* ``model_parallel=1`` makes no group and the data-parallel collectives;
  the frame trainer and SEGAN (no LSTM cell) shard nothing.
"""

import functools
import os
import pickle

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_ranks as tpr
from rsrgan_tpu.models.discriminators import LstmDiscriminator as JaxDisc
from rsrgan_tpu.models.feedforward import DnnGenerator as JaxDnn
from rsrgan_tpu.models.recurrent import BnLstmGenerator as JaxBnGen
from rsrgan_tpu.models.recurrent import LstmGenerator as JaxLstmGen
from rsrgan_tpu.models.recurrent import ResLstmGenerator as JaxResGen
from rsrgan_tpu.models.segan import SeganAEGenerator as JaxAE
from rsrgan_tpu.models.segan import SeganWaveGenerator as JaxWave
from rsrgan_tpu.parallel import make_mesh
from rsrgan_tpu.parallel import lstm_param_sharding as jax_sharding
from rsrgan_tpu.parallel import shard_state as jax_shard_state
from rsrgan_tpu.training import GanTrainer as JaxGanTrainer
from rsrgan_tpu_torch.models import (flatten_tree, get_discriminator,
                                     get_generator)
from rsrgan_tpu_torch.models.segan import (SeganAEGenerator,
                                           SeganWaveGenerator)
from rsrgan_tpu_torch.parallel import (DataWorld, launch,
                                       lstm_param_sharding, make_world)
from rsrgan_tpu_torch.training import checkpoints

torch.set_num_threads(1)

SPAWN_TIMEOUT = 240
# a rank of JAX's make_mesh(8, model_parallel=2): 4 data x 2 model
MESH_2 = DataWorld(rank=0, world=8, model=2)
HP = {"g_lr": 1e-3, "d_lr": 1e-3, "mse_lambda": 10.0,
      "disc_noise_std": 0.0, "d_real": 1.0, "d_fake": 0.0}


def run_ranks(fn, world, tmp_path, *args):
    """``fn`` on ``world`` spawned gloo ranks writing to ``tmp_path``;
    each must exit 0; their pickles in rank order."""
    out_dir = str(tmp_path)
    assert launch(fn, world, args=args + (out_dir,),
                  timeout=SPAWN_TIMEOUT) == 0
    outs = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


def run_case(case, world, model_parallel, tmp_path):
    os.makedirs(tmp_path, exist_ok=True)
    path = os.path.join(tmp_path, "case.pkl")
    with open(path, "wb") as f:
        pickle.dump(case, f)
    return run_ranks(tpr.tp_rank, world, tmp_path, model_parallel, path)


def ckpt_bytes(out_dir):
    with open(os.path.join(out_dir, "ckpt", "TP-1.ckpt"), "rb") as f:
        return f.read()


def one_process(case, tmp_path):
    """The case's step in this process (a world of one) from the case's
    state, on one thread as each rank runs (a product's sums depend on
    the threads): (metrics, first gradients, the checkpoint's bytes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr = tpr.trainer(case["model"])
        st = tpr.ranks.init_state(tr, case["kind"])
        if case.get("state") is not None:
            checkpoints.load_state_tree(st, case["state"])
        metrics, grads = tpr.step(case, tr, st)
        tree = checkpoints.state_tree(st)
    finally:
        torch.set_num_threads(threads)
    path = checkpoints.save_checkpoint(str(tmp_path), "TP", tree, 1)
    with open(path, "rb") as f:
        return metrics, grads, f.read()


def state_dict(state):
    return flax.serialization.to_state_dict(jax.tree.map(np.asarray, state))


def spec_axis(spec):
    """The sharded axis of a PartitionSpec over ``model``, or None."""
    return next((i for i, s in enumerate(tuple(spec)) if s == "model"),
                None)


def path_keys(path):
    return [str(getattr(p, "key", getattr(p, "name", getattr(p, "idx",
                                                               p))))
            for p in path]


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def _x(*shape):
    return jnp.zeros(shape, jnp.float32)


# model -> (JAX model, its init arguments past the key, the port's module)
PLACEMENT = {
    "res_lstm_l": (lambda: JaxResGen(output_dim=40, variant="l",
                                     cell_size=760),
                   lambda: (_x(2, 5, 257), jnp.full((2,), 5)),
                   lambda: get_generator("res_lstm_l", input_dim=257,
                                         output_dim=40)),
    "lstm": (lambda: JaxLstmGen(output_dim=40),
             lambda: (_x(2, 5, 257), jnp.full((2,), 5)),
             lambda: get_generator("lstm", input_dim=257, output_dim=40)),
    "bnlstm": (lambda: JaxBnGen(output_dim=40),
               lambda: (_x(2, 5, 257), jnp.full((2,), 5)),
               lambda: get_generator("bnlstm", input_dim=257,
                                     output_dim=40)),
    "lstm_d": (lambda: JaxDisc(cell_size=256, num_projection=40),
               lambda: (_x(2, 5, 40), jnp.full((2,), 5)),
               lambda: get_discriminator("lstm")),
    "dnn": (lambda: JaxDnn(output_dim=40),
            lambda: (_x(2, 257 * 11),),
            lambda: get_generator("dnn", input_dim=257, output_dim=40,
                                  left_context=5, right_context=5)),
    "segan_ae": (lambda: JaxAE(units=40), lambda: (_x(2, 257 * 7),),
                 lambda: SeganAEGenerator(257 * 7, 40)),
    "segan_wave": (lambda: JaxWave(units=40), lambda: (_x(2, 257 * 7),),
                   lambda: SeganWaveGenerator(257 * 7, 40)),
}


@pytest.mark.parametrize("model", list(PLACEMENT))
def test_placement_matches_jax_leaf_by_leaf(model):
    """Every parameter of the port's module: the same leaves as JAX's
    tree, each sharded on the axis JAX's rule gives it on the (4, 2)
    mesh, or replicated where JAX replicates it."""
    make_jax, args, make_port = PLACEMENT[model]
    jm = make_jax()
    keys = {"params": jax.random.PRNGKey(0), "z": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2)}
    params = jax.eval_shape(jm.init, keys, *args())["params"]
    mesh = make_mesh(8, model_parallel=2)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        path_str = "/".join(str(getattr(p, "key", p)) for p in path)
        want[".".join(path_keys(path))] = spec_axis(
            jax_sharding(mesh, path_str, leaf).spec)
    got = {k: lstm_param_sharding(MESH_2, k, tuple(p.shape))
           for k, p in make_port().named_parameters()}
    assert sorted(got) == sorted(want)
    assert got == want
    sharded = sum(a is not None for a in got.values())
    assert sharded == {"res_lstm_l": 12, "lstm": 9, "bnlstm": 9,
                       "lstm_d": 6}.get(model, 0), got
    if model == "bnlstm":   # JAX's rule leaves projection_kernel alone
        assert got["cell_0.projection_kernel"] is None
        assert got["cell_0.input_kernel"] == got["cell_0.state_kernel"] == 1


def test_model_axis_needs_a_divisible_world():
    """No model axis in a world of one process; m = 1 is the data world."""
    with pytest.raises(ValueError, match="no model axis"):
        make_world(torch.device("cpu"), model_parallel=2)
    w = make_world(torch.device("cpu"), model_parallel=1)
    assert (w.model, w.data_size, w.data_group, w.model_group) == (
        1, 1, None, None)
    assert lstm_param_sharding(w, "cell_0.kernel", (80, 1024)) is None


def test_rank_layout_is_jax_row_major():
    """Rank r at data index r // m, model index r % m: JAX's
    ``make_mesh`` reshape(n // m, m) of devices 0..n-1."""
    mesh = make_mesh(8, model_parallel=2)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    for r in range(8):
        w = DataWorld(rank=r, world=8, model=2)
        assert ids[w.data_rank, w.model_rank] == r
        assert w.data_size == mesh.shape["data"] == 4


# ---------------------------------------------------------------------------
# the flagship at full width
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def flagship_jax():
    """JAX's flagship (res_lstm_l G, LSTM-D, production dims, scan cell):
    the state before (a state dict), JAX's TP placement of it, one
    one-device step at B=4, T=12 (tests/test_parallel.py:69-131)."""
    gen = JaxResGen(output_dim=40, variant="l", cell_size=760)
    disc = JaxDisc(cell_size=256, num_projection=40)
    tr = JaxGanTrainer(gen, disc, output_dim=40, input_dim=257)
    rng = np.random.default_rng(16)
    x = rng.normal(size=(4, 12, 257)).astype(np.float32)
    y = rng.normal(size=(4, 12, 40)).astype(np.float32)
    lens = np.full((4,), 12, np.int32)
    state = tr.init_state(jax.random.PRNGKey(0), jnp.asarray(x[:2]),
                          jnp.asarray(lens[:2]))
    s0 = state_dict(state)
    placed = jax_shard_state(make_mesh(8, model_parallel=2), state,
                             tensor_parallel=True)
    specs = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
        specs[tuple(path_keys(path))] = spec_axis(leaf.sharding.spec)
    del placed
    s1, m = jax.jit(tr._train_step_impl)(
        state, jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(lens), {k: jnp.float32(v) for k, v in HP.items()},
        jax.random.PRNGKey(5))
    return ({"kind": "gan", "model": "flagship", "batch": (x, y, lens),
             "hp": HP, "state": s0}, specs,
            flatten_tree(state_dict(s1.g.params)),
            {k: float(v) for k, v in m.items()})


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """The flagship step on data 2 x model 2 and on the data-parallel
    world of 2."""
    case = flagship_jax()[0]
    base = tmp_path_factory.mktemp("flagship")
    return {tag: (run_case(case, n, m, str(base / tag)), str(base / tag))
            for tag, n, m in (("tp", 4, 2), ("dp", 2, 1))}


def test_flagship_placement_matches_jax_shard_state(flagship):
    """JAX's ``shard_state`` on the flagship state against each rank's
    ``NetState.shards``: the params, the EMA and Adam's moments of each
    leaf on one axis; 6 kernel, 6 bias and 6 proj_kernel leaves sharded,
    nothing else; SGD's D keeps no moments."""
    specs = flagship_jax()[1]
    outs, _ = flagship["tp"]
    kinds = {"kernel": 0, "bias": 0, "proj_kernel": 0}
    for net in ("g", "d"):
        shards = outs[0]["shards"][net]
        for path, axis in specs.items():
            if path[0] != net or path[1] not in ("params", "ema",
                                                 "opt_state"):
                continue
            name = ".".join(path[2:] if path[1] != "opt_state"
                            else path[4:])
            if path[1] == "opt_state" and path[3] not in ("mu", "nu"):
                continue
            assert shards.get(name) == axis, (path, axis)
        for name in shards:
            kinds[name.rsplit(".", 1)[-1]] += 1
        assert all(o["shards"][net] == shards for o in outs)
    assert kinds == {"kernel": 6, "bias": 6, "proj_kernel": 6}


def test_flagship_tp_step_bit_equal_to_dp_and_close_to_jax(flagship):
    """Data 2 x model 2 against data-parallel world 2: the same metrics,
    gradients and checkpoint bytes on every rank; against JAX's
    one-device step at tests/test_parallel.py's TP tolerances."""
    tp, tp_dir = flagship["tp"]
    dp, dp_dir = flagship["dp"]
    assert [o["layout"] for o in tp] == [(0, 2, 0, 2), (0, 2, 1, 2),
                                         (1, 2, 0, 2), (1, 2, 1, 2)]
    assert tp[0]["metrics"] == dp[0]["metrics"]
    for k, g in dp[0]["grads"].items():
        np.testing.assert_array_equal(tp[0]["grads"][k], g, err_msg=k)
    assert {o["digest"] for o in tp} == {dp[0]["digest"]}
    assert ckpt_bytes(tp_dir) == ckpt_bytes(dp_dir)
    # 3 updates: the data mean and the model gather each
    assert tp[0]["step_collectives"] == 2 * dp[0]["step_collectives"] == 6
    _, _, g_want, m_want = flagship_jax()
    for k, a in m_want.items():
        b = tp[0]["metrics"][k]
        assert abs(a - b) < 1e-3 * (1 + abs(a)), (k, a, b)
    got = flatten_tree(checkpoints.read_checkpoint(
        os.path.join(tp_dir, "ckpt", "TP-1.ckpt"))["g"]["params"])
    assert sorted(got) == sorted(g_want)
    for k, w in g_want.items():
        np.testing.assert_allclose(got[k], w, atol=5e-4, err_msg=k)


def test_flagship_ranks_keep_half_of_each_sharded_leaf(flagship):
    """Each rank's EMA, mu and nu of a sharded leaf hold 1/2 of the
    leaf's elements, and they are this rank's block of the whole tree,
    after the step and once the checkpoint's tree is restored."""
    tp, _ = flagship["tp"]
    for o in tp:
        assert o["kept_is_block"] and o["restored_is_block"]
        for net, leaves in o["numel"].items():
            want_kept = 3 if net == "g" else 1   # Adam: EMA, mu, nu; SGD
            assert len(leaves) == (12 if net == "g" else 6)
            for k, (kept, whole) in leaves.items():
                assert kept == [whole // 2] * want_kept, (net, k)


# ---------------------------------------------------------------------------
# the tiny dims against JAX, the checkpoint, the clip
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def tiny_jax():
    """tests/test_parallel.py:138-163 on the JAX side: inference and one
    step (PRNGKey(3)) from ``init_state(PRNGKey(0))``."""
    gen = JaxResGen(output_dim=tpr.TINY_OUT, variant="l",
                    cell_size=tpr.TINY_U)
    disc = JaxDisc(cell_size=tpr.TINY_DU, num_projection=tpr.TINY_DP)
    tr = JaxGanTrainer(gen, disc, output_dim=tpr.TINY_OUT,
                       input_dim=tpr.TINY_IN)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 10, tpr.TINY_IN)).astype(np.float32)
    y = rng.normal(size=(8, 10, tpr.TINY_OUT)).astype(np.float32)
    lens = np.asarray([10, 9, 4, 10, 7, 10, 2, 10], np.int32)
    state = tr.init_state(jax.random.PRNGKey(0), jnp.asarray(x[:2]),
                          jnp.asarray(lens[:2]))
    s0 = state_dict(state)
    out = np.asarray(tr.infer_step(state.g.params, jnp.asarray(x),
                                   jnp.asarray(lens)))
    s1, m = jax.jit(tr._train_step_impl)(
        state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(lens),
        {k: jnp.float32(v) for k, v in HP.items()}, jax.random.PRNGKey(3))
    return ({"kind": "gan", "model": "tiny", "batch": (x, y, lens),
             "hp": HP, "state": s0, "infer": True, "keep_arrays": True},
            out, flatten_tree(state_dict(s1.g.params)),
            {k: float(v) for k, v in m.items()})


def test_tiny_tp_matches_jax_and_one_process_checkpoint(tmp_path):
    """Data 1 x model 2 at tests/test_parallel.py's tiny dims: inference
    within 1e-5 and the step within 1e-4 of JAX's; the checkpoint
    byte-equal to the port's one-process run's; both ranks' digests
    equal; each rank's restored blocks its model index's half."""
    case, out_want, g_want, m_want = tiny_jax()
    outs = run_case(case, 2, 2, str(tmp_path / "tp"))
    for o in outs:
        np.testing.assert_allclose(o["infer"], out_want, atol=1e-5)
        for k, a in m_want.items():
            assert abs(a - o["metrics"][k]) < 1e-4 * (1 + abs(a)), k
    got = flatten_tree(checkpoints.read_checkpoint(
        str(tmp_path / "tp" / "ckpt" / "TP-1.ckpt"))["g"]["params"])
    for k, w in g_want.items():
        np.testing.assert_allclose(got[k], w, atol=1e-4, err_msg=k)
    m1, g1, ref_bytes = one_process(case, tmp_path / "one")
    assert outs[0]["metrics"] == m1
    assert ckpt_bytes(str(tmp_path / "tp")) == ref_bytes
    assert outs[0]["digest"] == outs[1]["digest"]
    whole = checkpoints.read_checkpoint(
        str(tmp_path / "tp" / "ckpt" / "TP-1.ckpt"))
    for r, o in enumerate(outs):
        assert o["restored_is_block"]
        for net, leaves in o["kept"].items():
            node = whole[net]
            trees = [flatten_tree(node["ema"])] + [
                flatten_tree(node["opt_state"]["1"][f])
                for f in ("mu", "nu") if f in node["opt_state"]["1"]]
            for k, kept in leaves.items():
                axis = o["shards"][net][k]
                for block, tree in zip(kept, trees):
                    halves = np.split(np.asarray(tree[k]), 2, axis=axis)
                    np.testing.assert_array_equal(block, halves[r],
                                                  err_msg=(net, k))


def test_clip_sees_the_whole_gradient(tmp_path):
    """A gradient of ``cell.kernel`` [2, 8] whose two model halves each
    have norm 0.79, under ``max_grad_norm`` 1, but whose whole norm 1.12
    is over it: both ranks clip it as the whole, bit for bit the
    one-process update; a clip of each half would not have clipped."""
    grad = np.zeros((2, 8), np.float32)
    grad[:, :4] = 0.28
    grad[:, 4:] = -0.28
    assert np.linalg.norm(grad[:, :4]) < 1.0 < np.linalg.norm(grad)
    path = str(tmp_path / "grad.npy")
    np.save(path, grad)
    outs = run_ranks(tpr.clip_rank, 2, tmp_path, path)
    want = tpr.clip_update(grad)
    np.testing.assert_allclose(want, -grad / np.linalg.norm(grad),
                               rtol=1e-6)
    for o in outs:
        assert o["shards"] == {"cell.kernel": 1}
        np.testing.assert_array_equal(o["param"], want)
        assert not np.allclose(o["param"], -grad)


# ---------------------------------------------------------------------------
# the MSE trainer, model_parallel=1, the nets without a cell
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["lstm", "bnlstm"])
def test_rnn_step_under_tp(tmp_path, model):
    """``--trainer=rnn``: ``--g_type=lstm`` (3 x LSTM(760, proj 280)) at
    B=2, T=8 on data 1 x model 2, 9 leaves sharded (the Dense layers
    replicated), bit for bit the one-process step; bnlstm at narrow
    widths on data 2 x model 2 (its per-step statistics over the data
    group), 6 leaves sharded (``projection_kernel`` replicated, as JAX
    leaves it), bit for bit the data-parallel step at world 2."""
    rng = np.random.default_rng(5)
    tr = tpr.trainer(model)
    if model == "lstm":
        x = rng.normal(size=(2, 8, 257)).astype(np.float32)
        y = rng.normal(size=(2, 8, 40)).astype(np.float32)
        lens = np.asarray([8, 5], np.int32)
    else:
        x = rng.normal(size=(8, 8, tpr.ranks.IN)).astype(np.float32)
        y = rng.normal(size=(8, 8, tpr.ranks.OUT)).astype(np.float32)
        lens = np.asarray([6, 4, 0, 2, 6, 3, 1, 5], np.int32)
    case = {"kind": "mse", "model": model, "lr": 3e-4,
            "state": checkpoints.state_tree(tr.init_state()),
            "batch": (x, y, lens)}
    if model == "lstm":
        outs = run_case(case, 2, 2, str(tmp_path / "tp"))
        m1, g1, ref_bytes = one_process(case, tmp_path / "one")
    else:
        outs = run_case(case, 4, 2, str(tmp_path / "tp"))
        ref = run_case(case, 2, 1, str(tmp_path / "dp"))
        m1, g1 = ref[0]["metrics"], ref[0]["grads"]
        ref_bytes = ckpt_bytes(str(tmp_path / "dp"))
    shards = outs[0]["shards"]["net"]
    if model == "lstm":
        assert len(shards) == 9 and all(
            k.startswith("StackedLstm_0.cell_") for k in shards)
    else:
        assert sorted(shards) == sorted(
            f"cell_{i}.{leaf}" for i in range(tpr.ranks.BN_LAYERS)
            for leaf in ("input_kernel", "state_kernel", "bias"))
    assert outs[0]["metrics"] == m1
    for k, g in g1.items():
        np.testing.assert_array_equal(outs[0]["grads"][k], g, err_msg=k)
    assert ckpt_bytes(str(tmp_path / "tp")) == ref_bytes
    assert len({o["digest"] for o in outs}) == 1


def test_model_parallel_one_is_the_data_parallel_world(tmp_path):
    """``make_world(..., model_parallel=1)`` makes no group; from one
    state, ``shard_state(..., tensor_parallel=True)`` then the step
    launches what ``replicate`` then the step does (broadcasts, then one
    all-reduce an update), and gives the same state."""
    case = dict(tiny_jax()[0], infer=False)
    path = str(tmp_path / "case.pkl")
    with open(path, "wb") as f:
        pickle.dump(case, f)
    for o in run_ranks(tpr.dp_counts_rank, 2, tmp_path, path):
        assert o["groups"] == (None, None) and o["model"] == 1
        a, b = o["shard_state"], o["replicate"]
        assert a["shards"] == b["shards"] == {"g": {}, "d": {}}
        assert a["collectives"] == b["collectives"]
        assert a["digest"] == b["digest"]


@pytest.mark.parametrize("kind", ["dnn_bn", "segan"])
def test_nets_without_a_cell_shard_nothing(tmp_path, kind):
    """The frame DNN (BatchNorm) and SEGAN under data 1 x model 2:
    nothing sharded, no collective in the step, the step the one-process
    step bit for bit."""
    rng = np.random.default_rng(9)
    if kind == "dnn_bn":
        case = {"kind": kind, "model": kind, "lr": 1e-3, "batch": (
            rng.normal(size=(8, tpr.ranks.IN * tpr.ranks.SPLICE))
            .astype(np.float32),
            rng.normal(size=(8, tpr.ranks.OUT)).astype(np.float32), None)}
    else:
        case = {"kind": kind, "model": kind, "seed": 4, "batch": (
            rng.normal(size=(8, tpr.ranks.SEGAN_W_IN)).astype(np.float32),
            rng.normal(size=(8, tpr.ranks.SEGAN_W_OUT)).astype(np.float32),
            None),
            "hp": {"g_lr": 5e-4, "d_lr": 1e-3, "l1_lambda": 3.0,
                   "disc_noise_std": 0.3}}
    outs = run_case(case, 2, 2, str(tmp_path / "tp"))
    m1, _, ref_bytes = one_process(case, tmp_path / "one")
    for o in outs:
        assert all(s == {} for s in o["shards"].values())
        assert o["step_collectives"] == 0
        assert o["metrics"] == m1
    assert ckpt_bytes(str(tmp_path / "tp")) == ref_bytes
