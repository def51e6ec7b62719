"""The fused optimizer update's host side (``ops/optim.py``), on the CPU.

``csrc/optim.cu`` runs only on the card (``tests/test_torch_optim_cuda.py``
holds it against the plain path there). Here: the chunk table covers
every element of every leaf once, in order, for the nets of the three
benchmark configurations; each of them fits one parameter block, and the
ctypes layouts and sizes name the C source's; and, with the launch
replaced by an emulation that reads the tables and the parameter block
through their pointers, ``NetState.apply_fused`` updates bit for bit as
the plain path given the same norms, in groups of ``SLOTS`` leaves where
a net has more, raises each parameter's version, counts its launches and
is counted ``opt.fused``; ``apply_gradients`` takes it for every state on
the card but a tensor-parallel one, the plain path (``opt.plain``)
otherwise; and a tensor the kernel does not take raises.
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from rsrgan_tpu_torch import spans
from rsrgan_tpu_torch.models import get_discriminator, get_generator
from rsrgan_tpu_torch.models.segan import (SeganAEGenerator,
                                           SeganDiscriminator)
from rsrgan_tpu_torch.ops import optim
from rsrgan_tpu_torch.training.state import NetState, fused_path

SOURCE = os.path.join(os.path.dirname(optim.__file__), os.pardir, "csrc",
                      "optim.cu")
SEGAN_DEPTHS = [16, 32, 32, 64, 64, 128, 128, 256, 256, 512, 1024]

# the nets of res_lstm_l_lsgan / res_lstm_l_g and segan_ae_lsgan, as the
# benchmark's configurations build them
NETS = {
    "res_lstm_l_g": lambda: get_generator("res_lstm_l", input_dim=257,
                                          output_dim=40),
    "lstm_d": lambda: get_discriminator("lstm", input_dim=40),
    "segan_g": lambda: SeganAEGenerator(1799, 40, enc_depths=SEGAN_DEPTHS,
                                        bias_deconv=True),
    "segan_d": lambda: SeganDiscriminator(1839, num_fmaps=SEGAN_DEPTHS),
}


def leaf_sizes(net):
    with torch.device("meta"):
        return [p.numel() for p in NETS[net]().parameters()]


def source():
    with open(SOURCE) as f:
        return f.read()


def struct_fields(name):
    """Field names of ``struct name`` in csrc/optim.cu, in order."""
    body = re.search(r"struct %s \{(.*?)\n\};" % name, source(),
                     re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        first, *rest = (s.strip() for s in decl.split(","))
        names += [re.split(r"[\s*]+", first)[-1], *rest]
    return names


# ---------------------------------------------------------------------------
# the tables and the parameter block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", [*NETS, "odd"])
def test_chunk_table_covers_every_element_once_in_order(net):
    """Leaf by leaf, the chunks start at 0, CHUNK, 2 CHUNK, ... below the
    leaf's size, so that every element lies in exactly one chunk and the
    chunks run in the state's order; each leaf's (first, count) names its
    own chunks."""
    sizes = ([1, optim.CHUNK - 1, optim.CHUNK, optim.CHUNK + 1, 0, 5,
              3 * optim.CHUNK] if net == "odd" else leaf_sizes(net))
    chunks, per_leaf = optim.chunk_table(sizes)
    assert len(per_leaf) == len(sizes)
    at = 0
    for leaf, (n, (first, count)) in enumerate(zip(sizes, per_leaf)):
        assert first == at
        mine = chunks[first:first + count]
        assert mine == [(leaf, s) for s in range(0, n, optim.CHUNK)]
        ends = [min(s + optim.CHUNK, n) for _, s in mine]
        assert sum(e - s for (_, s), e in zip(mine, ends)) == n
        at += count
    assert at == len(chunks)


@pytest.mark.parametrize("net", NETS)
def test_parameter_block_fits(net):
    """The net's leaves fit one parameter block (one launch pair an
    update), and the block (the arguments and ``SLOTS`` gradient
    pointers) is within the source's limit of 4,096 bytes, far under the
    32,764 bytes of kernel parameters sm_90 takes."""
    n = len(leaf_sizes(net))
    assert n <= optim.SLOTS
    assert optim.block_bytes() == ctypes.sizeof(optim.Args) + 8 * optim.SLOTS
    limit = re.search(r"sizeof\(Block\) <= (\d+)", source()).group(1)
    assert optim.block_bytes() <= int(limit) <= 32764


@pytest.mark.parametrize("struct", [optim.Leaf, optim.Args],
                         ids=lambda s: s.__name__)
def test_ctypes_layouts_match_the_source(struct):
    """The ctypes records name the C structs' fields in order (the library
    checks their sizes at load), and the chunk size and the gradient
    slots are the kernel's."""
    assert [n for n, _ in struct._fields_] == struct_fields(struct.__name__)
    assert ctypes.sizeof(optim.Leaf) == 48 and ctypes.sizeof(optim.Args) == 96
    text = source()
    assert re.search(r"kChunk = (\d+);", text).group(1) == str(optim.CHUNK)
    assert re.search(r"kSlots = (\d+);", text).group(1) == str(optim.SLOTS)


# ---------------------------------------------------------------------------
# the fused path's host side, with the launch emulated on the CPU
# ---------------------------------------------------------------------------

def _view(ptr, n, ctype=ctypes.c_float):
    return torch.from_numpy(np.ctypeslib.as_array((ctype * n).from_address(
        ptr)))


def emulate(which, args, grads, device):
    """``optim_launch`` on the CPU: the kernels' work on one group of
    leaves, read through the tables and the gradient slots as the card
    reads them, in PyTorch's CPU operations where the kernel rounds as
    PyTorch's CUDA ones."""
    emulate.calls.append(which)
    n, nc = args.n_leaves, args.n_chunks
    assert 1 <= n <= optim.SLOTS
    leaves = (optim.Leaf * n).from_address(args.leaves)
    chunks = _view(args.chunks, 2 * nc, ctypes.c_int32).view(nc, 2).tolist()
    partials = _view(args.partials, nc, ctypes.c_double)
    f32 = np.float32
    if which == 0:
        if args.tick:
            _view(args.count, 1, ctypes.c_int32)[0] += 1
        for c, (leaf, start) in enumerate(chunks if args.clip else []):
            g = _view(grads[leaf], leaves[leaf].numel)
            g = g[start:start + optim.CHUNK].double()
            partials[c] = torch.sum(g * g)
        return
    for leaf, start in chunks:
        rec = leaves[leaf]
        sl = slice(start, start + optim.CHUNK)
        g = _view(grads[leaf], rec.numel)[sl]
        p, e = (_view(ptr, rec.numel)[sl] for ptr in (rec.p, rec.e))
        if args.clip:
            norm = f32(np.sqrt(float(partials[rec.first:rec.first
                                              + rec.chunks].sum())))
            if start == 0:
                _view(args.norms, n)[leaf] = float(norm)
            clamped = norm if np.isnan(norm) else max(norm, f32(args.max_norm))
            g = g * torch.tensor(f32(f32(1) / clamped) * f32(args.max_norm))
        if args.kind == optim.KINDS["sgd"]:
            u = g
        elif args.kind == optim.KINDS["adam"]:
            c = float(_view(args.count, 1, ctypes.c_int32)[0])
            bc1 = 1.0 - torch.pow(torch.tensor(args.b1), torch.tensor(c))
            bc2 = 1.0 - torch.pow(torch.tensor(args.b2), torch.tensor(c))
            mu, nu = (_view(ptr, rec.numel)[sl] for ptr in (rec.mu, rec.nu))
            mu.copy_(args.c1 * g + args.b1 * mu)
            nu.copy_(args.c2 * (g ** 2) + args.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + args.eps)
        else:
            nu = _view(rec.nu, rec.numel)[sl]
            nu.copy_(args.c2 * (g ** 2) + args.b2 * nu)
            u = torch.rsqrt(nu + args.eps) * g
        p.sub_(args.lr * u)
        e.sub_(args.ema_c * (e - p))


@pytest.fixture
def on_cpu(monkeypatch):
    """The kernels' launch emulated, their launch counts at 0, an armed
    and empty record of spans."""
    emulate.calls = []
    monkeypatch.setattr(optim, "launch", emulate)
    for attr in ("launches_by_shape", "launches_by_route"):
        monkeypatch.setattr(optim.FusedUpdate, attr, {})
    monkeypatch.setattr(optim.FusedUpdate, "launches", 0)
    spans.disable()
    spans.clear()
    spans.enable()
    yield emulate.calls
    spans.disable()
    spans.clear()


def make_module(shapes, seed):
    gen = torch.Generator().manual_seed(seed)
    module = torch.nn.Module()
    for i, shape in enumerate(shapes):
        module.register_parameter(f"w{i}", torch.nn.Parameter(
            torch.randn(shape, generator=gen)))
    return module


# odd sizes: below, at and past a chunk, several chunks, one element
SHAPES = [(3, 5), (optim.CHUNK,), (optim.CHUNK + 7,), (2, 3 * optim.CHUNK),
          (1,)]


def grads_for(module, step, scale=1.0, zero=()):
    """Seeded gradients: zero for the leaves in ``zero``, and a 2-D
    leaf's a transposed view (strided, as a convolution kernel's is)."""
    gen = torch.Generator().manual_seed(100 + step)
    out = {}
    for i, (k, p) in enumerate(module.named_parameters()):
        g = torch.randn(p.shape[::-1], generator=gen).permute(
            *reversed(range(p.dim()))) * scale * (1 + i)
        out[k] = torch.zeros_like(p) if k in zero else g
    return out


def clipped(grads, norms, max_norm):
    """The plain path's clip of ``grads`` with the given norms."""
    if max_norm is None:
        return grads
    return {k: g * (max_norm / torch.clamp(torch.tensor(float(n)),
                                           min=max_norm))
            for (k, g), n in zip(grads.items(), norms)}


def fused_against_plain(shapes, name, max_norm, updates=3):
    """``updates`` updates of one state on the fused path against the
    plain path given the fused path's norms: parameters, shadow and
    moments bit-equal, Adam's count incremented in place, each
    parameter's version raised; leaves under and over the clip, one whose
    gradient is zero, strided gradients."""
    fused = NetState(make_module(shapes, 0), name, max_norm)
    plain = NetState(make_module(shapes, 0), name, None)
    count = fused.opt_state.get("count")
    for step in range(updates):
        grads = grads_for(fused.module, step, scale=3.0,
                          zero=(f"w{len(shapes) - 1}",))
        versions = [p._version for p in fused.module.parameters()]
        fused.apply_fused(fused.params(), grads, 1e-2, 0.9)
        assert all(p._version > v for p, v in
                   zip(fused.module.parameters(), versions))
        norms = fused._fused_update.norms.tolist()
        if max_norm is not None:
            want = [float(torch.sqrt(torch.sum(torch.square(g))))
                    for g in grads.values()]
            np.testing.assert_allclose(norms, want, rtol=1e-6)
            assert min(norms[:-1]) < max_norm < max(norms)
        plain.apply_gradients(clipped(grads, norms, max_norm), 1e-2, 0.9)
        for k, p in plain.params().items():
            assert torch.equal(fused.params()[k], p), k
            assert torch.equal(fused.ema[k], plain.ema[k]), k
            for field in ("mu", "nu"):
                if field in plain.opt_state:
                    assert torch.equal(fused.opt_state[field][k],
                                       plain.opt_state[field][k]), k
        if name == "adam":
            assert fused.opt_state["count"] is count
            assert int(count) == int(plain.opt_state["count"]) == step + 1
    r = spans.read()
    assert r.total("opt.fused") == updates
    assert r.total("opt.plain") == updates
    assert r.units("opt.upload") == 1
    return fused


@pytest.mark.parametrize("name", ["adam", "sgd", "rmsprop"])
@pytest.mark.parametrize("max_norm", [15.0, None])
def test_fused_path_matches_the_plain_path(on_cpu, name, max_norm):
    """One group of leaves: three updates bit-equal to the plain path
    given the same norms; the tables copied once; the first launch only
    for the clip or Adam's count; each launch counted by kind, leaves and
    route."""
    fused_against_plain(SHAPES, name, max_norm)
    first = max_norm is not None or name == "adam"
    assert on_cpu == (([0] if first else []) + [1]) * 3
    per = 2 if first else 1
    shape = f"{name} leaves={len(SHAPES)}"
    assert optim.FusedUpdate.launches == 3 * per
    assert optim.FusedUpdate.launches_by_shape == {shape: 3 * per}
    assert optim.FusedUpdate.launches_by_route == {
        **({"sumsq": 3} if first else {}), "update": 3}


@pytest.mark.parametrize("name,max_norm", [("adam", 15.0), ("adam", None),
                                           ("rmsprop", None)])
def test_fused_path_in_groups_past_a_parameter_block(on_cpu, monkeypatch,
                                                     name, max_norm):
    """More leaves than a parameter block's gradient slots (2 here, 64 in
    the kernel): a launch pair a group, bit-equal to the plain path; the
    first group's first launch alone increments Adam's count, and a group
    after it launches its first kernel only for the clip."""
    monkeypatch.setattr(optim, "SLOTS", 2)
    monkeypatch.setattr(optim, "Slots", ctypes.c_void_p * 2)
    fused = fused_against_plain(SHAPES, name, max_norm)
    assert fused._fused_update.groups == [(0, 2), (2, 4), (4, 5)]
    if max_norm is not None:
        per_update = [0, 1, 0, 1, 0, 1]
    else:
        per_update = ([0] if name == "adam" else []) + [1, 1, 1]
    assert on_cpu == per_update * 3
    # launches of 3 updates by the group's leaves: 2, 2 and 1
    want = ({2: 12, 1: 6} if max_norm is not None
            else {2: 9, 1: 3} if name == "adam" else {2: 6, 1: 3})
    assert optim.FusedUpdate.launches_by_shape == {
        f"{name} leaves={n}": v for n, v in want.items()}


def test_tables_made_again_when_a_storage_changes(on_cpu):
    """A checkpoint load puts new tensors in the shadow and the moments:
    the next update makes new tables for them (one copy), and updates the
    new tensors."""
    ns = NetState(make_module(SHAPES, 1), "adam", 15.0)
    ns.apply_fused(ns.params(), grads_for(ns.module, 0), 1e-3, 0.99)
    first = ns._fused_update
    ns.apply_fused(ns.params(), grads_for(ns.module, 1), 1e-3, 0.99)
    assert ns._fused_update is first
    ns.ema = {k: v.clone() for k, v in ns.ema.items()}
    ns.opt_state["mu"] = {k: v.clone() for k, v in ns.opt_state["mu"].items()}
    before = {k: v.clone() for k, v in ns.ema.items()}
    ns.apply_fused(ns.params(), grads_for(ns.module, 2), 1e-3, 0.99)
    assert ns._fused_update is not first
    assert spans.read().units("opt.upload") == 2
    assert all(not torch.equal(before[k], v) for k, v in ns.ema.items())


@pytest.mark.parametrize("case", ["cpu", "sharded", "bf16_leaf",
                                  "f64_grad", "too_many_leaves"])
def test_plain_path_where_the_kernel_does_not_apply(on_cpu, monkeypatch,
                                                    case):
    """Where the kernel does not apply: the CPU and a tensor-parallel
    state take the plain path (``fused_path``), counted ``opt.plain`` once
    an update; a bf16 leaf or an f64 gradient is a ValueError on the fused
    path, which has no plain fallback on the card, and the CPU's plain
    path takes it; leaves past a parameter block are the fused path's, in
    groups."""
    card = torch.device("cuda", 0)
    assert fused_path(card, sharded=False)
    shapes = [(3, 4), (4,)]
    ns = NetState(make_module(shapes, 2), "sgd", 15.0)
    if case == "sharded":
        # its plain update gathers blocks over the model group, which needs
        # a process group (tests/test_torch_tensor_parallel.py): here the
        # dispatch alone
        assert not fused_path(card, sharded=True)
        assert not fused_path(torch.device("cpu"), sharded=True)
        assert on_cpu == []
        return
    if case == "too_many_leaves":
        monkeypatch.setattr(optim, "SLOTS", 1)
        monkeypatch.setattr(optim, "Slots", ctypes.c_void_p * 1)
        ns.apply_fused(ns.params(), grads_for(ns.module, 0), 1e-3, 0.9)
        assert on_cpu == [0, 1, 0, 1]
        assert spans.read().total("opt.fused") == 1
        return
    if case == "bf16_leaf":
        ns.module.w1.data = ns.module.w1.data.to(torch.bfloat16)
        ns.ema["w1"] = ns.ema["w1"].to(torch.bfloat16)
    grads = [grads_for(ns.module, step) for step in range(2)]
    if case == "f64_grad":
        grads[0]["w0"] = grads[0]["w0"].double()
    if case == "bf16_leaf":
        for g in grads:
            g["w1"] = g["w1"].to(torch.bfloat16)
    if case != "cpu":
        with pytest.raises(ValueError, match="float32"):
            ns.apply_fused(ns.params(), grads[0], 1e-3, 0.9)
        spans.clear()
    assert not fused_path(torch.device("cpu"), sharded=False)
    for g in grads:
        ns.apply_gradients(g, 1e-3, 0.9)
    r = spans.read()
    assert r.total("opt.plain") == 2 and r.total("opt.fused") == 0
    assert on_cpu == []


@pytest.mark.parametrize("case", ["strided_parameter", "other_device",
                                  "huge_leaf", "adam_count"])
def test_fused_update_raises_where_a_tensor_does_not_fit(on_cpu, case):
    """A strided parameter, a shadow on another device than the first
    parameter, a leaf of 2^31 elements, an Adam count that is not an int32
    tensor: each a ValueError, and nothing launched."""
    p = torch.zeros(4, 3)
    leaf = [p, None, None, torch.zeros(4, 3)]
    kind = "sgd"
    if case == "strided_parameter":
        leaf[0] = torch.zeros(3, 4).t()
        leaf[3] = torch.zeros(4, 3)
    elif case == "other_device":
        leaf[3] = torch.zeros(4, 3, device="meta")
    elif case == "huge_leaf":
        leaf = [torch.empty(2 ** 31, device="meta"), None, None,
                torch.empty(2 ** 31, device="meta")]
    with pytest.raises(ValueError):
        if case == "adam_count":
            update = optim.FusedUpdate(
                {"w": (p, torch.zeros(4, 3), torch.zeros(4, 3),
                       torch.zeros(4, 3))}, "adam",
                {"b1": 0.9, "b2": 0.999, "eps": 1e-8})
            update.take_grads([torch.ones(4, 3)])
            update.apply([p], torch.zeros((), dtype=torch.int64), 1e-3,
                         0.9, None)
        else:
            optim.FusedUpdate({"w": tuple(leaf)}, kind, {})
    assert on_cpu == []
