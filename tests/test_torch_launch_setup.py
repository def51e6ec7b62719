"""The kernels' launch setup made once per shape, on the CPU.

``ops/resident.py`` keeps each launch's unit index and its int32 bounds
or rows on the device once per key (``unit_index``, ``upload_int32``),
and the plan functions are memoised. Here: the cached tensors equal the
per-block loop that built them before, at the plans of the benchmark's
cells (B = 8, 16, 32; G and D widths; K4 at L = 4) and of the tools
(K4 at D width and at ``--g_type=lstm``'s stack, K1's plans at every
``nbl`` that ``tools/time_k1_plans.py`` times, K3's resident walk up to
256 rows); a key returns the same tensor, any other key another; the
counters ``launch.setup_miss`` and ``launch.setup_hit`` and the
``host_wait`` of a copy to a device other than the CPU (the ``meta``
device stands in for the card) come once per key; every memoised plan
equals a fresh call and stays as it was after packing.
"""

import dataclasses

import pytest
import torch

from rsrgan_tpu_torch import spans
from rsrgan_tpu_torch.ops import lstm_seq as ls
from rsrgan_tpu_torch.ops import resident
from rsrgan_tpu_torch.ops import wavefront as wf
from rsrgan_tpu_torch.tools.time_k1_plans import NBL

SMS = 132
BF16, F32 = torch.bfloat16, torch.float32
CPU, META = torch.device("cpu"), torch.device("meta")


@pytest.fixture
def constants(monkeypatch):
    """An empty cache of device constants and an armed, empty record."""
    monkeypatch.setattr(resident, "_CONSTANTS", {})
    spans.disable()
    spans.clear()
    spans.enable()
    yield
    spans.disable()
    spans.clear()


def loop_unit_index(bounds, width, pad):
    """The per-block construction ``unit_index`` replaced."""
    idx = torch.full((len(bounds) - 1, width), pad, dtype=torch.int64)
    for i in range(len(bounds) - 1):
        idx[i, :bounds[i + 1] - bounds[i]] = torch.arange(bounds[i],
                                                          bounds[i + 1])
    return idx


# (plan, the unit index's (bounds, width, pad) or None, the int32 values)
def k2(B, U, P, dtype=BF16, acc=False):
    p = ls.resident_plan(B, U, P, dtype, SMS, acc)
    return p, (p.unit_bounds, p.NU, U), p.unit_bounds + p.col_bounds


def k4(B, L, U, P, dtype=BF16, nbl=None):
    p = wf.resident_plan(B, L, U, P, dtype, SMS, nbl=nbl)
    return p, (p.unit_bounds, p.NU, U), p.unit_bounds + p.pair_bounds


def k1_rows(B, U, P, dtype=BF16):
    p = ls.rowgroup_plan(B, U, P, dtype, SMS)
    return p, None, p.row_bounds


def k3_rows(B, U, P, dtype=BF16):
    p = ls.rowgroup_bwd_plan(B, U, P, dtype, SMS)
    return p, None, p.row_bounds


PLANS = {
    # the cells: K2 at G and D width, K3's walks, K4 train and decode, K1
    **{f"k2_g_b{B}": (k2, (B, 760, 257)) for B in (8, 16)},
    **{f"k2_d_b{B}": (k2, (B, 256, 40)) for B in (8, 16)},
    "k3_g_b32": (k2, (32, 760, 257, BF16, True)),
    **{f"k3_d_b{B}": (k3_rows, (B, 256, 40)) for B in (32, 64)},
    **{f"k4_g_b{B}": (k4, (B, 4, 760, 257)) for B in (8, 16, 32)},
    **{f"k1_d_b{B}": (k1_rows, (B, 256, 40)) for B in (8, 16, 32, 64)},
    # the tools: K4 at D width and at the lstm G's stack, K1 at G width
    # on every plan time_k1_plans.py times, K3's resident walk to 256 rows
    **{f"k4_d_b{B}": (k4, (B, 2, 256, 40)) for B in (16, 32)},
    "k4_lstm_b16": (k4, (16, 3, 760, 280)),
    **{f"k1_g_{n}": (k4, (16, 1, 760, 257, BF16, n)) for n in NBL},
    "k1_g_default_f32": (k4, (16, 1, 760, 257, F32)),
    **{f"k3_g_b{B}": (k2, (B, 760, 257, BF16, True)) for B in (64, 256)},
    "k2_odd": (k2, (3, 13, 9, F32)),
}


@pytest.mark.parametrize("case", PLANS)
def test_cached_constants_equal_the_loop(constants, case):
    make, args = PLANS[case]
    plan, index, values = make(*args)
    if index is not None:
        got = resident.unit_index(*index, CPU)
        assert got.dtype == torch.int64
        assert torch.equal(got, loop_unit_index(*index))
    got = resident.upload_int32(values, CPU)
    assert torch.equal(got, torch.tensor(values, dtype=torch.int32))


@pytest.mark.parametrize("kind", ["unit_index", "int32"])
def test_the_same_key_returns_the_same_tensor(constants, kind):
    plan = ls.resident_plan(16, 760, 257, BF16, SMS)
    if kind == "unit_index":
        def get():
            return resident.unit_index(plan.unit_bounds, plan.NU, 760, CPU)
    else:
        def get():
            return resident.upload_int32(list(plan.unit_bounds), CPU)
    first = get()
    assert get() is first and get() is first
    r = spans.read()
    assert (r.total("launch.setup_miss"), r.total("launch.setup_hit")) == (
        1, 2)


BOUNDS = (0, 3, 5, 8)
OTHER_KEYS = {
    "bounds": dict(bounds=(0, 2, 5, 8)),
    "width": dict(width=4),
    "pad": dict(pad=9),
    "device": dict(device=META),
}


@pytest.mark.parametrize("change", OTHER_KEYS)
def test_another_index_key_gets_its_own_entry(constants, change):
    key = dict(bounds=BOUNDS, width=3, pad=8, device=CPU)
    first = resident.unit_index(**key)
    other = resident.unit_index(**{**key, **OTHER_KEYS[change]})
    assert other is not first
    assert resident.unit_index(**key) is first
    assert len(resident._CONSTANTS) == 2
    if change != "device":
        k = {**key, **OTHER_KEYS[change]}
        assert torch.equal(other, loop_unit_index(k["bounds"], k["width"],
                                                  k["pad"]))


@pytest.mark.parametrize("change", ["values", "device", "index_key"])
def test_another_int32_key_gets_its_own_entry(constants, change):
    first = resident.upload_int32(BOUNDS, CPU)
    if change == "values":
        other = resident.upload_int32((0, 3, 5, 9), CPU)
    elif change == "device":
        other = resident.upload_int32(BOUNDS, META)
        assert other.device == META and other.dtype == torch.int32
    else:   # the same ints as an index's bounds are another entry
        other = resident.unit_index(BOUNDS, 3, 8, CPU)
    assert other is not first and len(resident._CONSTANTS) == 2
    assert resident.upload_int32(BOUNDS, CPU) is first


def test_an_explicit_plan_gets_its_own_entry(constants):
    """A tool's plan (``_launch_resident(plan=...)``) with other bounds
    than the default plan of its shape: its own index and bounds."""
    default = wf.resident_plan(16, 1, 760, 257, BF16, SMS)
    tool = wf.resident_plan(16, 1, 760, 257, BF16, SMS, nbl=64)
    assert tool.unit_bounds != default.unit_bounds
    a, b = (resident.unit_index(p.unit_bounds, p.NU, 760, CPU)
            for p in (default, tool))
    assert a is not b
    assert torch.equal(b, loop_unit_index(tool.unit_bounds, tool.NU, 760))
    c, d = (resident.upload_int32(p.unit_bounds + p.pair_bounds, CPU)
            for p in (default, tool))
    assert c is not d and len(resident._CONSTANTS) == 4


@pytest.mark.parametrize("device", [CPU, META])
def test_setup_counts_one_miss_then_hits(constants, device):
    """The first call of a key builds and copies (one ``launch.setup_miss``,
    one ``launch.upload`` span, and off the CPU one ``host_wait``); every
    later call is a ``launch.setup_hit`` and copies nothing."""
    for _ in range(4):
        resident.unit_index(BOUNDS, 3, 8, device)
        resident.upload_int32(BOUNDS, device)
    r = spans.read()
    assert r.total("launch.setup_miss") == 2
    assert r.total("launch.setup_hit") == 6
    assert r.units("launch.upload") == 2
    assert r.total("host_wait") == (0 if device == CPU else 2)


def test_packing_on_a_device_copies_once_per_shape(constants):
    """K2's and K4's weight packing on a device other than the CPU: the
    first packing of a shape copies its unit index (one ``host_wait``),
    a repeat copies nothing; another shape copies its own."""
    def k2_pack(U, P):
        plan = ls.resident_plan(16, U, P, BF16, SMS)
        ls.pack_bwd_weights(torch.empty((P, 4 * U), dtype=BF16, device=META),
                            torch.empty((U, P), dtype=BF16, device=META),
                            plan)

    def k4_pack():
        plan = wf.resident_plan(8, 2, 256, 40, BF16, SMS)
        w = dict(dtype=BF16, device=META)
        wf.pack_wavefront_weights(torch.empty((1, 40, 1024), **w),
                                  torch.empty((2, 40, 1024), **w),
                                  torch.empty((2, 256, 40), **w), plan)

    waits = []
    for pack in (lambda: k2_pack(760, 257), lambda: k2_pack(760, 257),
                 k4_pack, k4_pack, lambda: k2_pack(256, 40)):
        before = spans.read().total("host_wait")
        pack()
        waits.append(spans.read().total("host_wait") - before)
    assert waits == [1, 0, 1, 0, 1]


# ---------------------------------------------------------------------------
# the memoised plans
# ---------------------------------------------------------------------------

WIDTHS = [(760, 257), (256, 40), (760, 280), (13, 9)]
ROWS = (1, 8, 16, 32, 64, 256)


def plan_calls(fn, U, P, dtype):
    """(args, kwargs) of ``fn`` over rows, SM counts and its own knobs."""
    for B in ROWS:
        for sms in (SMS, 114):
            if fn is ls.resident_plan:
                for acc in (False, True):
                    yield (B, U, P, dtype, sms, acc), {}
            elif fn is wf.resident_plan:
                for L in (1, 2, 4):
                    yield (B, L, U, P, dtype, sms), {}
                yield (B, 1, U, P, dtype, sms), {"nbl": 48}
            elif fn is ls.wgrad_plan:
                yield (200 if dtype == F32 else 600, B, U, P, sms), {}
            elif fn is ls.rowgroup_bwd_route:
                yield (B, U, P, sms), {}
            else:
                yield (B, U, P, dtype, sms), {}


MEMOISED = {"k2_k3": ls.resident_plan, "k1_rows": ls.rowgroup_plan,
            "k3_rows": ls.rowgroup_bwd_plan, "k3_route": ls.rowgroup_bwd_route,
            "wgrad": ls.wgrad_plan, "k4": wf.resident_plan}


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("U,P", WIDTHS)
@pytest.mark.parametrize("name", MEMOISED)
def test_memoised_plan_equals_a_fresh_call(name, U, P, dtype):
    fn = MEMOISED[name]
    for args, kwargs in plan_calls(fn, U, P, dtype):
        try:
            fresh = fn.__wrapped__(*args, **kwargs)
        except ValueError:
            with pytest.raises(ValueError):
                fn(*args, **kwargs)
            continue
        got = fn(*args, **kwargs)
        assert got == fresh, (name, args, kwargs)
        assert fn(*args, **kwargs) is got


def test_packing_leaves_the_shared_plans_as_they_were():
    """Every packer reads its plan and writes none of it: the memoised
    plans still equal fresh ones after packing on the CPU."""
    g = torch.Generator().manual_seed(0)

    def w(*shape):
        return torch.rand(shape, generator=g)

    U, P = 13, 9
    plans = {ls.pack_bwd_weights: ((3, U, P, F32, SMS), ls.resident_plan),
             ls.pack_fwd_weights: ((3, U, P, F32, SMS), ls.rowgroup_plan),
             ls.pack_bwd_rowgroup_weights: ((3, U, P, F32, SMS),
                                            ls.rowgroup_bwd_plan)}
    for pack, (args, fn) in plans.items():
        plan = fn(*args)
        pack(w(P, 4 * U), w(U, P), plan)
        assert plan == fn.__wrapped__(*args)
        assert dataclasses.asdict(plan) == dataclasses.asdict(
            fn.__wrapped__(*args))
    plan = wf.resident_plan(3, 2, U, P, F32, SMS)
    wf.pack_wavefront_weights(w(1, P, 4 * U), w(2, P, 4 * U), w(2, U, P),
                              plan)
    assert plan == wf.resident_plan.__wrapped__(3, 2, U, P, F32, SMS)
