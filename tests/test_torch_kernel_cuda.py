"""The CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA GPU and nvcc (marker ``cuda``) and skips
elsewhere. The file imports torch and the port only, so it runs where
there is no jax; ``tests/conftest.py`` imports jax, so on such a machine
run it without the conftest:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_kernel_cuda.py
"""

import numpy as np
import pytest
import torch

from rsrgan_tpu_torch.ops import _build
from rsrgan_tpu_torch.ops.wavefront import (lstm_wavefront_fwd,
                                            lstm_wavefront_fwd_reference)
from rsrgan_tpu_torch.ops.wavefront_stack import _prep

torch.set_num_threads(1)

# odd sizes: U, P not multiples of the kernel's 32-wide tiles, B not a
# multiple of its 8-row chunks, a row of length 0
T, U, P = 17, 13, 9
LENS = [17, 11, 0]
B = len(LENS)
# f32: kernel and twin differ only in summation order. bf16: both round
# the same operands, but one flipped bf16 rounding (2^-8 relative) can
# propagate through the recurrence.
ATOL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available() or _build.find_nvcc() is None:
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def kernel_args(L, cdt, device, seed=0, rows=B):
    """Kernel arguments as lstm_stack_wavefront prepares them."""
    rng = np.random.default_rng(seed)
    lens = (LENS * rows)[:rows]

    def u(*shape):
        return torch.tensor(rng.uniform(-0.5, 0.5, shape),
                            dtype=torch.float32)

    params = [{"kernel": u(2 * P, 4 * U), "bias": u(4 * U),
               "proj_kernel": u(U, P), "w_i_diag": u(1, U),
               "w_f_diag": u(1, U), "w_o_diag": u(1, U)}
              for _ in range(L)]
    x = torch.tensor(rng.normal(size=(T, rows, P)), dtype=torch.float32)
    wx, wh, bias, proj, wi, wf, wo = _prep(params, P, 1.0)
    wx, wh, proj = (a.to(cdt).contiguous() for a in (wx, wh, proj))
    xw1 = torch.matmul(x, wx[0].float()).to(cdt)
    args = (xw1, torch.tensor(lens, dtype=torch.int32), x,
            wx[1:].contiguous(), wh, proj, bias, wi.contiguous(),
            wf.contiguous(), wo.contiguous())
    return tuple(a.to(device) for a in args)


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,residual", [(4, True), (3, False), (1, True)])
def test_kernel_matches_twin(cuda_device, cdt, L, residual):
    args = kernel_args(L, cdt, cuda_device)
    before = lstm_wavefront_fwd.launches
    got = lstm_wavefront_fwd(*args, residual=residual)
    want = lstm_wavefront_fwd_reference(*args, residual=residual)
    torch.cuda.synchronize()
    assert lstm_wavefront_fwd.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=ATOL[cdt])


@pytest.mark.cuda
def test_kernel_rejects_bad_arguments(cuda_device):
    args = list(kernel_args(4, torch.float32, cuda_device))
    args[1] = args[1].long()  # lengths must be int32
    with pytest.raises(ValueError, match="lengths"):
        lstm_wavefront_fwd(*args)


@pytest.mark.cuda
def test_cuda_launch_raises_without_library(cuda_device, monkeypatch,
                                            tmp_path):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_LIBS", {})
    args = kernel_args(4, torch.float32, cuda_device)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        lstm_wavefront_fwd(*args)


# ---------------------------------------------------------------------------
# the training kernels: K4 in train mode, K1, K2, K3
# ---------------------------------------------------------------------------

def layer_args(B_, cdt, device, seed=1):
    """(xw, lengths, w_h, proj, bias, wi, wf, wo) for one layer."""
    rng = np.random.default_rng(seed)

    def u(*shape):
        return torch.tensor(rng.uniform(-0.5, 0.5, shape),
                            dtype=torch.float32)

    lens = (LENS * B_)[:B_]
    xw = torch.tensor(rng.normal(0, 0.5, (T, B_, 4 * U)),
                      dtype=torch.float32).to(cdt)
    args = (xw, torch.tensor(lens, dtype=torch.int32), u(P, 4 * U).to(cdt),
            u(U, P).to(cdt), u(4 * U), u(U), u(U), u(U))
    return tuple(a.to(device) for a in args)


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,residual", [(4, True), (3, False)])
def test_train_mode_matches_twin(cuda_device, cdt, L, residual):
    from rsrgan_tpu_torch.ops.wavefront import lstm_wavefront_fwd_train
    args = kernel_args(L, cdt, cuda_device)
    before = lstm_wavefront_fwd_train.launches
    got = lstm_wavefront_fwd_train(*args, residual=residual)
    want = lstm_wavefront_fwd_reference(*args, residual=residual,
                                        save_acts=True)
    torch.cuda.synchronize()
    assert lstm_wavefront_fwd_train.launches == before + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), atol=ATOL[cdt])


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B_", [3, 33])
def test_layer_kernels_match_twins(cuda_device, cdt, B_):
    """K1, then K2 and K3 on K1's streams, stream by stream. Gradient
    streams and weight gradients grow with the sums over T*B rows, so
    they are compared relative to their largest value."""
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    args = layer_args(B_, cdt, cuda_device)
    counts = (ls.lstm_fwd.launches, ls.lstm_bwd.launches,
              ls.lstm_bwd_acc.launches)
    fwd = ls.lstm_fwd(*args)
    for g, w in zip(fwd, ls.lstm_fwd_reference(*args)):
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), atol=ATOL[cdt])
    out, c, h, acts = fwd
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(2)
                       ).to(cuda_device)
    common = (acts, args[1], dout, c)
    weights = args[2:4] + args[5:]
    for got, want in ((ls.lstm_bwd(*common, *weights),
                       ls.lstm_bwd_reference(*common, *weights)),
                      (ls.lstm_bwd_acc(*common, h, *weights),
                       ls.lstm_bwd_acc_reference(*common, h, *weights))):
        for g, w in zip(got, want):
            g, w = g.float().cpu().numpy(), w.float().cpu().numpy()
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(g, w, atol=ATOL[cdt] * scale)
    torch.cuda.synchronize()
    assert (ls.lstm_fwd.launches, ls.lstm_bwd.launches,
            ls.lstm_bwd_acc.launches) == tuple(n + 1 for n in counts)


@pytest.mark.cuda
def test_backward_rejects_bad_arguments(cuda_device):
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    args = layer_args(3, torch.float32, cuda_device)
    out, c, h, acts = ls.lstm_fwd(*args)
    with pytest.raises(ValueError, match="dout"):
        ls.lstm_bwd(acts, args[1], out.double(), c, *args[2:4], *args[5:])


# ---------------------------------------------------------------------------
# the resident kernels (csrc/resident.cu): K4 both modes and K2
# ---------------------------------------------------------------------------

def assert_close(got, want, cdt):
    for g, w in zip(got, want):
        g, w = g.float().cpu().numpy(), w.float().cpu().numpy()
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, atol=ATOL[cdt] * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 33, 64])
@pytest.mark.parametrize("L,residual", [(1, False), (3, False), (4, True)])
def test_resident_wavefront_batches(cuda_device, cdt, rows, L, residual):
    """K4 in both modes at B = 1, 33 and 64 (one, three and four 16-row
    tiles), with a zero-length row; two launches give the same bits."""
    from rsrgan_tpu_torch.ops.wavefront import lstm_wavefront_fwd_train
    args = kernel_args(L, cdt, cuda_device, rows=rows)
    for fn, save in ((lstm_wavefront_fwd, False),
                     (lstm_wavefront_fwd_train, True)):
        got = fn(*args, residual=residual)
        want = lstm_wavefront_fwd_reference(*args, residual=residual,
                                            save_acts=save)
        got, want = ((got,), (want,)) if not save else (got, want)
        assert_close(got, want, cdt)
        again = fn(*args, residual=residual)
        again = (again,) if not save else again
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_resident_wavefront_raises_for_shapes_it_cannot_hold(cuda_device):
    """4096 rows need more staging than a block's shared memory: the
    wrapper raises with the shape, and nothing runs in its place."""
    args = kernel_args(1, torch.bfloat16, cuda_device, rows=4096)
    before = lstm_wavefront_fwd.launches
    with pytest.raises(ValueError, match="B=4096 L=1"):
        lstm_wavefront_fwd(*args, residual=False)
    assert lstm_wavefront_fwd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B_,U_", [(1, 13), (33, 13), (64, 13), (16, 200)])
def test_resident_lstm_bwd(cuda_device, cdt, B_, U_):
    """K2 at odd batches and at U=200 (units that do not divide the
    grid), on its forward twin's streams; two launches give the same
    bits."""
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    rng = np.random.default_rng(4)

    def u(*shape):
        return torch.tensor(rng.uniform(-0.5, 0.5, shape),
                            dtype=torch.float32, device=cuda_device)

    lens = torch.tensor((LENS * B_)[:B_], dtype=torch.int32,
                        device=cuda_device)
    xw = torch.tensor(rng.normal(0, 0.5, (T, B_, 4 * U_)),
                      dtype=torch.float32, device=cuda_device).to(cdt)
    w_h, proj = u(P, 4 * U_).to(cdt), u(U_, P).to(cdt)
    bias, wi, wf, wo = u(4 * U_), u(U_), u(U_), u(U_)
    _, c, _, acts = ls.lstm_fwd_reference(xw, lens, w_h, proj, bias, wi, wf,
                                          wo)
    dout = u(T, B_, P)
    args = (acts, lens, dout, c, w_h, proj, wi, wf, wo)
    got = ls.lstm_bwd(*args)
    assert_close(got, ls.lstm_bwd_reference(*args), cdt)
    assert all(torch.equal(a, b) for a, b in zip(got, ls.lstm_bwd(*args)))


# ---------------------------------------------------------------------------
# K1's row-group kernel (csrc/resident.cu)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 3, 17, 33, 64])
@pytest.mark.parametrize("U_,P_", [(13, 9), (200, 40)])
@pytest.mark.parametrize("save_acts", [True, False])
def test_rowgroup_lstm_fwd(cuda_device, cdt, rows, U_, P_, save_acts):
    """K1 against its twin at 1-64 rows (one to four row groups, ragged
    groups at 17 and 33), odd U and P, a zero-length row, with and without
    the saved streams; one launch counted per call; two launches give the
    same bits."""
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    rng = np.random.default_rng(rows + U_)
    # Glorot's scale, as the model's layers: at U=200 the ±0.5 weights of
    # the other tests make the 17-step recurrence amplify f32 rounding
    # beyond 1e-5 in the twin itself
    scale = min(0.5, (6 / (4 * U_ + P_)) ** 0.5)

    def u(*shape):
        return torch.tensor(rng.uniform(-scale, scale, shape),
                            dtype=torch.float32, device=cuda_device)

    lens = torch.tensor((LENS * rows)[:rows], dtype=torch.int32,
                        device=cuda_device)
    xw = torch.tensor(rng.normal(0, 0.5, (T, rows, 4 * U_)),
                      dtype=torch.float32, device=cuda_device).to(cdt)
    args = (xw, lens, u(P_, 4 * U_).to(cdt), u(U_, P_).to(cdt), u(4 * U_),
            u(U_), u(U_), u(U_))
    before = ls.lstm_fwd.launches
    got = ls.lstm_fwd(*args, save_acts=save_acts)
    assert ls.lstm_fwd.launches == before + 1
    want = ls.lstm_fwd_reference(*args, save_acts=save_acts)
    if not save_acts:
        assert got[1:] == (None, None, None)
        got, want = got[:1], want[:1]
    assert_close(got, want, cdt)
    again = ls.lstm_fwd(*args, save_acts=save_acts)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_rowgroup_lstm_fwd_g_width(cuda_device, cdt):
    """K1's row-group kernel at G's width (U=760, P=257), where the packed
    weights only partly fit in shared memory and the rest is read from
    global memory (``lstm_fwd`` takes the resident route there: the
    row-group kernel is launched directly)."""
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    U_, P_, rows = 760, 257, 16
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert not ls.rowgroup_plan(rows, U_, P_, cdt, sms).weights_resident()
    rng = np.random.default_rng(5)

    def u(*shape, scale=0.05):
        return torch.tensor(rng.uniform(-scale, scale, shape),
                            dtype=torch.float32, device=cuda_device)

    lens = torch.tensor((LENS * rows)[:rows], dtype=torch.int32,
                        device=cuda_device)
    args = (u(T, rows, 4 * U_, scale=1.0).to(cdt), lens,
            u(P_, 4 * U_).to(cdt), u(U_, P_).to(cdt), u(4 * U_), u(U_),
            u(U_), u(U_))
    got = ls._launch_fwd_rowgroup(*args, save_acts=True)
    assert_close(got, ls.lstm_fwd_reference(*args), cdt)
    assert all(torch.equal(a, b) for a, b in
               zip(got, ls._launch_fwd_rowgroup(*args, save_acts=True)))


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 3, 16, 33, 64])
def test_rowgroup_lstm_fwd_g_width_rows(cuda_device, cdt, rows):
    """K1 at G's width (U=760, P=257) as dropout runs it, at 1, 3, 16
    (B=16), 33 and 64 rows, each with a zero-length row among them (LENS),
    Glorot-scaled weights: ``lstm_fwd`` takes the resident route, one
    launch counted per call in total and by route; the row-group kernel
    (one row a block), launched directly, holds to the same twin; two
    launches give the same bits."""
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    U_, P_ = 760, 257
    rng = np.random.default_rng(40 + rows)
    scale = (6 / (4 * U_ + P_)) ** 0.5

    def u(*shape, s=scale):
        return torch.tensor(rng.uniform(-s, s, shape), dtype=torch.float32,
                            device=cuda_device)

    lens = torch.tensor(([0, 17, 11] * rows)[:rows] if rows > 1 else [17],
                        dtype=torch.int32, device=cuda_device)
    args = (u(T, rows, 4 * U_, s=1.0).to(cdt), lens, u(P_, 4 * U_).to(cdt),
            u(U_, P_).to(cdt), u(4 * U_), u(U_), u(U_), u(U_))
    before = ls.lstm_fwd.launches
    resident_before = ls.lstm_fwd.launches_by_route.get("resident", 0)
    got = ls.lstm_fwd(*args)
    assert ls.lstm_fwd.launches == before + 1
    assert ls.lstm_fwd.launches_by_route["resident"] == resident_before + 1
    want = ls.lstm_fwd_reference(*args)
    assert_close(got, want, cdt)
    assert all(torch.equal(a, b) for a, b in zip(got, ls.lstm_fwd(*args)))
    rowgroup = ls._launch_fwd_rowgroup(*args, save_acts=True)
    assert_close(rowgroup, want, cdt)
    assert all(torch.equal(a, b) for a, b in zip(
        rowgroup, ls._launch_fwd_rowgroup(*args, save_acts=True)))


# ---------------------------------------------------------------------------
# K1 on K4's resident grid at L = 1 (fwd_route's "resident")
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 3, 33, 64])
@pytest.mark.parametrize("U_,P_", [(200, 40), (13, 9)])
@pytest.mark.parametrize("save_acts", [True, False])
def test_resident_lstm_fwd(cuda_device, cdt, rows, U_, P_, save_acts):
    """K1's resident route launched directly at odd shapes (U=200 over
    132 blocks, U=13 over 13; P=9 and 40, so K = P padded to 16 or 48 at
    L = 1, not 2P), 1-64 rows with a zero-length row, with and without
    the saved streams; two launches give the same bits."""
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    from rsrgan_tpu_torch.ops import resident
    from rsrgan_tpu_torch.ops import wavefront as wf
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = wf.resident_plan(rows, 1, U_, P_, cdt, sms)
    assert plan.Kp == resident.round_up(P_, 16) < resident.round_up(2 * P_,
                                                                     16)
    rng = np.random.default_rng(60 + rows + U_)
    scale = min(0.5, (6 / (4 * U_ + P_)) ** 0.5)

    def u(*shape, s=scale):
        return torch.tensor(rng.uniform(-s, s, shape), dtype=torch.float32,
                            device=cuda_device)

    lens = torch.tensor((LENS * rows)[:rows], dtype=torch.int32,
                        device=cuda_device)
    args = (u(T, rows, 4 * U_, s=1.0).to(cdt), lens, u(P_, 4 * U_).to(cdt),
            u(U_, P_).to(cdt), u(4 * U_), u(U_), u(U_), u(U_))
    got = ls._launch_fwd_resident(*args, save_acts=save_acts)
    want = ls.lstm_fwd_reference(*args, save_acts=save_acts)
    if not save_acts:
        assert got[1:] == (None, None, None)
        got, want = got[:1], want[:1]
    assert_close(got, want, cdt)
    again = ls._launch_fwd_resident(*args, save_acts=save_acts)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("U_,P_,route", [(256, 40, "rowgroup"),
                                         (760, 257, "resident"),
                                         (760, 280, "resident")])
@pytest.mark.parametrize("save_acts", [True, False])
def test_lstm_fwd_counts_its_route(cuda_device, cdt, U_, P_, route,
                                   save_acts):
    """``lstm_fwd`` at the D and G widths, 16 rows: the route
    ``fwd_route`` names, one launch counted in total, by shape and by
    that route; the result held against the twin."""
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    rows = 16
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert ls.fwd_route(rows, U_, P_, cdt, sms) == route
    rng = np.random.default_rng(U_ + P_)
    scale = (6 / (4 * U_ + P_)) ** 0.5

    def u(*shape, s=scale):
        return torch.tensor(rng.uniform(-s, s, shape), dtype=torch.float32,
                            device=cuda_device)

    lens = torch.tensor((LENS * rows)[:rows], dtype=torch.int32,
                        device=cuda_device)
    args = (u(T, rows, 4 * U_, s=1.0).to(cdt), lens, u(P_, 4 * U_).to(cdt),
            u(U_, P_).to(cdt), u(4 * U_), u(U_), u(U_), u(U_))
    key = ls.shape_key(args[3], rows)
    before = (ls.lstm_fwd.launches, ls.lstm_fwd.launches_by_shape.get(key, 0),
              dict(ls.lstm_fwd.launches_by_route))
    got = ls.lstm_fwd(*args, save_acts=save_acts)
    assert ls.lstm_fwd.launches == before[0] + 1
    assert ls.lstm_fwd.launches_by_shape[key] == before[1] + 1
    want_routes = dict(before[2])
    want_routes[route] = want_routes.get(route, 0) + 1
    assert ls.lstm_fwd.launches_by_route == want_routes
    want = ls.lstm_fwd_reference(*args, save_acts=save_acts)
    n = 4 if save_acts else 1
    assert_close(got[:n], want[:n], cdt)


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_train_mode_lstm_generator_width(cuda_device, cdt):
    """K4 in train mode at LstmGenerator's stack: L=3, U=760, P=280,
    residual off, B=16 with a zero-length row; every saved stream against
    the twin."""
    from rsrgan_tpu_torch.ops.wavefront import lstm_wavefront_fwd_train
    L_, U_, P_, rows = 3, 760, 280, 16
    rng = np.random.default_rng(50)
    scale = (6 / (4 * U_ + 2 * P_)) ** 0.5

    def u(*shape):
        return torch.tensor(rng.uniform(-scale, scale, shape),
                            dtype=torch.float32)

    params = [{"kernel": u(2 * P_, 4 * U_), "bias": u(4 * U_),
               "proj_kernel": u(U_, P_), "w_i_diag": u(1, U_),
               "w_f_diag": u(1, U_), "w_o_diag": u(1, U_)}
              for _ in range(L_)]
    x = torch.tensor(rng.normal(size=(T, rows, P_)), dtype=torch.float32)
    wx, wh, bias, proj, wi, wf, wo = _prep(params, P_, 1.0)
    wx, wh, proj = (a.to(cdt).contiguous() for a in (wx, wh, proj))
    xw1 = torch.matmul(x, wx[0].float()).to(cdt)
    args = tuple(a.to(cuda_device) for a in (
        xw1, torch.tensor((LENS * rows)[:rows], dtype=torch.int32), x,
        wx[1:].contiguous(), wh, proj, bias, wi.contiguous(),
        wf.contiguous(), wo.contiguous()))
    before = lstm_wavefront_fwd_train.launches
    got = lstm_wavefront_fwd_train(*args, residual=False)
    assert lstm_wavefront_fwd_train.launches == before + 1
    want = lstm_wavefront_fwd_reference(*args, residual=False,
                                        save_acts=True)
    torch.cuda.synchronize()
    assert_close(got, want, cdt)


# ---------------------------------------------------------------------------
# K3: the row-group walk and its reduction (csrc/resident.cu), K2's
# resident walk in acc mode and the reduction (G width), and the streaming
# kernel (csrc/lstm_bwd.cu)
# ---------------------------------------------------------------------------

def bwd_acc_args(device, cdt, rows, U_, P_, seed):
    """K3's inputs on its forward twin's streams, Glorot-scaled weights."""
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    rng = np.random.default_rng(seed)
    scale = min(0.5, (6 / (4 * U_ + P_)) ** 0.5)

    def u(*shape):
        return torch.tensor(rng.uniform(-scale, scale, shape),
                            dtype=torch.float32, device=device)

    lens = torch.tensor((LENS * rows)[:rows], dtype=torch.int32,
                        device=device)
    xw = torch.tensor(rng.normal(0, 0.5, (T, rows, 4 * U_)),
                      dtype=torch.float32, device=device).to(cdt)
    w_h, proj = u(P_, 4 * U_).to(cdt), u(U_, P_).to(cdt)
    bias, wi, wf, wo = u(4 * U_), u(U_), u(U_), u(U_)
    _, c, h, acts = ls.lstm_fwd_reference(xw, lens, w_h, proj, bias, wi, wf,
                                          wo)
    dout = torch.tensor(rng.normal(size=(T, rows, P_)), dtype=torch.float32,
                        device=device)
    return acts, lens, dout, c, h, w_h, proj, wi, wf, wo


def k3_counts(ls):
    """K3's launches by route: row-group, resident, streaming."""
    return (ls.lstm_bwd_acc.launches, ls.lstm_bwd_acc.resident_launches,
            ls.lstm_bwd_acc.streaming_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 3, 17, 33, 64])
@pytest.mark.parametrize("U_,P_", [(13, 9), (200, 40)])
def test_rowgroup_lstm_bwd_acc(cuda_device, cdt, rows, U_, P_):
    """K3 against its twin, all seven outputs, at 1-64 rows, odd U and P
    and a zero-length row: each call launches the row-group walk and its
    reduction (one count), and two launches give the same bits."""
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    args = bwd_acc_args(cuda_device, cdt, rows, U_, P_, rows + U_)
    before = k3_counts(ls)
    got = ls.lstm_bwd_acc(*args)
    assert k3_counts(ls) == (before[0] + 1, before[1], before[2])
    assert_close(got, ls.lstm_bwd_acc_reference(*args), cdt)
    again = ls.lstm_bwd_acc(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_lstm_bwd_acc_g_width_streams(cuda_device, cdt):
    """At G's width (U=760, P=257), B=32, K3 takes K2's resident walk in
    acc mode and the reduction (one count), whose relaunch gives the same
    bits; csrc/lstm_bwd.cu, the route of shapes no resident plan holds,
    agrees with the twin on the same inputs."""
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    args = bwd_acc_args(cuda_device, cdt, 32, 760, 257, 9)
    before = k3_counts(ls)
    got = ls.lstm_bwd_acc(*args)
    assert k3_counts(ls) == (before[0], before[1] + 1, before[2])
    want = ls.lstm_bwd_acc_reference(*args)
    assert_close(got, want, cdt)
    assert all(torch.equal(a, b) for a, b in zip(got, ls.lstm_bwd_acc(*args)))
    assert_close(ls._launch_bwd(*args, acc=True), want, cdt)


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [32, 33, 64])
@pytest.mark.parametrize("U_,P_", [(13, 9), (200, 40)])
def test_resident_lstm_bwd_acc(cuda_device, cdt, rows, U_, P_):
    """K3's resident route called directly at odd shapes (units that do not
    divide the grid, P and 4U not multiples of the reduction's tiles), a
    zero-length row: all seven outputs against the twin, and a relaunch
    gives the same bits."""
    from rsrgan_tpu_torch.ops import lstm_seq as ls
    args = bwd_acc_args(cuda_device, cdt, rows, U_, P_, 2 * rows + U_)
    got = ls._launch_bwd_resident_acc(*args)
    assert_close(got, ls.lstm_bwd_acc_reference(*args), cdt)
    again = ls._launch_bwd_resident_acc(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
