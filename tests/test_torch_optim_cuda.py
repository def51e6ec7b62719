"""The fused optimizer update (``csrc/optim.cu``) against the plain path,
on the card.

Every test here needs an NVIDIA GPU and nvcc (marker ``cuda``) and skips
elsewhere. The file imports torch and the port only; on a machine without
jax run it without the conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_optim_cuda.py

Each case makes two states from the same parameters on the card, runs 3
updates through ``NetState.apply_gradients`` on the fused path and feeds
the plain path (``NetState.apply_plain``, the kernel's twin) the same
gradients clipped with the fused path's norms. Parameters, moments, Adam's count and the shadow must be
bit-equal; the norms must agree with the plain path's own to 1e-6
relative (the kernel sums in f64, PyTorch in f32). The updates after the
first must launch 2 kernels (1 without the clip and Adam's count) and a
copy for each strided gradient, copy nothing from pageable memory and
count no ``host_wait``; each parameter's version must rise. On the card
a bf16 leaf raises: nothing falls back to the plain path there.
"""

import pytest
import torch

from rsrgan_tpu_torch import spans
from rsrgan_tpu_torch.models import get_discriminator, get_generator
from rsrgan_tpu_torch.models.segan import SeganAEGenerator
from rsrgan_tpu_torch.ops import _build, optim
from rsrgan_tpu_torch.training.state import NetState

SEGAN_DEPTHS = [16, 32, 32, 64, 64, 128, 128, 256, 256, 512, 1024]

# (the net whose leaf shapes the case takes, optimizer, clip, the
# gradients' layout: their own tensors; views into one flat buffer, as
# all_reduce_mean returns them; a 3-D leaf's the reverse permutation of a
# contiguous tensor, as a convolution kernel's gradient is in flax's
# layout)
CASES = {
    "adam_res_lstm_l_g": ("res_lstm_l_g", "adam", 15.0, "own"),
    "adam_res_lstm_l_g_flat": ("res_lstm_l_g", "adam", 15.0, "flat"),
    "sgd_lstm_d": ("lstm_d", "sgd", 15.0, "own"),
    "rmsprop_segan_g": ("segan_g", "rmsprop", None, "conv"),
}
NETS = {
    "res_lstm_l_g": lambda: get_generator("res_lstm_l", input_dim=257,
                                          output_dim=40),
    "lstm_d": lambda: get_discriminator("lstm", input_dim=40),
    "segan_g": lambda: SeganAEGenerator(1799, 40, enc_depths=SEGAN_DEPTHS,
                                        bias_deconv=True),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available() or _build.find_nvcc() is None:
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda", torch.cuda.current_device())


def shapes(net):
    with torch.device("meta"):
        return [tuple(p.shape) for p in NETS[net]().parameters()]


def module(leaf_shapes, device):
    gen = torch.Generator(device=device).manual_seed(0)
    m = torch.nn.Module()
    for i, shape in enumerate(leaf_shapes):
        m.register_parameter(f"w{i}", torch.nn.Parameter(
            torch.randn(shape, generator=gen, device=device) * 0.05))
    return m


def gradients(ns, step, layout, device):
    """Leaf i's gradient: zero for the last leaf; its norm below the clip
    for every third leaf, above it for the rest; laid out as ``layout``
    says (``CASES``)."""
    gen = torch.Generator(device=device).manual_seed(1000 + step)
    params = list(ns.params().items())
    out = {}
    for i, (k, p) in enumerate(params):
        if layout == "conv" and p.dim() == 3:
            g = torch.randn(p.shape[::-1], generator=gen,
                            device=device).permute(2, 1, 0)
        else:
            g = torch.randn(p.shape, generator=gen, device=device)
        if i == len(params) - 1:
            g.zero_()
        elif i % 3 == 0:
            g *= 2.0 / max(p.numel(), 1) ** 0.5
        else:
            g *= 40.0 / max(p.numel(), 1) ** 0.5
        out[k] = g
    if layout == "flat":
        buf = torch.cat([g.reshape(-1) for g in out.values()])
        at = 0
        for k, g in out.items():
            out[k] = buf[at:at + g.numel()].view(g.shape)
            at += g.numel()
    return out


def plain_update(ns, grads, norms, max_norm):
    """The plain path's update of ``ns`` with the clip's norms given."""
    if max_norm is not None:
        grads = {k: g * (max_norm / torch.clamp(n, min=max_norm))
                 for (k, g), n in zip(grads.items(), norms)}
    ns.apply_plain(ns.params(), grads, 1e-3, 0.9999)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_fused_update_matches_the_plain_path(cuda_device, case):
    net, name, max_norm, layout = CASES[case]
    dev = cuda_device
    leaf_shapes = shapes(net)
    fused = NetState(module(leaf_shapes, dev), name, max_norm)
    plain = NetState(module(leaf_shapes, dev), name, None)
    assert optim.library().optim_sizes(2) == optim.block_bytes()
    n = len(leaf_shapes)
    assert n <= optim.SLOTS
    per_update = 2 if (max_norm is not None or name == "adam") else 1
    for step in range(3):
        grads = gradients(fused, step, layout, dev)
        # a strided gradient is first copied into its leaf's order
        copies = sum(not g.is_contiguous() for g in grads.values())
        assert (copies > 0) == (layout == "conv")
        versions = [p._version for p in fused.module.parameters()]
        counted = optim.FusedUpdate.launches
        spans.clear()
        spans.enable()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fused.apply_gradients(grads, 1e-3, 0.9999)
            torch.cuda.synchronize(dev)
        spans.disable()
        r = spans.read()
        assert r.total("opt.fused") == 1 and r.total("opt.plain") == 0
        assert optim.FusedUpdate.launches == counted + per_update
        assert all(p._version > v for p, v in
                   zip(fused.module.parameters(), versions))
        names = [e.key for e in prof.key_averages()]
        if step > 0:
            assert r.total("host_wait") == 0
            assert not [k for k in names if "Pageable" in k], names
            launches = sum(e.count for e in prof.key_averages()
                           if e.key.startswith(("cudaLaunch", "cuLaunch")))
            assert launches == per_update + copies, names
        norms = fused._fused_update.norms.clone()
        if max_norm is not None:
            want = torch.stack([torch.sqrt(torch.sum(torch.square(g)))
                                for g in grads.values()])
            torch.testing.assert_close(norms, want, rtol=1e-6, atol=0)
            under = [i % 3 == 0 for i in range(n - 1)]
            assert all((v < max_norm) == u
                       for v, u in zip(norms.tolist(), under))
            assert norms[-1] == 0
        plain_update(plain, grads, norms, max_norm)
        torch.cuda.synchronize(dev)
        for k, p in plain.params().items():
            assert torch.equal(fused.params()[k], p), (step, k)
            assert torch.equal(fused.ema[k], plain.ema[k]), (step, k)
            for field in ("mu", "nu"):
                if field in plain.opt_state:
                    assert torch.equal(fused.opt_state[field][k],
                                       plain.opt_state[field][k]), (
                        step, field, k)
        if name == "adam":
            assert (int(fused.opt_state["count"])
                    == int(plain.opt_state["count"]) == step + 1)


@pytest.mark.cuda
def test_a_leaf_the_kernel_does_not_take_raises_on_the_card(cuda_device):
    """A bf16 leaf of a state on the card: ``apply_gradients`` raises
    ValueError and updates nothing, where the CPU would take the plain
    path."""
    ns = NetState(module([(3, 4), (4,)], cuda_device), "adam", 15.0)
    ns.module.w1.data = ns.module.w1.data.to(torch.bfloat16)
    ns.ema["w1"] = ns.ema["w1"].to(torch.bfloat16)
    before = {k: p.clone() for k, p in ns.params().items()}
    with pytest.raises(ValueError, match="float32"):
        ns.apply_gradients({k: torch.ones_like(p) for k, p in
                            ns.params().items()}, 1e-3, 0.9)
    assert all(torch.equal(before[k], p) for k, p in ns.params().items())
    assert int(ns.opt_state["count"]) == 0
