"""SEGAN's plain reference (``benchmark/reference/segan.py``, loaded from
its file)
against the port's ``SeganTrainer`` on the CPU, in f32, at a small size
on seeded weights: W=64, encoder and D depths (4, 8, 8, 16) at the
recipe's widths 20 and 31, B=8.

The port convolves with ``F.conv1d`` / ``F.conv_transpose1d``, the
reference by unfolding each window into one product: the same sums in
another order, so the gaps are f32 rounding. Tolerances, each with its
reason:

* forwards, VBN statistics and D's losses: 1e-5 of the values' scale,
  the forward tolerance of ``tests/test_pallas_lstm.py:41-44``;
* G's losses: 1e-4, since they read D after its RMSProp step, whose
  first step divides each gradient by its own magnitude: an element
  whose gradient is near zero moves by its rounding over ``sqrt(1e-10)``;
* first gradients: 2e-4 of each leaf's scale, that file's gradient
  tolerance;
* for the same reason, one RMSProp step is held to the reference's
  formula applied to the port's own gradient (``-lr g / sqrt(0.1 g^2 +
  1e-10)``, in f64), within 1e-5 of the largest step (``lr /
  sqrt(0.1)``) and two f32 units in the last place of the parameter
  (or of a step, for a leaf that starts at zero);
* the EMA's change is 1e-4 of the step, within two such units.

Also: the reference's leaves are the port's (names and shapes), its
convolutions match the port's at strides and widths where "SAME" pads
unevenly, and it imports nothing of the port nor JAX.
"""

import ast
import importlib.util
import os
import subprocess
import sys

import pytest
import torch

from rsrgan_tpu_torch.models.segan import (SeganAEGenerator,
                                           SeganDiscriminator)
from rsrgan_tpu_torch.ops.modules import Conv1d, ConvTranspose1d
from rsrgan_tpu_torch.training.segan import SeganTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "benchmark", "reference", "segan.py")


def _load(path: str):
    spec = importlib.util.spec_from_file_location("segan_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load(REF)
W, U, DEPTHS, B = 64, 8, (4, 8, 8, 16), 8
LR = 1e-3
STEP = LR / 0.1 ** 0.5       # RMSProp's first step an element, at most


def config(noise_std: float = 0.1, g_nl: str = "leaky") -> dict:
    return {"generator": {"input_dim": W, "left_context": 0,
                          "right_context": 0, "output_dim": U,
                          "enc_depths": list(DEPTHS), "kwidth": 20,
                          "z_on": True, "g_nl": g_nl,
                          "bias_downconv": False, "bias_deconv": True},
            "discriminator": {"num_fmaps": list(DEPTHS), "kwidth": 31,
                              "bias_conv": True, "input_width": W + U},
            "hparams": {"g_lr": LR, "d_lr": LR, "disc_noise_std": noise_std,
                        "l1_weight": 100.0, "disc_updates": 1,
                        "gen_updates": 1, "ema_decay": 0.9999}}


def port(seed: int = 3, g_nl: str = "leaky"):
    gen = torch.Generator().manual_seed(seed)
    g = SeganAEGenerator(W, U, enc_depths=DEPTHS, bias_deconv=True,
                         do_prelu=g_nl == "prelu", generator=gen)
    if g_nl == "prelu":   # PReLU's alphas start at 0: give them a slope
        with torch.no_grad():
            for name, p in g.named_parameters():
                if "prelu" in name:
                    p.uniform_(0.1, 0.4, generator=gen)
    d = SeganDiscriminator(W + U, num_fmaps=DEPTHS, generator=gen)
    return g, d


def tree(module):
    return {k: v.detach().clone() for k, v in module.named_parameters()}


def batch(seed: int):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(B, W, generator=gen),
            torch.randn(B, U, generator=gen))


def draws(seed: int):
    gen = torch.Generator().manual_seed(seed)
    return lambda shape: torch.randn(shape, generator=gen)


def close(got, want, tol):
    """|got - want| <= tol times the larger of want's magnitude and 1e-3
    (the scale of a leaf or value)."""
    got = torch.as_tensor(got).detach().double()
    want = torch.as_tensor(want).detach().double()
    scale = max(float(want.abs().max()), 1e-3)
    assert float((got - want).abs().max()) <= tol * scale, (
        float((got - want).abs().max()), scale)


@pytest.mark.parametrize("g_nl", ["leaky", "prelu"])
def test_leaves_are_the_ports(g_nl):
    g, d = port(g_nl=g_nl)
    cfg = config(g_nl=g_nl)
    assert {k: tuple(v.shape) for k, v in g.named_parameters()} == \
        ref.g_shapes(cfg["generator"])
    assert {k: tuple(v.shape) for k, v in d.named_parameters()} == \
        ref.d_shapes(cfg["discriminator"])


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("k,stride,length", [
    (20, 2, 63), (31, 2, 72), (31, 1, 5), (5, 2, 1), (20, 2, 2), (3, 2, 9)])
def test_convolutions_match_the_ports(transposed, k, stride, length):
    """Even and odd widths, lengths that stride 2 does not divide, a
    length of 1: the reference's own "SAME" pads against the port's."""
    gen = torch.Generator().manual_seed(k * 100 + length)
    x = torch.randn(3, 4, length, generator=gen)
    m = (ConvTranspose1d(4, 5, k, stride, generator=gen) if transposed
         else Conv1d(4, 5, k, stride=stride, generator=gen))
    with torch.no_grad():
        m.bias.normal_(generator=gen)
    fn = ref.conv_transpose if transposed else ref.conv
    want = m(x)
    got = fn(x, m.kernel.detach(), m.bias.detach(), stride,
             ref.Products("f32"))
    assert got.shape == want.shape
    close(got, want, 1e-5)


@pytest.mark.parametrize("g_nl", ["leaky", "prelu"])
def test_forwards_and_vbn_statistics_match(g_nl):
    g, d = port(g_nl=g_nl)
    cfg = config(g_nl=g_nl)
    init = {"g": tree(g), "d": tree(d)}
    example, _ = batch(1)
    x, y = batch(2)
    tr = SeganTrainer(g, d, disc_updates=1, gen_updates=1)
    tr.init_state(example)
    prod = ref.Products("f32")
    stats = ref.vbn_stats(cfg, init, example, prod)
    for i, (mean, meansq) in enumerate(stats):
        vbn = getattr(d, f"d_vbn_{i}")
        close(vbn.ref_mean.reshape(-1), mean, 1e-5)
        close(vbn.ref_meansq.reshape(-1), meansq, 1e-5)
    with torch.no_grad():
        g_out = g(x, draws(7))
        close(g_out, ref.g_forward(init["g"], cfg["generator"], x,
                                   draws(7), prod), 1e-5)
        joint = torch.cat([x, y], dim=1)
        close(d(joint), ref.d_forward(init["d"], cfg["discriminator"],
                                      joint, stats, prod), 1e-5)
        # decode: z = 0
        close(tr.infer_step(None, x), ref.decode(cfg, init["g"], x), 1e-5)


@pytest.mark.parametrize("noise_std", [0.0, 0.1])
def test_train_step_matches(noise_std):
    """Every loss, every first gradient, one RMSProp step and the EMA of
    one iteration (1 D and 1 G update), z and D's noise the same draws."""
    g, d = port()
    cfg = config(noise_std)
    init = {"g": tree(g), "d": tree(d)}
    example, _ = batch(1)
    x, y = batch(2)
    tr = SeganTrainer(g, d, disc_updates=1, gen_updates=1)
    state = tr.init_state(example)
    tr.grad_log = []
    hp = {"g_lr": LR, "d_lr": LR, "disc_noise_std": noise_std,
          "l1_lambda": 100.0}
    got = tr.train_step(state, x, y, hp, torch.Generator().manual_seed(5))
    want = ref.train(cfg, init, example, [(x, y)], draws(5))
    assert set(got) == set(want["losses"][0])
    for k, v in got.items():
        close(v, want["losses"][0][k], 1e-5 if k.startswith("d_") else 1e-4)
    grads = dict(tr.grad_log)
    for net, module, ns in (("d", d, state.d), ("g", g, state.g)):
        for k, p in module.named_parameters():
            grad = grads[net][k].double()
            close(grad, want["grads"][net][k], 2e-4)
            ulp = 2 * 2 ** -23 * max(float(init[net][k].abs().max()), STEP)
            step = (p.detach() - init[net][k]).double()
            rms = -LR * grad / torch.sqrt(0.1 * grad * grad + 1e-10)
            assert float((step - rms).abs().max()) <= 1e-5 * STEP + ulp, k
            ema = (ns.ema[k] - init[net][k]).double()
            assert float((ema - 1e-4 * step).abs().max()) <= ulp, k


def test_control_precisions_round_the_operands():
    """TF32 keeps 10 bits of mantissa (to nearest, ties away from zero),
    bfloat16 7."""
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -11 + 2 ** -13,
                      -(1.0 + 3 * 2 ** -12), 1.0 + 2 ** -11])
    assert torch.equal(ref.round_tf32(x), torch.tensor(
        [1.0, 1.0 + 2 ** -10, -(1.0 + 2 ** -10), 1.0 + 2 ** -10]))
    assert torch.equal(ref.round_bf16(torch.tensor([1.0 + 2 ** -9])),
                       torch.tensor([1.0]))
    with pytest.raises(ValueError):
        ref.Products("fp8")


def test_reference_imports_nothing_of_the_port():
    tree_ = ast.parse(open(REF).read())
    names = set()
    for node in ast.walk(tree_):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "typing", "torch"}, names
    code = ("import importlib.util, sys; s = importlib.util."
            f"spec_from_file_location('segan_ref', {REF!r}); "
            "m = importlib.util.module_from_spec(s); s.loader.exec_module(m);"
            " print(sorted({n.split('.')[0] for n in sys.modules} & "
            "{'rsrgan_tpu_torch', 'rsrgan_tpu', 'jax', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd="/")
    assert out.stdout.strip() == "[]"


def test_g_backward_fault_rounds_only_gs_backward():
    """``g_backward="tf32"``: every forward in f32, so the first
    iteration's D step (its losses and D's first gradient) and G's L1
    loss are the f32 run's bit for bit; G's first gradient moves by TF32
    rounding, a few parts in 10^4, not more."""
    g, d = port()
    cfg = config(0.1)
    init = {"g": tree(g), "d": tree(d)}
    example, _ = batch(1)
    x, y = batch(2)
    f32 = ref.train(cfg, init, example, [(x, y)], draws(5))
    tf32 = ref.train(cfg, init, example, [(x, y)], draws(5),
                     g_backward="tf32")
    for k in ("d_rl_loss", "d_fk_loss", "d_loss", "g_l1_loss",
              "g_adv_loss"):
        assert tf32["losses"][0][k] == f32["losses"][0][k], k
    for k, v in f32["grads"]["d"].items():
        assert torch.equal(tf32["grads"]["d"][k], v), k
    moved = 0.0
    for k, v in f32["grads"]["g"].items():
        rel = float((tf32["grads"]["g"][k] - v).norm() / v.norm())
        assert rel < 2e-3, (k, rel)
        moved = max(moved, rel)
    assert moved > 1e-5


def test_g_step_gradients_do_not_depend_on_ds_requires_grad():
    """A G step asks autograd for G's gradients alone: with D's
    parameters out of the graph the gradients and the state after the
    step are the same, bit for bit."""
    outs = []
    for frozen in (False, True):
        g, d = port()
        tr = SeganTrainer(g, d, disc_updates=1, gen_updates=1)
        state = tr.init_state(batch(1)[0])
        tr.grad_log = []
        gen_step = SeganTrainer._g_losses

        def g_losses(self, *args, frozen=frozen):
            for p in self.discriminator.parameters():
                p.requires_grad_(not frozen)
            try:
                return gen_step(self, *args)
            finally:
                for p in self.discriminator.parameters():
                    p.requires_grad_(True)
        tr._g_losses = g_losses.__get__(tr)
        tr.train_step(state, *batch(2), {"g_lr": LR, "d_lr": LR,
                                         "disc_noise_std": 0.1,
                                         "l1_lambda": 100.0},
                      torch.Generator().manual_seed(5))
        outs.append((dict(tr.grad_log), tree(g), tree(d)))
    (grads, g0, d0), (grads1, g1, d1) = outs
    for net in ("d", "g"):
        for k, v in grads[net].items():
            assert torch.equal(v, grads1[net][k]), (net, k)
    for a, b in ((g0, g1), (d0, d1)):
        for k, v in a.items():
            assert torch.equal(v, b[k]), k


def test_d_first_puts_another_runs_d_before_the_first_g_step():
    """``d_first`` replaces D after the first iteration's D step: given
    the run's own D after that step, G's first gradient is the run's bit
    for bit; given a D moved by a millionth, it moves."""
    g, d = port()
    cfg = config(0.1)
    init = {"g": tree(g), "d": tree(d)}
    example, _ = batch(1)
    x, y = batch(2)
    plain = ref.train(cfg, init, example, [(x, y)], draws(5))
    d1 = plain["after1"]["d"]["params"]
    again = ref.train(cfg, init, example, [(x, y)], draws(5), d_first=d1)
    for k, v in plain["grads"]["g"].items():
        assert torch.equal(again["grads"]["g"][k], v), k
    moved = ref.train(cfg, init, example, [(x, y)], draws(5),
                      d_first={k: v * (1 + 1e-6) for k, v in d1.items()})
    assert any(not torch.equal(moved["grads"]["g"][k], v)
               for k, v in plain["grads"]["g"].items())
