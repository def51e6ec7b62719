"""Plain PyTorch reference of SEGAN's conv auto-encoder LSGAN as this
repository trains it (``recipes/run_segan.sh``), written from the
published description: Pascual, Bonafonte and Serrà, "SEGAN: Speech
Enhancement Generative Adversarial Network", Interspeech 2017, arXiv
1703.09452. It imports nothing of the port, and no convolution of the
library: each convolution is an unfold of the padded input followed by
one product with the kernel, and each transposed convolution the same
over the input with ``stride - 1`` zeros put between its positions.

G, per row: ``len(enc_depths)`` stride-2 "SAME" convolutions of
``kwidth`` (``enc_i``), each followed by LeakyReLU 0.3 (or PReLU,
``g_nl``); the latent z, N(0, 1) of depth ``enc_depths[-1]``, put before
the deepest code along the channels; then the mirrored stride-2
transposed convolutions (``dec_i``, depths ``enc_depths[-2::-1]`` and
1), each but the last cut to its skip's length, activated and
concatenated with that skip (the matching encoder layer's output before
its activation); the last one's single channel through a dense layer
(``dec_out``) to the frame's targets. D, per row of ``concat(input,
target)`` plus ``noise_std`` times N(0, 1): ``len(num_fmaps)`` stride-2
convolutions of ``kwidth`` (``d_block_i``), each followed by virtual
batch norm (``d_vbn_i``: the reference batch's mean and mean square,
taken once from the first training batch, blended ``1 / (B + 1)`` with
the live batch's, over rows and positions; ``(x - mean) / sqrt(1e-5 +
meansq - mean^2) * (1 + gamma) + beta``) and LeakyReLU 0.3, a
``kwidth`` convolution to one channel (``logits_conv``), then a dense
layer to one logit (``logits_out``). Losses: D ``mean((D(real) - 1)^2)
+ mean(D(fake)^2)``; G ``mean((D(fake) - 1)^2) + l1_weight *
mean|G - target|``. Each net: RMSProp (optax's ``scale_by_rms(0.9,
1e-10)``: ``nu = 0.1 g^2 + 0.9 nu``, ``p -= lr * g / sqrt(nu + 1e-10)``,
no clipping), then the EMA shadow ``e -= (1 - 0.9999) * (e - p)``. One
iteration: ``disc_updates`` D steps, each on a G output drawn anew
without gradient, then ``gen_updates`` G steps; z and D's noise are
drawn in that order (per D step z, the real rows' noise, the fake
rows'; per G step z, the fake rows' noise) from ``rand``, a callable
``shape -> tensor`` that hands in the program's own draws.

Where this departs from the paper, it follows the repository:

* the input is not a 16,384-sample waveform but one spliced frame of
  log-power spectra, ``(left + 1 + right) * input_dim`` values (7 x 257 =
  1,799 in the recipe) as a 1-channel signal, mapped to the frame's
  ``output_dim`` targets by ``dec_out``;
* G's convolutions are 20 wide (the paper's are 31), D's 31 as in the
  paper;
* D sees the input and the target side by side in one channel, not as
  two channels;
* the losses have no factor 1/2, and the L1 term is a mean;
* RMSProp at the recipe's rate, and an EMA of every parameter.

Products are f32 with TF32 off (``precision="f32"``), or, for a control,
their operands rounded to TF32's 10-bit mantissa (``"tf32"``) or to
bfloat16 (``"bf16"``), the gradient passing straight through. For a
fault of G's backward alone, ``train``'s ``g_backward`` rounds the
operands of the products that G's backward makes (the output's gradient
and the saved operand) and leaves every forward in f32.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

Tree = Dict[str, torch.Tensor]
Rand = Callable[[Tuple[int, ...]], torch.Tensor]
LEAKY = 0.3
VBN_EPS = 1e-5
RMS_DECAY, RMS_EPS = 0.9, 1e-10


def set_f32() -> None:
    """f32 products in f32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its mantissa rounded to TF32's 10 bits (to nearest, ties
    away from zero); the gradient passes straight through."""
    bits = t.detach().float().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return t + (r - t.detach())


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16; the gradient passes straight through."""
    return t + (t.detach().to(torch.bfloat16).float() - t.detach())


class _RoundedBackward(torch.autograd.Function):
    """``a @ w`` in f32, its backward's two products on operands rounded
    by ``rnd``."""

    @staticmethod
    def forward(ctx, a, w, rnd):
        ctx.save_for_backward(a, w)
        ctx.rnd = rnd
        return a @ w

    @staticmethod
    def backward(ctx, dy):
        a, w = ctx.saved_tensors
        rnd, dy = ctx.rnd, ctx.rnd(dy)
        return dy @ rnd(w).t(), rnd(a).t() @ dy, None


class Products:
    """The products of one precision: ``mm(a, w)``; ``backward``: the
    precision of the backward's products alone (the forward's f32)."""

    ROUND = {"f32": lambda t: t, "tf32": round_tf32, "bf16": round_bf16}

    def __init__(self, precision: str, backward: Optional[str] = None):
        for name in (precision, backward or precision):
            if name not in self.ROUND:
                raise ValueError(f"unknown precision {name}")
        self.round = self.ROUND[precision]
        self.backward = backward and self.ROUND[backward]

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.backward:
            return _RoundedBackward.apply(a, w, self.backward)
        return self.round(a) @ self.round(w)


# -- shapes ----------------------------------------------------------------

def width(g: dict) -> int:
    """One spliced input row: ``input_dim`` times the context's frames."""
    return g["input_dim"] * (g["left_context"] + 1 + g["right_context"])


def halved(length: int, times: int) -> int:
    """The length after ``times`` stride-2 "SAME" convolutions."""
    for _ in range(times):
        length = -(-length // 2)
    return length


def g_shapes(g: dict) -> Dict[str, Tuple[int, ...]]:
    """The auto-encoder G's leaves (``enc_i``, ``dec_i``, ``dec_out``;
    ``enc_prelu_i``, ``dec_prelu_i`` with PReLU); kernels ``[k, in,
    out]``."""
    enc, k, prelu = list(g["enc_depths"]), g["kwidth"], g["g_nl"] == "prelu"
    out: Dict[str, Tuple[int, ...]] = {}
    c_in = 1
    for i, depth in enumerate(enc):
        out[f"enc_{i}.kernel"] = (k, c_in, depth)
        if g["bias_downconv"]:
            out[f"enc_{i}.bias"] = (depth,)
        if prelu:
            out[f"enc_prelu_{i}"] = (depth,)
        c_in = depth
    c_in += enc[-1] if g["z_on"] else 0
    dec = enc[:-1][::-1] + [1]
    for i, depth in enumerate(dec):
        out[f"dec_{i}.kernel"] = (k, c_in, depth)
        if g["bias_deconv"]:
            out[f"dec_{i}.bias"] = (depth,)
        if prelu and i < len(dec) - 1:
            out[f"dec_prelu_{i}"] = (depth,)
        c_in = 2 * depth
    out["dec_out.kernel"] = (2 * halved(width(g), 1), g["output_dim"])
    out["dec_out.bias"] = (g["output_dim"],)
    return out


def d_shapes(d: dict) -> Dict[str, Tuple[int, ...]]:
    """D's leaves (``d_block_i``, ``d_vbn_i``, ``logits_conv``,
    ``logits_out``); ``d["input_width"]`` is the joint row's."""
    fmaps, k = list(d["num_fmaps"]), d["kwidth"]
    out: Dict[str, Tuple[int, ...]] = {}
    c_in = 1
    for i, f in enumerate(fmaps):
        out[f"d_block_{i}.kernel"] = (k, c_in, f)
        if d["bias_conv"]:
            out[f"d_block_{i}.bias"] = (f,)
        out[f"d_vbn_{i}.gamma"] = (f,)
        out[f"d_vbn_{i}.beta"] = (f,)
        c_in = f
    out["logits_conv.kernel"] = (k, c_in, 1)
    out["logits_out.kernel"] = (halved(d["input_width"], len(fmaps)), 1)
    out["logits_out.bias"] = (1,)
    return out


# -- the layers ------------------------------------------------------------

def same_pads(length: int, k: int, stride: int) -> Tuple[int, int]:
    """"SAME": ``ceil(length / stride)`` outputs; the padding that needs
    split ``total // 2`` before and the rest after."""
    out = -(-length // stride)
    total = max((out - 1) * stride + k - length, 0)
    return total // 2, total - total // 2


def correlate(x: torch.Tensor, kernel: torch.Tensor, stride: int,
              pads: Tuple[int, int], prod: Products) -> torch.Tensor:
    """``x [B, C, L]`` zero-padded by ``pads``, correlated with ``kernel
    [k, C, O]`` at ``stride``: each output position's ``k x C`` window
    (unfold) times the kernel as one ``[k C, O]`` matrix."""
    B, C, _ = x.shape
    k, _, O = kernel.shape
    xp = torch.cat([x.new_zeros(B, C, pads[0]), x,
                    x.new_zeros(B, C, pads[1])], dim=2)
    cols = xp.unfold(2, k, stride)                   # [B, C, Lo, k]
    Lo = cols.shape[2]
    cols = cols.permute(0, 2, 3, 1).reshape(B * Lo, k * C)
    y = prod.mm(cols, kernel.reshape(k * C, O))
    return y.view(B, Lo, O).permute(0, 2, 1)


def conv(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
         stride: int, prod: Products) -> torch.Tensor:
    """A "SAME" convolution: ``ceil(L / stride)`` positions."""
    y = correlate(x, kernel, stride,
                  same_pads(x.shape[2], kernel.shape[0], stride), prod)
    return y if bias is None else y + bias[:, None]


def conv_transpose(x: torch.Tensor, kernel: torch.Tensor,
                   bias: Optional[torch.Tensor], stride: int,
                   prod: Products) -> torch.Tensor:
    """A "SAME" transposed convolution (``kernel`` as it is, not
    flipped): ``L * stride`` positions. The input with ``stride - 1``
    zeros after each position but the last, padded ``k + stride - 2`` in
    all (``k - 1`` before where the stride exceeds it, else half rounded
    up), correlated with the kernel at stride 1."""
    B, C, L = x.shape
    k = kernel.shape[0]
    spread = torch.cat([x.unsqueeze(-1), x.new_zeros(B, C, L, stride - 1)],
                       dim=-1).reshape(B, C, L * stride)
    spread = spread[:, :, :(L - 1) * stride + 1]
    total = k + stride - 2
    before = k - 1 if stride > k - 1 else -(-total // 2)
    y = correlate(spread, kernel, 1, (before, total - before), prod)
    return y if bias is None else y + bias[:, None]


def activate(h: torch.Tensor, alpha: Optional[torch.Tensor]) -> torch.Tensor:
    """LeakyReLU 0.3, or PReLU of ``alpha`` per channel."""
    if alpha is None:
        return torch.maximum(h, LEAKY * h)
    return torch.relu(h) + alpha[:, None] * (h - torch.abs(h)) * 0.5


def dense(h: torch.Tensor, p: Tree, name: str, prod: Products
          ) -> torch.Tensor:
    return prod.mm(h, p[f"{name}.kernel"]) + p[f"{name}.bias"]


def g_forward(p: Tree, g: dict, x: torch.Tensor, rand: Optional[Rand],
              prod: Products) -> torch.Tensor:
    """G: ``[B, W]`` -> ``[B, output_dim]``; z from ``rand`` (its shape
    ``[B, L, depth]``), zeros without it."""
    enc = list(g["enc_depths"])
    prelu = g["g_nl"] == "prelu"
    h, skips = x[:, None, :], []
    for i in range(len(enc)):
        h = conv(h, p[f"enc_{i}.kernel"], p.get(f"enc_{i}.bias"), 2, prod)
        if i < len(enc) - 1:
            skips.append(h)
        h = activate(h, p[f"enc_prelu_{i}"] if prelu else None)
    if g["z_on"]:
        shape = (h.shape[0], h.shape[2], enc[-1])
        z = (rand(shape) if rand is not None
             else torch.zeros(shape, device=h.device))
        h = torch.cat([z.to(h.device).transpose(1, 2), h], dim=1)
    last = len(enc) - 1
    for i in range(len(enc)):
        h = conv_transpose(h, p[f"dec_{i}.kernel"], p.get(f"dec_{i}.bias"),
                           2, prod)
        if i < last:
            skip = skips[-(i + 1)]
            h = activate(h[:, :, :skip.shape[2]],
                         p[f"dec_prelu_{i}"] if prelu else None)
            h = torch.cat([h, skip], dim=1)
    h = h[:, 0] if h.shape[1] == 1 else h.mean(1)
    return dense(h, p, "dec_out", prod)


def vbn(h: torch.Tensor, p: Tree, i: int, stats: List[tuple],
        capture: bool) -> torch.Tensor:
    """Virtual batch norm ``d_vbn_i``; ``capture`` first takes its
    reference statistics from ``h`` (appended to ``stats``)."""
    mean_b = h.mean((0, 2))
    meansq_b = torch.square(h).mean((0, 2))
    if capture:
        stats.append((mean_b.detach().clone(), meansq_b.detach().clone()))
    ref_mean, ref_meansq = stats[i]
    new = 1.0 / (h.shape[0] + 1.0)
    mean = new * mean_b + (1.0 - new) * ref_mean
    meansq = new * meansq_b + (1.0 - new) * ref_meansq
    std = torch.sqrt(VBN_EPS + meansq - torch.square(mean))
    return ((h - mean[:, None]) / std[:, None]
            * (1.0 + p[f"d_vbn_{i}.gamma"])[:, None]
            + p[f"d_vbn_{i}.beta"][:, None])


def d_forward(p: Tree, d: dict, joint: torch.Tensor, stats: List[tuple],
              prod: Products, capture: bool = False) -> torch.Tensor:
    """D: ``[B, W + output_dim]`` -> ``[B, 1]``."""
    h = joint[:, None, :]
    for i in range(len(d["num_fmaps"])):
        h = conv(h, p[f"d_block_{i}.kernel"], p.get(f"d_block_{i}.bias"), 2,
                 prod)
        h = activate(vbn(h, p, i, stats, capture), None)
    h = conv(h, p["logits_conv.kernel"], None, 1, prod)[:, 0]
    return dense(h, p, "logits_out", prod)


@torch.no_grad()
def vbn_stats(cfg: dict, init: Dict[str, Tree], example: torch.Tensor,
              prod: Products) -> List[tuple]:
    """D's reference statistics: its forward on ``concat(example,
    G(example))`` with z = 0, each layer's taken from its own input."""
    g_out = g_forward(init["g"], cfg["generator"], example, None, prod)
    stats: List[tuple] = []
    d_forward(init["d"], cfg["discriminator"],
              torch.cat([example, g_out], dim=1), stats, prod, capture=True)
    return stats


# -- training --------------------------------------------------------------

class Net:
    """One net's parameters, RMSProp's ``nu`` and the EMA shadow."""

    def __init__(self, params: Tree, lr: float, ema_decay: float):
        self.p = {k: v.detach().clone() for k, v in params.items()}
        self.ema = {k: v.clone() for k, v in self.p.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.lr, self.ema_decay = lr, ema_decay

    def leaves(self) -> Tree:
        return {k: v.requires_grad_(True) for k, v in self.p.items()}

    def step(self, loss: torch.Tensor, leaves: Tree) -> Tree:
        """One update from ``loss``; returns the gradients."""
        names = list(leaves)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[n] for n in names])))
        with torch.no_grad():
            for n, g in grads.items():
                self.nu[n] = (1.0 - RMS_DECAY) * g * g + RMS_DECAY * self.nu[n]
                p = self.p[n].detach() - self.lr * (
                    torch.rsqrt(self.nu[n] + RMS_EPS) * g)
                self.p[n] = p
                self.ema[n] = self.ema[n] - (1.0 - self.ema_decay) * (
                    self.ema[n] - p)
        return grads

    def snapshot(self) -> Dict[str, Tree]:
        return {"params": {k: v.detach().clone() for k, v in self.p.items()},
                "ema": {k: v.clone() for k, v in self.ema.items()}}


def iteration(g_net: Net, d_net: Net, cfg: dict, x: torch.Tensor,
              y: torch.Tensor, rand: Rand, stats: List[tuple],
              prod: Products, grads: Dict[str, Tree],
              g_prod: Optional[Products] = None,
              d_after: Optional[Tree] = None) -> Dict[str, float]:
    """One iteration on ``(x, y)``; the first gradient of each net is
    kept in ``grads``. ``g_prod``: G's products in its G steps (``prod``
    without it). ``d_after``: D's parameters as another run's D steps
    left them, put in place of this run's before the G steps."""
    g, d, hp = cfg["generator"], cfg["discriminator"], cfg["hparams"]

    def noisy(target):
        joint = torch.cat([x, target], dim=1)
        return joint + hp["disc_noise_std"] * rand(tuple(joint.shape)).to(
            joint.device)

    metrics: Dict[str, float] = {}

    def add(name, value, n):
        metrics[name] = metrics.get(name, 0.0) + float(value.detach()) / n

    for _ in range(hp["disc_updates"]):
        with torch.no_grad():
            g_out = g_forward(g_net.p, g, x, rand, prod)
        dp = d_net.leaves()
        rl = d_forward(dp, d, noisy(y), stats, prod)
        fk = d_forward(dp, d, noisy(g_out), stats, prod)
        d_rl = torch.mean(torch.square(rl - 1.0))
        d_fk = torch.mean(torch.square(fk))
        grads.setdefault("d", d_net.step(d_rl + d_fk, dp))
        for name, v in (("d_rl_loss", d_rl), ("d_fk_loss", d_fk),
                        ("d_loss", d_rl + d_fk)):
            add(name, v, hp["disc_updates"])
    if d_after is not None:
        d_net.p = {k: v.detach().clone() for k, v in d_after.items()}
    for _ in range(hp["gen_updates"]):
        gp = g_net.leaves()
        g_out = g_forward(gp, g, x, rand, g_prod or prod)
        dp = {k: v.detach() for k, v in d_net.p.items()}
        adv = torch.mean(torch.square(
            d_forward(dp, d, noisy(g_out), stats, prod) - 1.0))
        l1 = hp["l1_weight"] * torch.mean(torch.abs(g_out - y))
        grads.setdefault("g", g_net.step(adv + l1, gp))
        for name, v in (("g_adv_loss", adv), ("g_l1_loss", l1),
                        ("g_loss", adv + l1)):
            add(name, v, hp["gen_updates"])
    return metrics


def train(cfg: dict, init: Dict[str, Tree], example: torch.Tensor,
          batches, rand: Rand, precision: str = "f32",
          rows: Optional[int] = None,
          g_backward: Optional[str] = None,
          d_first: Optional[Tree] = None) -> dict:
    """D's reference statistics from ``example``, then the first
    ``len(batches)`` iterations from ``init`` (``{"g": ..., "d": ...}``)
    on ``batches`` (``(x, y)`` on one device), drawing from ``rand``:
    each iteration's losses, each net's first gradient (``"grads"``), its
    parameters and EMA after the first and after the last iteration
    (``"after1"``, ``"after"``) and the statistics (``"vbn"``, by buffer
    name). ``rows``: keep only the first rows of every batch (a fault's
    reading: half the batch left out). ``g_backward``: G's backward
    products in that precision (a fault's reading: G's gradients
    computed in it). ``d_first``: D's parameters after another run's
    first D steps, which the first iteration's G steps then read (so
    that G's first gradient is held against that run's without the
    spread of D's first RMSProp step)."""
    set_f32()
    prod = Products(precision)
    g_prod = Products(precision, g_backward) if g_backward else None
    hp = cfg["hparams"]
    stats = vbn_stats(cfg, init, example, prod)
    nets = {"g": Net(init["g"], hp["g_lr"], hp["ema_decay"]),
            "d": Net(init["d"], hp["d_lr"], hp["ema_decay"])}
    losses, grads, after1 = [], {}, None
    for k, (x, y) in enumerate(batches):
        if rows is not None:
            x, y = x[:rows], y[:rows]
        losses.append(iteration(nets["g"], nets["d"], cfg, x, y, rand,
                                stats, prod, grads, g_prod,
                                d_first if k == 0 else None))
        if k == 0:
            after1 = {n: net.snapshot() for n, net in nets.items()}
    vbn_tree = {}
    for i, (mean, meansq) in enumerate(stats):
        vbn_tree[f"d_vbn_{i}.ref_mean"] = mean
        vbn_tree[f"d_vbn_{i}.ref_meansq"] = meansq
    return {"losses": losses, "grads": grads, "after1": after1,
            "after": {n: net.snapshot() for n, net in nets.items()},
            "vbn": vbn_tree}


@torch.no_grad()
def decode(cfg: dict, params: Tree, x: torch.Tensor,
           precision: str = "f32") -> torch.Tensor:
    """G's forward with z = 0 on ``x [B, W]``: ``[B, output_dim]`` f32."""
    set_f32()
    return g_forward(params, cfg["generator"], x, None, Products(precision))
