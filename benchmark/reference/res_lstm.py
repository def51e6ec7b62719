"""Plain PyTorch reference of the res_lstm_l generator, the LSTM
discriminator and their training steps, written from the published
description (RSRGAN, arXiv 1803.10132; TensorFlow's peephole
``LSTMCell`` with ``num_proj``, driven by ``dynamic_rnn``).

It imports nothing of the program. Weights are the JAX layout's dotted
names (``weights.py`` draws them); products are f32 with TF32 off
(``precision="f32"``), or, for the control, their operands rounded to
float8 e4m3 with a scale per tensor (``precision="fp8"``), the step below
the configuration's bfloat16.

The cell, per row and step (gate order i, j, f, o in one kernel of
``[in + P, 4U]``)::

    gates = x W_x + h W_h + b
    c' = sig(f + forget_bias + w_f * c) * c + sig(i + w_i * c) * tanh(j)
    m  = sig(o + w_o * c') * tanh(c');   h' = m proj

Past a row's length the state holds and the output is zero. res_lstm_l:
``tap_{k+1} = out_k(tap_k) + tap_k``, then a dense layer; LSTM-D: input
plus ``noise_std`` times N(0, 1) draws, two layers, a dense layer to one
logit. Losses are means over the padded tensors.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

Tree = Dict[str, torch.Tensor]
FP8_MAX = 448.0


def set_f32() -> None:
    """f32 products in f32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 at a per-tensor scale (its largest
    magnitude to 448); the gradient passes straight through."""
    amax = t.detach().abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    q = (t.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return t + (q - t.detach())


class Products:
    """The LSTM products of one precision: ``mm(a, w)``."""

    def __init__(self, precision: str):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {precision}")
        self.round = fp8 if precision == "fp8" else (lambda t: t)

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.round(a) @ self.round(w)


# -- shapes ----------------------------------------------------------------

def lstm_shapes(prefix: str, d_in: int, U: int, P: int
                ) -> Dict[str, Tuple[int, ...]]:
    return {f"{prefix}.kernel": (d_in + P, 4 * U), f"{prefix}.bias": (4 * U,),
            f"{prefix}.proj_kernel": (U, P), f"{prefix}.w_i_diag": (1, U),
            f"{prefix}.w_f_diag": (1, U), f"{prefix}.w_o_diag": (1, U)}


def g_shapes(g: dict) -> Dict[str, Tuple[int, ...]]:
    """res_lstm_l's leaves: ``lstm_cell_{1..L}``, ``forward_out``."""
    P, out = g["num_proj"], {}
    for k in range(g["num_layers"]):
        out.update(lstm_shapes(f"lstm_cell_{k + 1}",
                               g["input_dim"] if k == 0 else P,
                               g["cell_size"], P))
    out["forward_out.kernel"] = (P, g["output_dim"])
    out["forward_out.bias"] = (g["output_dim"],)
    return out


def d_shapes(d: dict) -> Dict[str, Tuple[int, ...]]:
    """LSTM-D's leaves: ``StackedLstm_0.cell_{k}``, ``Dense_0``."""
    P, out = d["num_proj"], {}
    for k in range(d["num_layers"]):
        out.update(lstm_shapes(f"StackedLstm_0.cell_{k}",
                               d["input_dim"] if k == 0 else P,
                               d["cell_size"], P))
    out["Dense_0.kernel"] = (P, 1)
    out["Dense_0.bias"] = (1,)
    return out


# -- forward ---------------------------------------------------------------

def lstm_layer(x: torch.Tensor, lengths: torch.Tensor, p: Tree, prefix: str,
               forget_bias: float, prod: Products) -> torch.Tensor:
    """One layer over time: ``x [B, T, in]`` -> ``[B, T, P]``."""
    B, T, d_in = x.shape
    kernel = p[f"{prefix}.kernel"]
    proj = p[f"{prefix}.proj_kernel"]
    U, P = proj.shape
    w_x, w_h = kernel[:d_in], kernel[d_in:]
    w_i, w_f, w_o = (p[f"{prefix}.w_{g}_diag"] for g in "ifo")
    bias = p[f"{prefix}.bias"]
    t_max = int(lengths.max())
    xw = prod.mm(x[:, :t_max].reshape(B * t_max, d_in), w_x).view(
        B, t_max, 4 * U)
    live = (torch.arange(t_max, device=x.device)[None, :]
            < lengths[:, None]).unsqueeze(-1)
    c = x.new_zeros((B, U))
    h = x.new_zeros((B, P))
    outs: List[torch.Tensor] = []
    for t in range(t_max):
        gates = xw[:, t] + prod.mm(h, w_h) + bias
        i, j, f, o = gates.split(U, dim=1)
        c_new = (torch.sigmoid(f + forget_bias + w_f * c) * c
                 + torch.sigmoid(i + w_i * c) * torch.tanh(j))
        m = torch.sigmoid(o + w_o * c_new) * torch.tanh(c_new)
        h_new = prod.mm(m, proj)
        keep = live[:, t]
        c = torch.where(keep, c_new, c)
        h = torch.where(keep, h_new, h)
        outs.append(torch.where(keep, h_new, torch.zeros_like(h_new)))
    out = torch.stack(outs, dim=1)
    if t_max < T:
        out = torch.cat([out, out.new_zeros((B, T - t_max, P))], dim=1)
    return out


def g_forward(p: Tree, g: dict, x: torch.Tensor, lengths: torch.Tensor,
              prod: Products) -> torch.Tensor:
    """res_lstm_l: ``[B, T, in]`` -> ``[B, T, out]``."""
    tap = x
    for k in range(g["num_layers"]):
        out = lstm_layer(tap, lengths, p, f"lstm_cell_{k + 1}",
                         g["forget_bias"], prod)
        tap = out + tap if g["residual"] == "layer" else out
    return tap @ p["forward_out.kernel"] + p["forward_out.bias"]


def d_forward(p: Tree, d: dict, x: torch.Tensor, lengths: torch.Tensor,
              noise: Optional[torch.Tensor], prod: Products) -> torch.Tensor:
    """LSTM-D: ``[B, T, in]`` (plus ``noise_std`` times ``noise``) ->
    ``[B, T, 1]``."""
    h = x if noise is None else x + d["noise_std"] * noise
    for k in range(d["num_layers"]):
        h = lstm_layer(h, lengths, p, f"StackedLstm_0.cell_{k}",
                       d["forget_bias"], prod)
    return h @ p["Dense_0.kernel"] + p["Dense_0.bias"]


# -- training --------------------------------------------------------------

class Net:
    """One net's parameters, optimizer state and EMA shadow (optax's
    chain: per-tensor clip, Adam with bias correction and eps outside the
    root, or SGD; then ``p - lr * update``; EMA ``e - (1 - decay)(e -
    p)``)."""

    def __init__(self, params: Tree, optimizer: str, lr: float, hp: dict):
        self.p = {k: v.detach().clone() for k, v in params.items()}
        self.ema = {k: v.clone() for k, v in self.p.items()}
        self.optimizer, self.lr, self.hp = optimizer, lr, hp
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.p.items()}

    def leaves(self) -> Tree:
        return {k: v.requires_grad_(True) for k, v in self.p.items()}

    def step(self, loss: torch.Tensor, leaves: Tree) -> None:
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        hp, clip = self.hp, self.hp["max_grad_norm"]
        self.count += 1
        bc1 = 1.0 - hp["adam_b1"] ** self.count
        bc2 = 1.0 - hp["adam_b2"] ** self.count
        with torch.no_grad():
            for n, g in zip(names, grads):
                if clip is not None:
                    g = g * (clip / torch.clamp(g.norm(), min=clip))
                if self.optimizer == "adam":
                    self.mu[n] = (1 - hp["adam_b1"]) * g + hp["adam_b1"] * self.mu[n]
                    self.nu[n] = ((1 - hp["adam_b2"]) * g * g
                                  + hp["adam_b2"] * self.nu[n])
                    g = (self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2)
                                              + hp["adam_eps"])
                elif self.optimizer != "sgd":
                    raise ValueError(f"unknown optimizer {self.optimizer}")
                p = self.p[n].detach() - self.lr * g
                self.p[n] = p
                self.ema[n] = self.ema[n] - (1 - hp["ema_decay"]) * (
                    self.ema[n] - p)

    def snapshot(self) -> Dict[str, Tree]:
        return {"params": {k: v.detach().clone() for k, v in self.p.items()},
                "mu": {k: v.clone() for k, v in self.mu.items()},
                "ema": {k: v.clone() for k, v in self.ema.items()}}


def l2_nonbias(p: Tree, scale: float) -> torch.Tensor:
    """``scale`` times half the squared norm of every leaf not named
    bias."""
    total = sum(0.5 * (v * v).sum() for k, v in p.items()
                if "bias" not in k.lower())
    return scale * total


def gan_iteration(g_net: Net, d_net: Net, cfg: dict, x, y, lengths,
                  noise: torch.Generator, prod: Products) -> Dict[str, float]:
    """One LSGAN iteration: 1 D step on real and fake (2B rows), then 2 G
    steps, the first on the D step's G forward. D's input noise is drawn
    from ``noise`` for each D forward in that order, at the forward's
    full padded shape."""
    g, d, hp = cfg["generator"], cfg["discriminator"], cfg["hparams"]
    B = x.shape[0]

    def draw(shape):
        return torch.randn(shape, generator=noise, dtype=torch.float32,
                           device=noise.device).to(x.device)

    metrics: Dict[str, float] = {}
    gp = g_net.leaves()
    g_out = g_forward(gp, g, x, lengths, prod)
    for _ in range(hp["disc_updates"]):
        dp = d_net.leaves()
        both = torch.cat([y, g_out.detach()], dim=0)
        logits = d_forward(dp, d, both, torch.cat([lengths, lengths]),
                           draw(both.shape), prod)
        d_rl = torch.mean(torch.square(logits[:B] - hp["d_real"]))
        d_fk = torch.mean(torch.square(logits[B:] - hp["d_fake"]))
        d_net.step(d_rl + d_fk, dp)
        for k, v in (("d_rl_loss", d_rl), ("d_fk_loss", d_fk),
                     ("d_loss", d_rl + d_fk)):
            metrics[k] = metrics.get(k, 0.0) + float(v.detach()) / hp["disc_updates"]
    for step in range(hp["gen_updates"]):
        if step > 0:
            gp = g_net.leaves()
            g_out = g_forward(gp, g, x, lengths, prod)
        dp = {k: v.detach() for k, v in d_net.p.items()}
        logits = d_forward(dp, d, g_out, lengths, draw(g_out.shape), prod)
        adv = torch.mean(torch.square(logits - hp["d_real"]))
        mse = 0.5 * torch.mean(torch.square(g_out - y)) * g["output_dim"]
        l2 = l2_nonbias(gp, hp["l2_scale"])
        loss = adv + hp["mse_weight"] * mse + l2
        g_net.step(loss, gp)
        for k, v in (("g_adv_loss", adv), ("g_mse_loss", mse),
                     ("g_l2_loss", l2), ("g_loss", loss)):
            metrics[k] = metrics.get(k, 0.0) + float(v.detach()) / hp["gen_updates"]
    return metrics


def mse_iteration(g_net: Net, cfg: dict, x, y, lengths,
                  prod: Products) -> Dict[str, float]:
    """One MSE step: ``0.5 * MSE * out_dim + l2`` of the non-bias
    leaves."""
    g, hp = cfg["generator"], cfg["hparams"]
    gp = g_net.leaves()
    g_out = g_forward(gp, g, x, lengths, prod)
    mse = 0.5 * torch.mean(torch.square(g_out - y)) * g["output_dim"]
    l2 = l2_nonbias(gp, hp["l2_scale"])
    loss = mse + l2
    g_net.step(loss, gp)
    return {"g_mse_loss": float(mse.detach()), "g_l2_loss": float(l2.detach()),
            "g_loss": float(loss.detach())}


def train(cfg: dict, init: Dict[str, Tree], batches, noise_seed: int,
          device, precision: str = "f32", rows: Optional[int] = None
          ) -> dict:
    """The first ``len(batches)`` iterations from ``init`` (``{"g": ...,
    "d": ...}``) on ``batches`` (x, y, lengths on ``device``): each
    iteration's losses, and each net's state after the first and after
    the last (``"after1"``, ``"after"``). ``rows``: keep only the first
    rows of every batch (a fault's reading: half the batch left out)."""
    set_f32()
    prod = Products(precision)
    hp = cfg["hparams"]
    nets = {"g": Net(init["g"], hp["g_optimizer"], hp["g_lr"], hp)}
    if hp["trainer"] == "gan":
        nets["d"] = Net(init["d"], hp["d_optimizer"], hp["d_lr"], hp)
    noise = torch.Generator(device=device).manual_seed(noise_seed)
    losses, after1 = [], None
    for k, (x, y, lengths) in enumerate(batches):
        if rows is not None:
            x, y, lengths = x[:rows], y[:rows], lengths[:rows]
        if hp["trainer"] == "gan":
            m = gan_iteration(nets["g"], nets["d"], cfg, x, y, lengths,
                              noise, prod)
        else:
            m = mse_iteration(nets["g"], cfg, x, y, lengths, prod)
        losses.append(m)
        if k == 0:
            after1 = {n: net.snapshot() for n, net in nets.items()}
    return {"losses": losses, "after1": after1,
            "after": {n: net.snapshot() for n, net in nets.items()}}


@torch.no_grad()
def decode(cfg: dict, params: Tree, x: torch.Tensor, lengths: torch.Tensor,
           precision: str = "f32") -> torch.Tensor:
    """G's forward on ``x [B, T, in]``: ``[B, T, out]`` f32."""
    set_f32()
    return g_forward(params, cfg["generator"], x, lengths,
                     Products(precision))
