"""The SEGAN trainer (counterpart of ``rsrgan_tpu/training/segan.py``
``SeganTrainer``): LSGAN plus L1, RMSProp for both nets with no gradient
clipping, EMA 0.9999, a VBN discriminator.

D is conditioned: it sees ``concat(inputs, target)`` along the feature
axis (target: the labels or G's output), plus Gaussian noise of
``hp["disc_noise_std"]``. D's losses are against the constants 1 (real)
and 0 (fake); G's loss is ``g_adv + hp["l1_lambda"] * mean|G - labels|``.
One ``train_step`` is ``disc_updates`` D steps, each on a fresh G output
(no gradient to G), then ``gen_updates`` G steps, metrics averaged. D
sees real and fake in two calls: VBN's live statistics depend on the
batch, so the two must not share one forward as LSTM-D's do.

The latent z and D's input noise come from ``rand``
(``models.segan.NormalSource``: a ``torch.Generator``, or a callable
``shape -> tensor`` through which a test hands in JAX's draws), drawn in
the JAX step's order: per D step z, the real row's noise, the fake row's
noise; per G step z, the fake row's noise. ``eval_step`` draws z, the
real and fake noise of D's losses, and the noise of one more D call on
the fake rows for G's adversarial loss. ``infer_step`` runs G with z = 0,
as JAX without a ``z`` rng does. State is updated in place.

In a data-parallel world (``parallel``) each rank steps on its rows of
the global batch: z and D's noise are this rank's rows of the draws at
the global batch, VBN's live statistics are the global batch's, and each
update's gradients and metrics are averaged over the world (eval
metrics too).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from rsrgan_tpu_torch.models.segan import NormalSource, draw_normal
from rsrgan_tpu_torch.ops.common import gaussian_noise
from rsrgan_tpu_torch.parallel.mesh import (all_reduce_mean, current_world,
                                            local_draws)
from rsrgan_tpu_torch.training.gan import GanState
from rsrgan_tpu_torch.training.losses import lsgan_d_losses, lsgan_g_adv_loss
from rsrgan_tpu_torch.training.state import NetState, world_mean


class SeganTrainer:
    """Train, eval and infer steps for a SEGAN (G, D) pair:
    generator(inputs [B, W], z) -> [B, units]; discriminator(joint
    [B, W + units]) -> [B, 1]. ``grad_log``: set to a list to record, per
    update, (net, {param name: gradient})."""

    def __init__(self, generator: nn.Module, discriminator: nn.Module, *,
                 disc_updates: int = 1, gen_updates: int = 1,
                 ema_decay: float = 0.9999, optimizer: str = "rmsprop"):
        self.generator = generator
        self.discriminator = discriminator
        self.disc_updates = disc_updates
        self.gen_updates = gen_updates
        self.ema_decay = ema_decay
        self.optimizer = optimizer
        self.grad_log = None

    def init_state(self, example_inputs: torch.Tensor) -> GanState:
        """The optimizer and EMA state of both nets, and D's VBN reference
        statistics from ``concat(example_inputs, G(example_inputs))`` with
        z = 0 (the JAX ``init_state``)."""
        with torch.no_grad():
            g_out = self.generator(example_inputs)
            self.discriminator.init_vbn_stats(
                torch.cat([example_inputs, g_out], dim=-1))
        return GanState(g=NetState(self.generator, self.optimizer, None),
                        d=NetState(self.discriminator, self.optimizer, None))

    def _d(self, inputs, target, hp, rand: NormalSource) -> torch.Tensor:
        joint = torch.cat([inputs, target], dim=-1)
        noise = draw_normal(local_draws(rand), tuple(joint.shape),
                            joint.device)
        return self.discriminator(gaussian_noise(joint, hp["disc_noise_std"],
                                                 noise))

    def _d_losses(self, g_out, inputs, labels, hp, rand):
        rl = self._d(inputs, labels, hp, rand)
        fk = self._d(inputs, g_out, hp, rand)
        d_rl, d_fk, d_loss = lsgan_d_losses(rl, fk, 1.0, 0.0)
        return d_loss, {"d_rl_loss": d_rl, "d_fk_loss": d_fk,
                        "d_loss": d_loss}

    def _g_losses(self, g_out, inputs, labels, hp, rand):
        adv = lsgan_g_adv_loss(self._d(inputs, g_out, hp, rand), 1.0)
        l1 = hp["l1_lambda"] * torch.mean(torch.abs(g_out - labels))
        return adv + l1, {"g_adv_loss": adv, "g_l1_loss": l1,
                          "g_loss": adv + l1}

    def _update(self, tag: str, net: NetState, loss, metrics, lr: float
                ) -> Dict[str, torch.Tensor]:
        """One update of ``net`` from ``loss``; returns ``metrics``
        averaged over the data world with the gradients."""
        params = net.params()
        names = list(params)
        grads, metrics = world_mean(
            dict(zip(names, torch.autograd.grad(
                loss, [params[n] for n in names]))),
            {k: v.detach() for k, v in metrics.items()})
        if self.grad_log is not None:
            self.grad_log.append((tag, {k: g.detach().clone()
                                        for k, g in grads.items()}))
        net.apply_gradients(grads, lr, self.ema_decay)
        return metrics

    def train_step(self, state: GanState, inputs, labels,
                   hp: Dict[str, float], rand: NormalSource
                   ) -> Dict[str, torch.Tensor]:
        """disc_updates D steps, then gen_updates G steps, on one batch;
        returns the metrics (device scalars, averaged over the steps)."""
        metrics: Dict[str, torch.Tensor] = {}
        for _ in range(self.disc_updates):
            with torch.no_grad():
                g_out = self.generator(inputs, local_draws(rand))
            d_loss, m = self._d_losses(g_out, inputs, labels, hp, rand)
            m = self._update("d", state.d, d_loss, m, hp["d_lr"])
            for k, v in m.items():
                metrics[k] = metrics.get(k, 0.0) + v / self.disc_updates
        for _ in range(self.gen_updates):
            g_loss, m = self._g_losses(
                self.generator(inputs, local_draws(rand)), inputs, labels,
                hp, rand)
            m = self._update("g", state.g, g_loss, m, hp["g_lr"])
            for k, v in m.items():
                metrics[k] = metrics.get(k, 0.0) + v / self.gen_updates
        state.step += 1
        return metrics

    @torch.no_grad()
    def eval_step(self, state: GanState, inputs, labels,
                  hp: Dict[str, float], rand: NormalSource
                  ) -> Dict[str, torch.Tensor]:
        """Every loss with z and noise drawn, no update."""
        g_out = self.generator(inputs, local_draws(rand))
        _, d_m = self._d_losses(g_out, inputs, labels, hp, rand)
        _, g_m = self._g_losses(g_out, inputs, labels, hp, rand)
        return all_reduce_mean(current_world(), {**d_m, **g_m})

    @torch.no_grad()
    def infer_step(self, state: GanState, inputs) -> torch.Tensor:
        """G with z = 0 (decode)."""
        return self.generator(inputs)
