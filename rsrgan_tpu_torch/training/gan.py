"""The flagship LSGAN trainer (counterpart of ``rsrgan_tpu/training/gan.py``
``GanTrainer``).

One ``train_step`` is ``disc_updates`` D steps then ``gen_updates`` G
steps on one minibatch (the placeholder trainer's same-batch semantics);
every G step sees the D parameters the D steps produced. ``d_step`` and
``g_step`` are one D update and one G update alone, which the graph-fed
loop (``--same_batch=false``) runs on different minibatches. D uses SGD,
G Adam; each gradient tensor is clipped to ``max_grad_norm``; EMA decay
0.9999 on both nets. Losses: LSGAN with the soft labels d_real/d_fake, G
loss = g_adv + mse_lambda * (0.5 * MSE * output_dim) + L2 of the non-bias
G weights. With ``d_conditioned`` D sees the center input frame beside
its target (``_d_input``).

When G has no dropout (the flagship), the D steps' fake input and the
first G step's forward are one computation: G runs forward once with its
autograd graph kept; the D steps take ``g_out.detach()``, and the first
G step runs the D head with the updated D parameters and backpropagates
through the kept G graph (the JAX ``jax.vjp`` sharing). With dropout
(``keep_prob < 1``) every D step's fake and every G step draw a G forward
of their own, as in JAX. G's masks and D's come from two mask sources
kept apart (``g_masks``, ``d_masks``; ``seed_dropout`` seeds two
generators), as JAX draws G's from their own stream and D's from
``fold_in(noise_rng, 1)``; D drops out in train mode only.

``frame_mode`` is the frame LSGAN (``--trainer=gan_dnn``): G takes
spliced frames without lengths, D (DNN-D) takes ``[B, width]`` frames
without noise or lengths; the CLI builds it with Adam for both nets, no
clipping, and D always conditioned. A G with ``batch_stats`` (BatchNorm
layers, or bnlstm's cells) is refused: the JAX ``GanTrainer`` keeps none
and cannot run one.

``train_step_gathered`` and ``eval_step_gathered`` first assemble their
batch on the device from resident tables and a ``[B]`` plan
(``ops/gather.py``). State is updated in place (the JAX step returns a
new state).

In a data-parallel world (``parallel``) each rank steps on its rows of
the global batch: every update's gradients and metrics are averaged over
the world before the clip (``world_mean``), eval metrics too, and D's
noise and the dropout masks are this rank's rows of the draws at the
global batch (``local_draws``; D's 2B rows are two blocks, real and
fake).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from rsrgan_tpu_torch import spans
from rsrgan_tpu_torch.models.bridge import batch_stats_tree
from rsrgan_tpu_torch.ops.common import MaskSource
from rsrgan_tpu_torch.ops.gather import assemble_sequence_batch
from rsrgan_tpu_torch.parallel.mesh import (all_reduce_mean, current_world,
                                            local_draws)
from rsrgan_tpu_torch.training.losses import (g_mse_loss, l2_loss_nonbias,
                                              lsgan_d_losses,
                                              lsgan_g_adv_loss)
from rsrgan_tpu_torch.training.state import NetState, world_mean


def default_hparams() -> Dict[str, float]:
    """Assignable scalars (the reference's non-trainable variables)."""
    return {"g_lr": 8e-5, "d_lr": 1e-3, "mse_lambda": 10.0,
            "disc_noise_std": 0.05, "d_real": 1.0, "d_fake": 0.0}


class GanState:
    """G and D states and the step count."""

    def __init__(self, g: NetState, d: NetState, step: int = 0):
        self.g, self.d, self.step = g, d, step


class GanTrainer:
    """Train and eval steps for a (G, D) pair.

    generator(inputs [B, T, D], lengths [B], train, masks) -> [B, T, out];
    discriminator(x, lengths, noise_std, train, noise, masks) -> [B, T, 1];
    in ``frame_mode`` generator(frames, train=, masks=) -> [B, out] and
    discriminator(x, train, masks) -> [B, 1].
    ``grad_log``: set to a list to record, per update, (net, {param name:
    gradient before clipping}). ``g_masks``/``d_masks``: the dropout mask
    sources of G and D (``ops.common.MaskSource``), needed where the net
    has ``keep_prob < 1``.
    """

    def __init__(self, generator: nn.Module, discriminator: nn.Module, *,
                 output_dim: int, input_dim: int = 257,
                 left_context: int = 0, disc_updates: int = 1,
                 gen_updates: int = 2, l2_scale: float = 0.0,
                 max_grad_norm: Optional[float] = 15.0,
                 ema_decay: float = 0.9999, g_optimizer: str = "adam",
                 d_optimizer: str = "sgd", d_conditioned: bool = False,
                 frame_mode: bool = False):
        if batch_stats_tree(generator) is not None:
            raise ValueError(
                "GanTrainer cannot train a generator with batch_stats "
                "(--trainer=gan_dnn --batch_norm with --g_type=dnn or "
                "rced, or --trainer=gan_rnn --g_type=bnlstm): the JAX "
                "GanTrainer keeps no batch_stats, so the JAX package fails "
                "on the first step with ScopeCollectionNotFound; train "
                "without --batch_norm, or bnlstm with --trainer=rnn")
        self.generator = generator
        self.discriminator = discriminator
        self.output_dim = output_dim
        self.input_dim = input_dim
        self.left_context = left_context
        self.disc_updates = disc_updates
        self.gen_updates = gen_updates
        self.l2_scale = l2_scale
        self.max_grad_norm = max_grad_norm
        self.ema_decay = ema_decay
        self.d_conditioned = d_conditioned
        self.frame_mode = frame_mode
        self.g_optimizer, self.d_optimizer = g_optimizer, d_optimizer
        self.grad_log: Optional[List[Tuple[str, dict]]] = None
        self.g_masks: Optional[MaskSource] = None
        self.d_masks: Optional[MaskSource] = None

    def seed_dropout(self, seed: int, device) -> None:
        """G's dropout masks from a generator on ``device`` seeded with
        ``seed``, D's from another seeded with ``seed + 1``."""
        self.g_masks = torch.Generator(device=device).manual_seed(seed)
        self.d_masks = torch.Generator(device=device).manual_seed(seed + 1)

    def _g(self, inputs, lengths, train: bool):
        masks = local_draws(self.g_masks) if train else None
        if self.frame_mode:
            return self.generator(inputs, train=train, masks=masks)
        return self.generator(inputs, lengths, train, masks=masks)

    def _d(self, x, lengths, hp, train: bool, noise, parts: int = 1):
        """D on ``x``; ``parts``: the blocks of rows x stacks (2: real and
        fake), which the global batch's draws keep apart."""
        masks = local_draws(self.d_masks, parts) if train else None
        if self.frame_mode:
            return self.discriminator(x, train, masks)
        return self.discriminator(x, lengths, hp["disc_noise_std"], train,
                                  local_draws(noise, parts), masks)

    def init_state(self) -> GanState:
        return GanState(
            g=NetState(self.generator, self.g_optimizer, self.max_grad_norm),
            d=NetState(self.discriminator, self.d_optimizer,
                       self.max_grad_norm))

    # -- losses --------------------------------------------------------------

    def _d_input(self, inputs, target):
        """What D sees for a target (labels or G output): the target alone
        (the flagship), or with ``d_conditioned`` the center frame of the
        spliced input beside it."""
        if not self.d_conditioned:
            return target
        start = self.input_dim * self.left_context
        center = inputs[..., start:start + self.input_dim]
        return torch.cat([center, target], dim=-1)

    def _d_loss(self, fake, inputs, labels, lengths, hp, noise,
                train=True):
        """D(real) and D(fake) as one forward of 2B rows (no cross-row
        coupling in D); per-half means after the split."""
        b = labels.shape[0]
        both = torch.cat([labels, fake], dim=0)
        inputs2 = (torch.cat([inputs, inputs], dim=0)
                   if self.d_conditioned else inputs)
        lengths2 = (torch.cat([lengths, lengths], dim=0)
                    if lengths is not None else None)
        d_both = self._d(self._d_input(inputs2, both), lengths2, hp, train,
                         noise, parts=2)
        d_rl, d_fk = d_both[:b], d_both[b:]
        d_rl_loss, d_fk_loss, d_loss = lsgan_d_losses(
            d_rl, d_fk, hp["d_real"], hp["d_fake"])
        metrics = {"d_rl_loss": d_rl_loss, "d_fk_loss": d_fk_loss,
                   "d_loss": d_loss}
        return d_loss, metrics, d_fk

    def _g_head(self, g_out, inputs, labels, lengths, hp, noise):
        d_fk = self._d(self._d_input(inputs, g_out), lengths, hp, True,
                       noise)
        adv = lsgan_g_adv_loss(d_fk, hp["d_real"])
        mse = g_mse_loss(g_out, labels, self.output_dim)
        return adv, mse

    def _g_update(self, state: GanState, g_out, inputs, labels, lengths,
                  hp, noise) -> Dict[str, torch.Tensor]:
        """One G update from a G forward kept for autograd."""
        with spans.span("train.g_update"):
            adv, mse = self._g_head(g_out, inputs, labels, lengths, hp,
                                    noise)
            l2 = l2_loss_nonbias(state.g.params(), self.l2_scale)
            g_loss = adv + hp["mse_lambda"] * mse + l2
            grads, metrics = world_mean(
                self._grads(g_loss, state.g),
                {"g_adv_loss": adv.detach(), "g_mse_loss": mse.detach(),
                 "g_l2_loss": l2.detach(), "g_loss": g_loss.detach()})
            self._update("g", state.g, grads, hp["g_lr"])
            return metrics

    def _d_update(self, state: GanState, fake, inputs, labels, lengths, hp,
                  noise) -> Dict[str, torch.Tensor]:
        """One D update against a detached G output."""
        with spans.span("train.d_update"):
            d_loss, m, _ = self._d_loss(fake, inputs, labels, lengths, hp,
                                        noise)
            grads, metrics = world_mean(
                self._grads(d_loss, state.d),
                {k: v.detach() for k, v in m.items()})
            self._update("d", state.d, grads, hp["d_lr"])
            return metrics

    def _grads(self, loss, net: NetState) -> Dict[str, torch.Tensor]:
        params = net.params()
        names = list(params)
        with spans.span("train.backward"):
            grads = torch.autograd.grad(loss, [params[n] for n in names])
        return dict(zip(names, grads))

    def _update(self, tag: str, net: NetState, grads, lr: float) -> None:
        if self.grad_log is not None:
            self.grad_log.append((tag, {k: g.detach().clone()
                                        for k, g in grads.items()}))
        net.apply_gradients(grads, lr, self.ema_decay)

    # -- steps ----------------------------------------------------------------

    def train_step(self, state: GanState, inputs, labels, lengths,
                   hp: Dict[str, float],
                   noise: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """disc_updates D steps + gen_updates G steps on one batch; returns
        the metrics (device scalars, averaged over the steps)."""
        with spans.span("train.step"):
            metrics: Dict[str, torch.Tensor] = {}
            share = self._share_g_forward()
            if share:
                g_out = self._g(inputs, lengths, True)
                fake_shared = g_out.detach()

            for _ in range(self.disc_updates):
                if share:
                    fake = fake_shared
                else:
                    with torch.no_grad():
                        fake = self._g(inputs, lengths, True)
                m = self._d_update(state, fake, inputs, labels, lengths, hp,
                                   noise)
                for k, v in m.items():
                    metrics[k] = metrics.get(k, 0.0) + v / self.disc_updates

            for g_iter in range(self.gen_updates):
                if not (share and g_iter == 0):
                    g_out = self._g(inputs, lengths, True)
                m = self._g_update(state, g_out, inputs, labels, lengths, hp,
                                   noise)
                for k, v in m.items():
                    metrics[k] = metrics.get(k, 0.0) + v / self.gen_updates
            state.step += 1
            return metrics

    def _share_g_forward(self) -> bool:
        """Safe iff G has no sample-dependent stochastic layers."""
        if self.disc_updates < 1 or self.gen_updates < 1:
            return False
        return float(getattr(self.generator, "keep_prob", 1.0)) >= 1.0

    def d_step(self, state: GanState, inputs, labels, lengths,
               hp: Dict[str, float],
               noise: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
        """One D update alone (the graph-fed trainer feeds D and G from
        different minibatches): G forward in train mode, detached, then
        the D step at 2B rows."""
        with torch.no_grad():
            fake = self._g(inputs, lengths, True)
        return self._d_update(state, fake, inputs, labels, lengths, hp,
                              noise)

    def g_step(self, state: GanState, inputs, labels, lengths,
               hp: Dict[str, float],
               noise: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
        """One G update alone (graph-fed trainer semantics); counts a
        step, as the JAX ``g_step`` does."""
        g_out = self._g(inputs, lengths, True)
        m = self._g_update(state, g_out, inputs, labels, lengths, hp, noise)
        state.step += 1
        return m

    @torch.no_grad()
    def eval_step(self, state: GanState, inputs, labels, lengths,
                  hp: Dict[str, float],
                  noise: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
        """All losses, no updates (noise active, no activations kept)."""
        g_out = self._g(inputs, lengths, False)
        _, d_m, d_fk = self._d_loss(g_out, inputs, labels, lengths, hp,
                                    noise, train=False)
        adv = lsgan_g_adv_loss(d_fk, hp["d_real"])
        mse = g_mse_loss(g_out, labels, self.output_dim)
        return all_reduce_mean(current_world(), {
            **d_m, "g_adv_loss": adv, "g_mse_loss": mse,
            "g_l2_loss": torch.zeros((), device=adv.device),
            "g_loss": adv + hp["mse_lambda"] * mse})

    def train_step_gathered(self, state: GanState, inputs_tbl, labels_tbl,
                            starts, lengths, hp: Dict[str, float],
                            noise: Optional[torch.Generator], t_pad: int,
                            left: int, right: int
                            ) -> Dict[str, torch.Tensor]:
        """``train_step`` on the batch that ``starts``/``lengths`` ([B]
        int32 on the tables' device) plan in the resident tables."""
        x, y = assemble_sequence_batch(inputs_tbl, labels_tbl, starts,
                                       lengths, t_pad, left, right)
        return self.train_step(state, x, y, lengths, hp, noise)

    def eval_step_gathered(self, state: GanState, inputs_tbl, labels_tbl,
                           starts, lengths, hp: Dict[str, float],
                           noise: Optional[torch.Generator], t_pad: int,
                           left: int, right: int
                           ) -> Dict[str, torch.Tensor]:
        """``eval_step`` on a batch assembled from the resident tables."""
        x, y = assemble_sequence_batch(inputs_tbl, labels_tbl, starts,
                                       lengths, t_pad, left, right)
        return self.eval_step(state, x, y, lengths, hp, noise)

    def train_multi_step(self, *args, **kwargs):
        raise NotImplementedError(
            "the train_multi_step* scans are not ported: they amortised jit "
            "dispatch over same-shape batches, which an eager step does not "
            "need; call train_step (or train_step_gathered) per batch in "
            "the same order")

    train_multi_step_gathered = train_multi_step
    eval_multi_step_gathered = train_multi_step
