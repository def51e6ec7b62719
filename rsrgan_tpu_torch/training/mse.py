"""The MSE trainers (counterpart of ``rsrgan_tpu/training/mse.py``:
``MseState`` and ``MseTrainer``), for ``--trainer=rnn`` (sequence mode)
and ``--trainer=dnn`` (frame mode).

One step: G forward in train mode, loss = 0.5 * MSE * output_dim + L2 of
the non-bias weights, its gradient by autograd, each tensor clipped to
``max_grad_norm`` (15 for ``rnn``, none for ``dnn``), Adam, EMA decay
0.9999. A train-mode forward updates G's BatchNorm running statistics
(``NetState.extra``) in place, as the JAX step returns the mutated
``batch_stats``. In sequence mode G takes ``(inputs [B, T, D], lengths)``;
in frame mode spliced frames ``[B, splice * D]`` and no lengths. Dropout
masks come from ``masks`` (``seed_dropout``). State is updated in place.

``train_step_gathered`` and ``eval_step_gathered`` first assemble their
batch on the device from resident tables and a ``[B]`` plan
(``ops/gather.py``), as ``GanTrainer``'s do. The ``train_multi_step*``
scans are not ported (they amortised jit dispatch), nor is
``infer_with_params``, which nothing in the JAX package calls: the port's
modules hold their weights, so a tree is loaded (``load_flax_params``,
``load_batch_stats``) and ``infer_step`` runs it.

In a data-parallel world (``parallel``) each rank steps on its rows of
the global batch: the gradients and metrics are averaged over the world
before the clip, eval metrics too, the dropout masks are this rank's rows
of the draws at the global batch, and G's batch statistics are the
global batch's.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from rsrgan_tpu_torch import spans
from rsrgan_tpu_torch.ops.common import MaskSource
from rsrgan_tpu_torch.ops.gather import assemble_sequence_batch
from rsrgan_tpu_torch.parallel.mesh import (all_reduce_mean, current_world,
                                            local_draws)
from rsrgan_tpu_torch.training.losses import g_mse_loss, l2_loss_nonbias
from rsrgan_tpu_torch.training.state import NetState, world_mean


class MseState:
    """G's state and the step count."""

    def __init__(self, net: NetState, step: int = 0):
        self.net, self.step = net, step


class MseTrainer:
    """Supervised trainer for any generator of the zoo.

    ``sequence_mode``: G takes (inputs, lengths); otherwise frames.
    ``masks``: the dropout's mask source (``ops.common.MaskSource``),
    needed where G has ``keep_prob < 1``; ``grad_log``: set to a list to
    record each update's gradients before clipping.
    """

    def __init__(self, generator: nn.Module, *, output_dim: int,
                 l2_scale: float = 0.0,
                 max_grad_norm: Optional[float] = None,
                 ema_decay: float = 0.9999, optimizer: str = "adam",
                 sequence_mode: bool = True):
        self.generator = generator
        self.output_dim = output_dim
        self.l2_scale = l2_scale
        self.max_grad_norm = max_grad_norm
        self.ema_decay = ema_decay
        self.optimizer = optimizer
        self.sequence_mode = sequence_mode
        self.masks: Optional[MaskSource] = None
        self.grad_log: Optional[list] = None

    def seed_dropout(self, seed: int, device) -> None:
        """G's dropout masks from a generator on ``device`` seeded with
        ``seed`` (as ``GanTrainer.seed_dropout`` seeds G's)."""
        self.masks = torch.Generator(device=device).manual_seed(seed)

    def init_state(self) -> MseState:
        return MseState(NetState(self.generator, self.optimizer,
                                 self.max_grad_norm))

    def _g(self, inputs, lengths, train: bool) -> torch.Tensor:
        masks = local_draws(self.masks) if train else None
        if self.sequence_mode:
            return self.generator(inputs, lengths, train, masks=masks)
        return self.generator(inputs, train=train, masks=masks)

    def train_step(self, state: MseState, inputs, labels, lengths,
                   lr: float) -> Dict[str, torch.Tensor]:
        """One update on one batch; returns the metrics (device
        scalars)."""
        with spans.span("train.step"):
            g_out = self._g(inputs, lengths, True)
            mse = g_mse_loss(g_out, labels, self.output_dim)
            params = state.net.params()
            l2 = l2_loss_nonbias(params, self.l2_scale)
            loss = mse + l2
            names = list(params)
            with spans.span("train.backward"):
                grads = torch.autograd.grad(loss,
                                            [params[n] for n in names])
            grads, metrics = world_mean(
                dict(zip(names, grads)),
                {"g_mse_loss": mse.detach(), "g_l2_loss": l2.detach(),
                 "g_loss": loss.detach()})
            if self.grad_log is not None:
                self.grad_log.append({k: g.detach().clone()
                                      for k, g in grads.items()})
            state.net.apply_gradients(grads, lr, self.ema_decay)
            state.step += 1
            return metrics

    @torch.no_grad()
    def eval_step(self, state: MseState, inputs, labels,
                  lengths) -> Dict[str, torch.Tensor]:
        """The MSE of G in eval mode (BatchNorm on its running
        statistics); no L2, no update."""
        mse = g_mse_loss(self._g(inputs, lengths, False), labels,
                         self.output_dim)
        return all_reduce_mean(current_world(), {
            "g_mse_loss": mse,
            "g_l2_loss": torch.zeros((), device=mse.device),
            "g_loss": mse})

    @torch.no_grad()
    def infer_step(self, state: MseState, inputs,
                   lengths=None) -> torch.Tensor:
        """G forward in eval mode (decode)."""
        return self._g(inputs, lengths, False)

    def train_step_gathered(self, state: MseState, inputs_tbl, labels_tbl,
                            starts, lengths, lr: float, t_pad: int,
                            left: int, right: int
                            ) -> Dict[str, torch.Tensor]:
        """``train_step`` on the batch that ``starts``/``lengths`` ([B]
        int32 on the tables' device) plan in the resident tables."""
        x, y = assemble_sequence_batch(inputs_tbl, labels_tbl, starts,
                                       lengths, t_pad, left, right)
        return self.train_step(state, x, y, lengths, lr)

    def eval_step_gathered(self, state: MseState, inputs_tbl, labels_tbl,
                           starts, lengths, t_pad: int, left: int,
                           right: int) -> Dict[str, torch.Tensor]:
        """``eval_step`` on a batch assembled from the resident tables."""
        x, y = assemble_sequence_batch(inputs_tbl, labels_tbl, starts,
                                       lengths, t_pad, left, right)
        return self.eval_step(state, x, y, lengths)

    def train_multi_step(self, *args, **kwargs):
        raise NotImplementedError(
            "the train_multi_step* scans are not ported: they amortised jit "
            "dispatch over same-shape batches, which an eager step does not "
            "need; call train_step (or train_step_gathered) per batch in "
            "the same order")

    train_multi_step_gathered = train_multi_step
    eval_multi_step_gathered = train_multi_step
