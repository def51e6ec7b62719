"""Loss functions with the reference's scaling conventions (counterpart of
``rsrgan_tpu/training/losses.py``). Means are over the full padded
tensors, as the JAX package and the reference take them."""

from __future__ import annotations

from typing import Mapping, Tuple

import torch


def lsgan_d_losses(d_rl_logits: torch.Tensor, d_fk_logits: torch.Tensor,
                   d_real: float = 1.0, d_fake: float = 0.0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LSGAN discriminator losses -> (d_rl_loss, d_fk_loss, d_loss)."""
    d_rl = torch.mean(torch.square(d_rl_logits - d_real))
    d_fk = torch.mean(torch.square(d_fk_logits - d_fake))
    return d_rl, d_fk, d_rl + d_fk


def lsgan_g_adv_loss(d_fk_logits: torch.Tensor,
                     d_real: float = 1.0) -> torch.Tensor:
    """(D(G(x)) - d_real)^2."""
    return torch.mean(torch.square(d_fk_logits - d_real))


def g_mse_loss(g_out: torch.Tensor, labels: torch.Tensor,
               output_dim: int) -> torch.Tensor:
    """0.5 * MSE * output_dim."""
    return 0.5 * torch.mean(torch.square(g_out - labels)) * output_dim


def l2_loss_nonbias(params: Mapping[str, torch.Tensor],
                    l2_scale: float) -> torch.Tensor:
    """sum(||v||^2 / 2) * scale over the parameters whose name has no
    'bias' (the reference's name filter; names as the JAX tree paths,
    case-insensitive). At scale 0, a zero on the parameters' device: the
    CLI stacks it with the step's other metrics."""
    if l2_scale <= 0.0:
        device = next(iter(params.values())).device if params else None
        return torch.zeros((), dtype=torch.float32, device=device)
    total = 0.0
    for name in sorted(params):
        if "bias" in name.lower():
            continue
        total = total + 0.5 * torch.sum(torch.square(params[name]))
    return total * l2_scale
