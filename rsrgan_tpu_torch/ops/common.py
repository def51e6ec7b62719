"""Shared elementwise ops (counterpart of ``rsrgan_tpu/ops/common.py``),
and flax's train-mode dropout."""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch


def leakyrelu(x: torch.Tensor, alpha: float = 0.3) -> torch.Tensor:
    """max(x, alpha*x) with the reference's alpha=0.3."""
    return torch.maximum(x, alpha * x)


def gaussian_noise(x: torch.Tensor, std: float,
                   noise: Union[torch.Generator, torch.Tensor, None]
                   ) -> torch.Tensor:
    """Additive input noise layer: x + std * N(0, 1).

    ``noise`` is a ``torch.Generator`` to draw the normals from, or a
    tensor of them of x's shape (so that a test can hand the port the
    numbers another implementation drew); None adds nothing. torch and
    jax.random draw different numbers from the same seed."""
    if noise is None:
        return x
    if isinstance(noise, torch.Generator):
        noise = torch.randn(x.shape, generator=noise, dtype=x.dtype,
                            device=noise.device)
    return x + std * noise.to(device=x.device, dtype=x.dtype)


# Where dropout masks come from: a generator to draw them from (what the
# trainer passes), or a callable that returns the keep mask (bool, of the
# shape it is given). The callable exists for tests, which hand the port
# the masks another implementation drew.
MaskSource = Union[torch.Generator, Callable[[Tuple[int, ...]], torch.Tensor]]


def dropout(x: torch.Tensor, keep_prob: float,
            masks: Optional[MaskSource]) -> torch.Tensor:
    """flax ``nn.Dropout(rate=1 - keep_prob, deterministic=False)``: keep
    each element with probability ``keep_prob`` (a uniform draw below
    it), divide what is kept by ``keep_prob`` and zero the rest. A
    generator draws on its own device. Train-mode dropout without a mask
    source is an error, not a no-op."""
    if masks is None:
        raise ValueError(
            f"dropout (keep_prob={keep_prob}) in train mode needs a mask "
            "source: a torch.Generator or a callable giving the keep mask")
    if isinstance(masks, torch.Generator):
        keep = torch.rand(x.shape, generator=masks,
                          device=masks.device) < keep_prob
    else:
        keep = masks(tuple(x.shape))
        if tuple(keep.shape) != tuple(x.shape) or keep.dtype != torch.bool:
            raise ValueError(f"keep mask {keep.dtype} {tuple(keep.shape)} "
                             f"for input {tuple(x.shape)}")
    return torch.where(keep.to(x.device), x / keep_prob, torch.zeros_like(x))
