"""SEGAN's nets (counterpart of ``rsrgan_tpu/models/segan.py``): virtual
batch norm, the conv auto-encoder generator, the WaveNet-style generator
and the conv discriminator.

As in JAX, SEGAN works on spliced feature frames ``[B, W]``, not on raw
audio: each row is a 1-channel signal of length W. Activations are
``[B, C, L]`` here (flax's are ``[B, L, C]``); parameter names and
layouts are flax's (``enc_i``, ``dec_i``, ``dec_out``, ``enc_prelu_i``;
``g_residual_block_i/conv``, ...; ``d_block_i``, ``d_vbn_i``,
``logits_conv``, ``logits_out``; conv kernels ``[k, in, out]``), so a
flax tree loads by name. VBN's reference statistics are buffers, flax's
``vbn_stats`` collection.

The latent z of both generators is an argument: None gives zeros (JAX
without a ``z`` rng: decode and ``init_state``), a ``torch.Generator``
draws it, and a callable ``shape -> tensor`` (flax's layout, ``[B, L,
depth]``) hands in numbers another implementation drew.

No Pallas kernel lies here: JAX computes these convolutions with
``lax.conv_general_dilated``, and the port with ``F.conv1d`` and
``F.conv_transpose1d`` (``ops/modules.py``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from rsrgan_tpu_torch.ops.common import leakyrelu
from rsrgan_tpu_torch.ops.modules import Conv1d, ConvTranspose1d, Dense
from rsrgan_tpu_torch.parallel.mesh import (LocalDraws, current_world,
                                            global_moments)

DEFAULT_ENC_DEPTHS = (16, 32, 32, 64, 64, 128, 128, 256, 256, 512, 1024)
DEFAULT_DILATIONS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)

# Where N(0, 1) numbers come from (the latent z, D's input noise): a
# generator to draw them from, this rank's rows of draws at the global
# batch (``LocalDraws``), or a callable returning a tensor of the shape it
# is given; None means zeros (z) or none (noise).
NormalSource = Union[torch.Generator, LocalDraws,
                     Callable[[Tuple[int, ...]], torch.Tensor], None]


def draw_normal(source: NormalSource, shape: Tuple[int, ...],
                device) -> Optional[torch.Tensor]:
    """``shape`` standard normals from ``source`` on ``device`` (None for
    no source)."""
    if source is None:
        return None
    if isinstance(source, torch.Generator):
        return torch.randn(shape, generator=source, device=source.device
                           ).to(device)
    if isinstance(source, LocalDraws):
        return source.randn(shape).to(device)
    out = source(shape)
    if tuple(out.shape) != tuple(shape):
        raise ValueError(f"normals of shape {tuple(out.shape)}, wanted "
                         f"{tuple(shape)}")
    return out.to(device=device, dtype=torch.float32)


def _halved(length: int, times: int) -> int:
    """The length after ``times`` stride-2 "SAME" convolutions."""
    for _ in range(times):
        length = -(-length // 2)
    return length


def _as_channels(x: torch.Tensor) -> torch.Tensor:
    """[B, W] -> [B, 1, W]; flax's [B, L, C] -> [B, C, L]."""
    if x.ndim == 2:
        return x[:, None, :]
    if x.ndim == 3:
        return x.transpose(1, 2)
    raise ValueError("input must be 2-D or 3-D")


def _prelu(h: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """``relu(h) + alpha * (h - |h|) * 0.5``, alpha per channel."""
    return torch.relu(h) + alpha[:, None] * (h - torch.abs(h)) * 0.5


class VirtualBatchNorm(nn.Module):
    """The reference statistics ``ref_mean`` and ``ref_meansq`` (shape
    ``[1, 1, C]``, flax's) are frozen from the init batch; each call blends
    them ``1/(B+1)`` with the live batch's, over batch and length:
    ``(x - mean) / sqrt(eps + mean_sq - mean^2) * (1 + gamma) + beta``.
    ``capture`` set (``SeganDiscriminator.init_vbn_stats``), a call first
    takes the reference statistics from its input, as flax's init does.
    In a data-parallel world the live statistics and the batch size are
    the global batch's, as under JAX's mesh; the init batch is the whole
    global batch on every rank, so a capture takes its statistics
    locally."""

    flax_collection = "vbn_stats"
    flax_stats = ("ref_mean", "ref_meansq")

    def __init__(self, channels: int, epsilon: float = 1e-5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.epsilon = epsilon
        self.capture = False
        gamma = torch.empty(channels)
        with torch.no_grad():
            gamma.normal_(0.0, 0.02, generator=generator)
        self.gamma = nn.Parameter(gamma)
        self.beta = nn.Parameter(torch.zeros(channels))
        self.register_buffer("ref_mean", torch.zeros(1, 1, channels))
        self.register_buffer("ref_meansq", torch.zeros(1, 1, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        world = current_world()
        rows = x.shape[0]
        if world.data_size > 1 and not self.capture:
            batch_mean, batch_meansq = global_moments(x, (0, 2))
            rows *= world.data_size
        else:
            batch_mean = x.mean((0, 2))
            batch_meansq = torch.square(x).mean((0, 2))
        if self.capture:
            with torch.no_grad():
                self.ref_mean.copy_(batch_mean.reshape(1, 1, -1))
                self.ref_meansq.copy_(batch_meansq.reshape(1, 1, -1))
        new = 1.0 / (rows + 1.0)
        old = 1.0 - new
        mean = new * batch_mean + old * self.ref_mean.reshape(-1)
        mean_sq = new * batch_meansq + old * self.ref_meansq.reshape(-1)
        std = torch.sqrt(self.epsilon + mean_sq - torch.square(mean))
        return ((x - mean[:, None]) / std[:, None]
                * (1.0 + self.gamma)[:, None] + self.beta[:, None])


class SeganAEGenerator(nn.Module):
    """The auto-encoder G: ``len(enc_depths)`` stride-2 convolutions
    (``enc_i``, leakyrelu or PReLU ``enc_prelu_i``), the latent z
    concatenated before the deepest code, mirrored transposed convolutions
    (``dec_i``) each cut to its skip's length, activated
    and concatenated with it, the last one's single channel (or the mean
    of its channels) through ``dec_out`` to ``units``. ``input_width`` is
    W, which sizes ``dec_out`` (2 * ceil(W / 2) inputs)."""

    def __init__(self, input_width: int, units: int,
                 enc_depths: Sequence[int] = DEFAULT_ENC_DEPTHS,
                 kwidth: int = 20, z_on: bool = True, do_prelu: bool = False,
                 bias_downconv: bool = False, bias_deconv: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.enc_depths = tuple(enc_depths)
        self.z_on, self.do_prelu = z_on, do_prelu
        n = len(self.enc_depths)
        in_ch = 1
        for i, depth in enumerate(self.enc_depths):
            self.add_module(f"enc_{i}", Conv1d(
                in_ch, depth, kwidth, stride=2, use_bias=bias_downconv,
                generator=generator))
            if do_prelu:
                self.register_parameter(f"enc_prelu_{i}",
                                        nn.Parameter(torch.zeros(depth)))
            in_ch = depth
        if z_on:
            in_ch += self.enc_depths[-1]
        self.dec_depths = self.enc_depths[:-1][::-1] + (1,)
        for i, depth in enumerate(self.dec_depths):
            self.add_module(f"dec_{i}", ConvTranspose1d(
                in_ch, depth, kwidth, stride=2, use_bias=bias_deconv,
                generator=generator))
            if i < n - 1 and do_prelu:
                self.register_parameter(f"dec_prelu_{i}",
                                        nn.Parameter(torch.zeros(depth)))
            in_ch = 2 * depth   # concatenated with the skip
        self.dec_out = Dense(2 * _halved(input_width, 1), units, generator)

    def forward(self, x: torch.Tensor, z: NormalSource = None
                ) -> torch.Tensor:
        h = _as_channels(x)
        skips = []
        for i in range(len(self.enc_depths)):
            h = getattr(self, f"enc_{i}")(h)
            if i < len(self.enc_depths) - 1:
                skips.append(h)
            h = (_prelu(h, getattr(self, f"enc_prelu_{i}")) if self.do_prelu
                 else leakyrelu(h))
        if self.z_on:
            shape = (h.shape[0], h.shape[2], self.enc_depths[-1])
            zt = draw_normal(z, shape, h.device)
            zt = (torch.zeros(shape, device=h.device) if zt is None else zt)
            h = torch.cat([zt.transpose(1, 2), h], dim=1)
        last = len(self.dec_depths) - 1
        for i in range(len(self.dec_depths)):
            h = getattr(self, f"dec_{i}")(h)
            if i < last:
                # cut to the skip's length: the skip has L positions and
                # this output 2 * ceil(L / 2), never fewer (so the zero
                # pad of JAX's other branch never runs)
                skip = skips[-(i + 1)]
                h = h[:, :, :skip.shape[2]]
                h = (_prelu(h, getattr(self, f"dec_prelu_{i}"))
                     if self.do_prelu else leakyrelu(h))
                h = torch.cat([h, skip], dim=1)
        h = h[:, 0] if h.shape[1] == 1 else h.mean(1)
        return self.dec_out(h)


class SeganWaveGenerator(nn.Module):
    """The WaveNet-style G: the input and a ``z_depth``-channel z side by
    side, then gated dilated residual blocks (``g_residual_block_i/conv``
    and ``/conv_gate``, tanh x sigmoid, 1x1 ``/residual_conv1`` added to
    the block input's first channel, 1x1 ``/skip_conv1`` but in the last
    block, whose residual output is its skip), the skips summed,
    leakyrelu, 1x1 ``wave_conv1``, then ``wave_out`` over the W positions
    to ``units``."""

    def __init__(self, input_width: int, units: int,
                 dilations: Sequence[int] = DEFAULT_DILATIONS,
                 kwidth: int = 3, num_kernels: int = 32, z_depth: int = 1024,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dilations = tuple(dilations)
        self.z_depth = z_depth
        in_ch = 1 + z_depth
        for bi, dilation in enumerate(self.dilations):
            name = f"g_residual_block_{bi}"
            for part in ("conv", "conv_gate"):
                self.add_module(f"{name}/{part}", Conv1d(
                    in_ch, num_kernels, kwidth, dilation=dilation,
                    use_bias=False, generator=generator))
            self.add_module(f"{name}/residual_conv1", Conv1d(
                num_kernels, 1, 1, use_bias=False, generator=generator))
            if bi < len(self.dilations) - 1:
                self.add_module(f"{name}/skip_conv1", Conv1d(
                    num_kernels, 1, 1, use_bias=False, generator=generator))
            in_ch = 1
        self.wave_conv1 = Conv1d(1, 1, 1, use_bias=False, generator=generator)
        self.wave_out = Dense(input_width, units, generator)

    def forward(self, x: torch.Tensor, z: NormalSource = None
                ) -> torch.Tensor:
        h = _as_channels(x)
        shape = (h.shape[0], h.shape[2], self.z_depth)
        zt = draw_normal(z, shape, h.device)
        zt = torch.zeros(shape, device=h.device) if zt is None else zt
        h = torch.cat([h, zt.transpose(1, 2)], dim=1)
        skips = []
        for bi in range(len(self.dilations)):
            name = f"g_residual_block_{bi}"
            gated = (torch.tanh(getattr(self, f"{name}/conv")(h))
                     * torch.sigmoid(getattr(self, f"{name}/conv_gate")(h)))
            res = getattr(self, f"{name}/residual_conv1")(gated)
            res = res + h[:, :1] if h.shape[1] != 1 else res + h
            if bi < len(self.dilations) - 1:
                skips.append(getattr(self, f"{name}/skip_conv1")(gated))
            else:
                skips.append(res)
            h = res
        s = self.wave_conv1(leakyrelu(sum(skips)))
        return self.wave_out(s[:, 0])


class SeganDiscriminator(nn.Module):
    """D: ``len(num_fmaps)`` stride-2 convolutions of ``kwidth``
    (``d_block_i``), each with VBN (``d_vbn_i``) and leakyrelu, a
    ``kwidth`` convolution to one channel (``logits_conv``), then
    ``logits_out`` over the remaining positions to one logit. It sees
    ``input_width``-wide rows (the trainer's concat of the inputs and the
    target); its Gaussian input noise is the trainer's."""

    def __init__(self, input_width: int,
                 num_fmaps: Sequence[int] = DEFAULT_ENC_DEPTHS,
                 kwidth: int = 31, bias_conv: bool = True,
                 use_vbn: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_fmaps = tuple(num_fmaps)
        self.use_vbn = use_vbn
        in_ch = 1
        for i, fmaps in enumerate(self.num_fmaps):
            self.add_module(f"d_block_{i}", Conv1d(
                in_ch, fmaps, kwidth, stride=2, use_bias=bias_conv,
                generator=generator))
            if use_vbn:
                self.add_module(f"d_vbn_{i}",
                                VirtualBatchNorm(fmaps, generator=generator))
            in_ch = fmaps
        self.logits_conv = Conv1d(in_ch, 1, kwidth, use_bias=False,
                                  generator=generator)
        self.logits_out = Dense(_halved(input_width, len(self.num_fmaps)), 1,
                                generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _as_channels(x)
        for i in range(len(self.num_fmaps)):
            h = getattr(self, f"d_block_{i}")(h)
            if self.use_vbn:
                h = getattr(self, f"d_vbn_{i}")(h)
            h = leakyrelu(h)
        return self.logits_out(self.logits_conv(h)[:, 0])

    @torch.no_grad()
    def init_vbn_stats(self, x: torch.Tensor) -> None:
        """Take every VBN layer's reference statistics from the batch x,
        each from its own input in one pass (flax's ``init``)."""
        vbns = [m for m in self.modules() if isinstance(m, VirtualBatchNorm)]
        for m in vbns:
            m.capture = True
        try:
            self(x)
        finally:
            for m in vbns:
                m.capture = False
