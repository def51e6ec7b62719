"""Model registry of the port (``rsrgan_tpu/models/__init__.py``).

Generators: the sequence models ``lstm``, ``bnlstm`` and the
residual-LSTM family, and the frame models ``dnn``, ``rced`` and ``cnn``.
Discriminators: the sequence LSTM-D and the frame DNN-D. SEGAN's nets
(``models/segan.py``) are built by the CLI from its own flags, as in JAX.
``models/bridge.py`` carries flax trees (params and the mutable
collections) in and out.
"""

from __future__ import annotations

from typing import Optional

import torch

from rsrgan_tpu_torch.models.bridge import (batch_stats_tree,
                                            collections_tree, flatten_tree,
                                            load_batch_stats,
                                            load_collections,
                                            load_flax_params, module_tree,
                                            unflatten_tree)
from rsrgan_tpu_torch.models.discriminators import (DnnDiscriminator,
                                                    LstmDiscriminator)
from rsrgan_tpu_torch.models.feedforward import (CnnGenerator, DnnGenerator,
                                                 RcedGenerator)
from rsrgan_tpu_torch.models.recurrent import (BnLstmGenerator,
                                               LstmGenerator,
                                               ResLstmGenerator)

SEQUENCE_G_TYPES = ("lstm", "bnlstm", "res_lstm_base", "res_lstm_i",
                    "res_lstm_l")
FRAME_G_TYPES = ("dnn", "rced", "cnn")


def get_generator(g_type: str, *, input_dim: int, output_dim: int,
                  left_context: int = 0, right_context: int = 0,
                  keep_prob: float = 1.0, batch_norm: bool = False,
                  compute_dtype: torch.dtype = torch.float32,
                  lstm_impl: str = "wavefront",
                  generator: Optional[torch.Generator] = None):
    """``input_dim`` is one frame's width; a model sees ``input_dim *
    (left_context + 1 + right_context)`` (spliced frames). ``batch_norm``
    reaches ``dnn`` and ``rced`` (as in JAX, ``cnn`` and the sequence
    models have none); the frame models run in f32. ``bnlstm`` has no
    dropout and runs its eager cell whatever ``lstm_impl`` says."""
    splice = left_context + 1 + right_context
    width = input_dim * splice
    if g_type == "lstm":
        return LstmGenerator(width, output_dim, keep_prob=keep_prob,
                             compute_dtype=compute_dtype,
                             lstm_impl=lstm_impl, generator=generator)
    if g_type == "bnlstm":
        return BnLstmGenerator(width, output_dim,
                               compute_dtype=compute_dtype,
                               generator=generator)
    if g_type in ("res_lstm_base", "res_lstm_i", "res_lstm_l"):
        return ResLstmGenerator(width, output_dim,
                                variant=g_type.rsplit("_", 1)[-1],
                                keep_prob=keep_prob,
                                compute_dtype=compute_dtype,
                                lstm_impl=lstm_impl, generator=generator)
    if g_type == "dnn":
        return DnnGenerator(width, output_dim, keep_prob=keep_prob,
                            batch_norm=batch_norm, generator=generator)
    if g_type == "rced":
        return RcedGenerator(input_dim, splice, output_dim,
                             batch_norm=batch_norm, generator=generator)
    if g_type == "cnn":
        return CnnGenerator(input_dim, splice, output_dim,
                            generator=generator)
    raise ValueError(f"Unrecognized G type {g_type}")


def get_discriminator(d_type: str = "lstm", *, input_dim: int = 40,
                      keep_prob: float = 1.0,
                      compute_dtype: torch.dtype = torch.float32,
                      lstm_impl: str = "scan",
                      generator: Optional[torch.Generator] = None):
    """LSTM-D at its reference sizes (2 x LSTM(256, proj 40)) or DNN-D
    (4 x Dense(1024)), on ``input_dim``-wide frames (G's output dim, 40
    in the reference; the conditioned frame D adds the input frame's)."""
    if d_type == "lstm":
        return LstmDiscriminator(input_dim=input_dim, keep_prob=keep_prob,
                                 compute_dtype=compute_dtype,
                                 lstm_impl=lstm_impl, generator=generator)
    if d_type == "dnn":
        return DnnDiscriminator(input_dim, keep_prob=keep_prob,
                                generator=generator)
    raise ValueError(f"Unrecognized D type {d_type}")
