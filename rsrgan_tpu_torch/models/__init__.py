"""Model registry of the port (``rsrgan_tpu/models/__init__.py``).

Generators: ``lstm`` and the residual-LSTM family; every other
``--g_type`` raises ``NotImplementedError`` naming its ROADMAP.md item.
Discriminators: the sequence LSTM-D; the frame DNN-D raises likewise.
"""

from __future__ import annotations

from typing import Optional

import torch

from rsrgan_tpu_torch.models.discriminators import LstmDiscriminator
from rsrgan_tpu_torch.models.recurrent import (LstmGenerator,
                                               ResLstmGenerator,
                                               flatten_tree,
                                               load_flax_params, module_tree,
                                               unflatten_tree)

SEQUENCE_G_TYPES = ("lstm", "bnlstm", "res_lstm_base", "res_lstm_i",
                    "res_lstm_l")
FRAME_G_TYPES = ("dnn", "rced", "cnn")

_NOT_PORTED = {
    "bnlstm": "Queue 1, 'BNLSTM and SEGAN'",
    "dnn": "Queue 1, 'MSE and frame trainers'",
    "rced": "Queue 1, 'MSE and frame trainers'",
    "cnn": "Queue 1, 'MSE and frame trainers'",
}


def get_generator(g_type: str, *, input_dim: int, output_dim: int,
                  keep_prob: float = 1.0,
                  compute_dtype: torch.dtype = torch.float32,
                  lstm_impl: str = "wavefront",
                  generator: Optional[torch.Generator] = None):
    if g_type == "lstm":
        return LstmGenerator(input_dim, output_dim, keep_prob=keep_prob,
                             compute_dtype=compute_dtype,
                             lstm_impl=lstm_impl, generator=generator)
    if g_type in ("res_lstm_base", "res_lstm_i", "res_lstm_l"):
        return ResLstmGenerator(input_dim, output_dim,
                                variant=g_type.rsplit("_", 1)[-1],
                                keep_prob=keep_prob,
                                compute_dtype=compute_dtype,
                                lstm_impl=lstm_impl, generator=generator)
    if g_type in _NOT_PORTED:
        raise NotImplementedError(
            f"g_type {g_type} is not ported yet; see ROADMAP.md, "
            f"{_NOT_PORTED[g_type]}")
    raise ValueError(f"Unrecognized G type {g_type}")


def get_discriminator(d_type: str = "lstm", *, input_dim: int = 40,
                      keep_prob: float = 1.0,
                      compute_dtype: torch.dtype = torch.float32,
                      lstm_impl: str = "scan",
                      generator: Optional[torch.Generator] = None):
    """LSTM-D at its reference sizes: 2 x LSTM(256, proj 40) on
    ``input_dim``-wide frames (G's output dim; 40 in the reference)."""
    if d_type == "lstm":
        return LstmDiscriminator(input_dim=input_dim, keep_prob=keep_prob,
                                 compute_dtype=compute_dtype,
                                 lstm_impl=lstm_impl, generator=generator)
    if d_type == "dnn":
        raise NotImplementedError(
            "the frame discriminator (DNN-D) is not ported yet; see "
            "ROADMAP.md, Queue 1, 'MSE and frame trainers'")
    raise ValueError(f"Unrecognized D type {d_type}")
