"""A seeded synthetic corpus (numpy copy of
``rsrgan_tpu/data/synthetic.py``): LPS-like inputs and MFCC-like labels
with a fixed linear + tanh relation, written as the Kaldi front end's
artifacts (arks, scp files and CMVN stats). With the same arguments it
writes the same bytes as the JAX package's."""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from rsrgan_tpu_torch.data.cmvn import CmvnAccumulator, write_kaldi_cmvn
from rsrgan_tpu_torch.data.kaldi_ark import ArkWriter


def make_synthetic_corpus(data_dir: str, num_utts: int = 20,
                          input_dim: int = 257, output_dim: int = 40,
                          min_len: int = 150, max_len: int = 400,
                          seed: int = 0) -> Tuple[str, str]:
    """Write inputs.ark/scp, labels.ark/scp and {inputs,labels}.cmvn;
    returns (inputs_scp, labels_scp)."""
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(input_dim, output_dim)).astype(np.float32) * 0.05

    in_scp = os.path.join(data_dir, "inputs.scp")
    lab_scp = os.path.join(data_dir, "labels.scp")
    in_ark = os.path.join(data_dir, "inputs.ark")
    lab_ark = os.path.join(data_dir, "labels.ark")
    for path in (in_ark, lab_ark):
        if os.path.exists(path):
            os.remove(path)

    acc_i = CmvnAccumulator(input_dim)
    acc_l = CmvnAccumulator(output_dim)
    with ArkWriter(in_scp) as win, ArkWriter(lab_scp) as wlab:
        for i in range(num_utts):
            T = int(rng.integers(min_len, max_len + 1))
            x = rng.normal(loc=2.0, scale=3.0,
                           size=(T, input_dim)).astype(np.float32)
            y = (np.tanh(x @ w)
                 + 0.01 * rng.normal(size=(T, output_dim))).astype(
                     np.float32)
            utt = f"utt{i:04d}"
            win.write_next_utt(in_ark, utt, x)
            wlab.write_next_utt(lab_ark, utt, y)
            acc_i.accumulate(x)
            acc_l.accumulate(y)
    write_kaldi_cmvn(os.path.join(data_dir, "inputs.cmvn"),
                     acc_i.stats_matrix())
    write_kaldi_cmvn(os.path.join(data_dir, "labels.cmvn"),
                     acc_l.stats_matrix())
    return in_scp, lab_scp
