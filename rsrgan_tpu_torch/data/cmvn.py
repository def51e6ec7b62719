"""Global CMVN statistics (numpy copy of ``rsrgan_tpu/data/cmvn.py``):
Kaldi stats read and written, accumulated, converted, applied and
undone. The Kaldi global-CMVN stats matrix has two rows::

    row 0: [ sum_x_0 ... sum_x_{D-1},  frame_count ]
    row 1: [ sumsq_0 ... sumsq_{D-1},  0          ]

mean = sum/count, stddev = sqrt(sumsq/count - mean^2).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from rsrgan_tpu_torch.data.kaldi_ark import read_matrix, write_matrix


@dataclass
class Cmvn:
    """Mean/stddev pair for one feature stream."""

    mean: np.ndarray
    stddev: np.ndarray

    def apply(self, feats: np.ndarray) -> np.ndarray:
        return (feats - self.mean) / self.stddev

    def denormalize(self, feats: np.ndarray) -> np.ndarray:
        return feats * self.stddev + self.mean


class CmvnAccumulator:
    """Streaming sum/sumsq accumulation (Kaldi compute-cmvn-stats)."""

    def __init__(self, dim: int):
        self.dim = dim
        self.sum = np.zeros(dim, dtype=np.float64)
        self.sumsq = np.zeros(dim, dtype=np.float64)
        self.count = 0.0

    def accumulate(self, feats: np.ndarray) -> None:
        feats = np.asarray(feats, dtype=np.float64)
        if feats.ndim != 2 or feats.shape[1] != self.dim:
            raise ValueError(f"expected [T, {self.dim}] features, got "
                             f"{feats.shape}")
        self.sum += feats.sum(axis=0)
        self.sumsq += np.square(feats).sum(axis=0)
        self.count += feats.shape[0]

    def stats_matrix(self) -> np.ndarray:
        """Kaldi-layout [2, dim+1] float64 stats matrix."""
        stats = np.zeros((2, self.dim + 1), dtype=np.float64)
        stats[0, :-1] = self.sum
        stats[0, -1] = self.count
        stats[1, :-1] = self.sumsq
        return stats

    def finalize(self) -> Cmvn:
        return cmvn_from_stats(self.stats_matrix())


def cmvn_from_stats(stats: np.ndarray) -> Cmvn:
    """A Kaldi [2, dim+1] stats matrix -> mean/stddev (no variance
    floor)."""
    count = stats[0][-1]
    moments = stats[:, :-1]
    mean = moments[0] / count
    stddev = np.sqrt(moments[1] / count - mean ** 2)
    return Cmvn(mean=mean, stddev=stddev)


def read_kaldi_cmvn(path: str, offset: int = 0) -> np.ndarray:
    """A binary Kaldi CMVN stats matrix, as float64."""
    with open(path, "rb") as f:
        f.seek(int(offset))
        return np.asarray(read_matrix(f), dtype=np.float64)


def write_kaldi_cmvn(path: str, stats: np.ndarray) -> None:
    """Stats as a binary Kaldi float matrix (readable by Kaldi tools)."""
    with open(path, "wb") as f:
        write_matrix(f, np.asarray(stats, dtype=np.float32))


def convert_cmvn_to_numpy(inputs_cmvn: str, labels_cmvn: str,
                          save_dir: str) -> str:
    """train_cmvn.npz from two Kaldi stats files (keys mean_inputs,
    stddev_inputs, mean_labels, stddev_labels); returns its path."""
    inputs = cmvn_from_stats(read_kaldi_cmvn(inputs_cmvn))
    labels = cmvn_from_stats(read_kaldi_cmvn(labels_cmvn))
    out = os.path.join(save_dir, "train_cmvn.npz")
    np.savez(out,
             mean_inputs=inputs.mean, stddev_inputs=inputs.stddev,
             mean_labels=labels.mean, stddev_labels=labels.stddev)
    return out


def load_cmvn_npz(path: str) -> Tuple[Cmvn, Cmvn]:
    """Load train_cmvn.npz -> (inputs_cmvn, labels_cmvn)."""
    with np.load(path) as data:
        return (Cmvn(data["mean_inputs"], data["stddev_inputs"]),
                Cmvn(data["mean_labels"], data["stddev_labels"]))
