"""Objective speech-enhancement metrics (numpy and scipy copies of
``rsrgan_tpu/eval/``)."""

from rsrgan_tpu_torch.eval.metrics import (feature_mse, lsd_from_lps,
                                           seg_snr, si_snr, snr,
                                           variance_ratio)
from rsrgan_tpu_torch.eval.stoi import estoi, stoi, stoi_both

__all__ = ["si_snr", "snr", "seg_snr", "lsd_from_lps", "feature_mse",
           "variance_ratio", "stoi", "estoi", "stoi_both"]
