"""Kaldi-parity feature front-end: LPS spectrogram and hires MFCC in
PyTorch on any device, and resynthesis (numpy), ported from
``rsrgan_tpu/features/``."""

from rsrgan_tpu_torch.features.frontend import (FrameOptions,
                                                SpectrogramOptions,
                                                compute_spectrogram,
                                                compute_spectrogram_np,
                                                feature_window, num_frames)
from rsrgan_tpu_torch.features.mfcc import (MelOptions, MfccOptions,
                                            compute_mfcc, compute_mfcc_np,
                                            dct_matrix, hires_mfcc_options,
                                            lifter_coeffs, mel_banks)
