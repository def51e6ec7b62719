"""rsrgan_tpu_torch — the PyTorch and CUDA port of rsrgan_tpu.

The port runs on one NVIDIA H100. It mirrors the module names of
``rsrgan_tpu`` so that each counterpart is easy to find; the JAX package
stays the reference that every module here is tested against.

Layer map (what this package holds today — the flagship's training and
decode slices, and data preparation):
  data/      numpy copies of the Kaldi ark/scp (compressed matrices
             included), CMVN, splice, .rtu store, store preparation,
             TFRecord import, synthetic corpus, sequence-batcher and
             inference-batch codecs (no jax import); the device feed
  training/  the LSGAN trainer, losses, optimizers and EMA, schedules,
             checkpoints and periodic snapshots (a flax-msgpack reader
             and writer of the whole state), TensorBoard event files
  ops/       the eager peephole LSTM cell, dropout; the single-layer and
             wavefront LSTM kernels with their autograd, hand-written in
             CUDA (csrc/resident.cu, csrc/lstm_bwd.cu,
             csrc/wavefront_fwd.cu)
  models/    ResLstmGenerator, LstmGenerator, LstmDiscriminator and their
             registries
  cli/       ``python -m rsrgan_tpu_torch.cli.train`` (train, --decode)
             and ``python -m rsrgan_tpu_torch.cli.prepare``

This package imports ``torch`` and never ``jax``, ``flax`` or ``msgpack``.
"""

__version__ = "0.1.0"
