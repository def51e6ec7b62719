"""rsrgan_tpu_torch — the PyTorch and CUDA port of rsrgan_tpu.

The port runs on one NVIDIA H100. It mirrors the module names of
``rsrgan_tpu`` so that each counterpart is easy to find; the JAX package
stays the reference that every module here is tested against.

Layer map (what this package holds today — the LSGAN, MSE and frame
trainers and their decode on one device or data parallel, data
preparation, the waveform chain from a wave to a score, streaming
serving and the recognition proxy):
  sim/       numpy and scipy copies of the corpus simulation: wav I/O,
             RIR convolution and SNR mixing, synthetic speech and rooms
  features/  the LPS and hires MFCC front-end in PyTorch on any device
             (batched ``[B, samples]``), resynthesis (numpy)
  eval/      numpy copies of the metrics: SNR, SI-SNR, segmental SNR,
             LSD, feature MSE, global variance, STOI and ESTOI
  data/      numpy copies of the Kaldi ark/scp (compressed matrices
             included), CMVN, splice, .rtu store, store preparation,
             TFRecord import, synthetic corpus, sequence and frame
             batchers and inference-batch codecs (no jax import); the
             device feed
  training/  the LSGAN trainer (sequence and frame), the MSE trainer,
             losses, optimizers and EMA, schedules, checkpoints and
             periodic snapshots (a flax-msgpack reader and writer of the
             whole state), TensorBoard event files
  ops/       the eager peephole LSTM cell, dropout; the single-layer and
             wavefront LSTM kernels with their autograd, hand-written in
             CUDA (csrc/resident.cu, csrc/lstm_bwd.cu,
             csrc/wavefront_fwd.cu)
  models/    ResLstmGenerator, LstmGenerator, the frame generators DNN,
             R-CED and CNN, LstmDiscriminator, DnnDiscriminator, their
             registries and the weight bridge to flax trees
  parallel/  data parallelism: a rank a process and a device (gloo or
             NCCL by layout), the world's mean of each update, the global
             batch's statistics and draws, the launcher of --num_gpu
  serving/   chunked enhancement with carried LSTM state (the eager
             cell on the card), wav -> wav streaming (host numpy DSP) and
             the batched multi-stream pool
  cli/       ``python -m rsrgan_tpu_torch.cli.train`` (train, --decode,
             --profile_dir), ``serve`` (features or wavs, streamed),
             ``prepare``, ``simulate``, ``extract`` (on the card),
             ``resynth``, ``score`` and ``plot``
  device.py  the run's device (a missing card is an error, never a
             fall-back to the CPU) and f32 without TF32
  tools/     ``e2e_chain`` (the recipes' wave-to-score chains through the
             CLIs, with their gates), ``proxy_asr`` (the recognition
             proxy: a frame classifier trained on clean features scores
             enhanced ones) and the kernels' timing tools

This package imports ``torch`` and never ``jax``, ``flax`` or ``msgpack``.
"""

__version__ = "0.1.0"
