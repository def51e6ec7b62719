"""Online serving: chunked enhancement with carried recurrent state
(counterpart of ``rsrgan_tpu/serving/``)."""

from rsrgan_tpu_torch.serving.pool import StreamPool
from rsrgan_tpu_torch.serving.streaming import StreamingEnhancer
from rsrgan_tpu_torch.serving.wav_stream import StreamingWavEnhancer

__all__ = ["StreamingEnhancer", "StreamingWavEnhancer", "StreamPool"]
