"""Data layer of the port: numpy copies of the codecs and batchers."""

from rsrgan_tpu_torch.data.cmvn import Cmvn, load_cmvn_npz
from rsrgan_tpu_torch.data.dataset import (SequenceBatch, SequenceBatcher,
                                           ThreadedPrefetcher, bucket_id,
                                           infer_batches, padded_length)
from rsrgan_tpu_torch.data.kaldi_ark import (ArkWriter, ScpReader,
                                             read_ark_matrix, read_matrix,
                                             read_scp, write_matrix)
from rsrgan_tpu_torch.data.splice import splice_frames_np
from rsrgan_tpu_torch.data.store import (StoreView, StoreWriter,
                                         UtteranceStore, read_list_file)
