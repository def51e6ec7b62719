"""Data layer of the port: numpy copies of the codecs, the store's
preparation and the batchers."""

from rsrgan_tpu_torch.data.cmvn import (Cmvn, CmvnAccumulator,
                                        cmvn_from_stats,
                                        convert_cmvn_to_numpy, load_cmvn_npz,
                                        read_kaldi_cmvn, write_kaldi_cmvn)
from rsrgan_tpu_torch.data.dataset import (SequenceBatch, SequenceBatcher,
                                           ThreadedPrefetcher, bucket_id,
                                           infer_batches, padded_length)
from rsrgan_tpu_torch.data.kaldi_ark import (ArkWriter, ScpReader,
                                             read_ark_matrix, read_matrix,
                                             read_scp, write_matrix)
from rsrgan_tpu_torch.data.splice import splice_frames_np
from rsrgan_tpu_torch.data.store import (StoreView, StoreWriter,
                                         UtteranceStore,
                                         build_store_from_scp,
                                         read_list_file, verify_store)
