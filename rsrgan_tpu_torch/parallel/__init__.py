"""Data parallelism (counterpart of ``rsrgan_tpu/parallel``).

JAX's single-process mesh (``--num_gpu=N``) and its multi-process runs
(``--coordinator_address``) become one design here: one process per rank,
one device per rank, every rank holding the whole state, its row block of
each global batch, and one all-reduce of the gradients and metrics per
update. ``--num_gpu=N`` spawns the N ranks (``launch``); multi-process
runs join them (``initialize``). Batch statistics (BatchNorm, BnLstm's
per-step statistics, SEGAN's VBN) are the global batch's
(``global_moments``), and batch-dependent draws are the global batch's
(``local_draws``). The learning rate follows LR x world, as JAX's
follows LR x the mesh's data axis.

Tensor parallelism (JAX's ``lstm_param_sharding``, ``shard_state(...,
tensor_parallel=True)``) is not here: no CLI flag reaches it
(ROADMAP.md, item 17).
"""

from rsrgan_tpu_torch.parallel.distributed import (backend_for,
                                                   free_port, initialize,
                                                   is_coordinator, launch,
                                                   shutdown)
from rsrgan_tpu_torch.parallel.mesh import (DataWorld, LocalDraws,
                                            all_reduce_mean, current_world,
                                            gather_rows, global_moments,
                                            local_draws, make_world,
                                            replicate, shard_batch)
