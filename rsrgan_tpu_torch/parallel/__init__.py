"""Data and tensor parallelism (counterpart of ``rsrgan_tpu/parallel``).

JAX's single-process mesh (``--num_gpu=N``) and its multi-process runs
(``--coordinator_address``) become one design here: one process per rank,
one device per rank, every rank holding the whole state, its row block of
each global batch, and one all-reduce of the gradients and metrics per
update. ``--num_gpu=N`` spawns the N ranks (``launch``); multi-process
runs join them (``initialize``). Batch statistics (BatchNorm, BnLstm's
per-step statistics, SEGAN's VBN) are the global batch's
(``global_moments``), and batch-dependent draws are the global batch's
(``local_draws``). The learning rate follows LR x the data axis, as
JAX's follows LR x the mesh's data axis.

JAX's model axis is a library feature, as in JAX (no CLI flag reaches
it): ``make_world(device, model_parallel=m)`` lays the ranks out as a
(data, model) grid, ``lstm_param_sharding`` is JAX's placement rule for
the LSTM cells' kernels, biases and projections, and ``shard_state(world,
state, tensor_parallel=True)`` keeps each rank's model block of their EMA
and optimizer moments, the module's weights whole for the kernels.
"""

from rsrgan_tpu_torch.parallel.distributed import (backend_for,
                                                   free_port, initialize,
                                                   is_coordinator, launch,
                                                   shutdown)
from rsrgan_tpu_torch.parallel.mesh import (DataWorld, LocalDraws,
                                            all_reduce_mean, current_world,
                                            gather_rows, global_moments,
                                            local_draws, lstm_param_sharding,
                                            make_world, model_block,
                                            replicate, shard_batch,
                                            shard_state)
