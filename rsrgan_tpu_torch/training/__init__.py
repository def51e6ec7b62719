"""Training layer of the port: checkpoints and periodic snapshots (flax
msgpack, the whole train state), losses, optimizers and EMA, schedules,
TensorBoard event files, and the LSGAN trainer."""

from rsrgan_tpu_torch.training.checkpoints import (latest_checkpoint,
                                                   load_checkpoint,
                                                   load_generator_params,
                                                   load_newest_state,
                                                   load_state_tree,
                                                   msgpack_restore,
                                                   msgpack_serialize,
                                                   periodic_snapshot_path,
                                                   read_checkpoint,
                                                   read_checkpoint_meta,
                                                   save_checkpoint,
                                                   save_periodic_snapshot,
                                                   state_tree)
from rsrgan_tpu_torch.training.gan import (GanState, GanTrainer,
                                           default_hparams)
from rsrgan_tpu_torch.training.schedules import (ImprovementTracker,
                                                 exponential_decay)
from rsrgan_tpu_torch.training.state import NetState, make_optimizer
