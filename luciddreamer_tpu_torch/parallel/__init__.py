"""Multi-device rendering and training on ``torch.distributed`` (the twin
of ``luciddreamer_tpu/parallel``): a (data, tiles) mesh of processes,
tile-row sharded renders and training steps, the overlapped ring
reduction, ``ShardedTrainer`` and the multi-process helpers."""

from luciddreamer_tpu_torch.parallel.sharded import (
    make_mesh,
    render_sharded,
    render_sharded_batch,
    sharded_loss_fn,
    sharded_train_step,
    sharded_train_step_batch,
)
from luciddreamer_tpu_torch.parallel.trainer import ShardedTrainer
from luciddreamer_tpu_torch.parallel.overlap import (
    ring_all_reduce,
    sharded_train_step_overlapped,
)

__all__ = [
    "ShardedTrainer",
    "ring_all_reduce",
    "sharded_train_step_overlapped",
    "make_mesh",
    "render_sharded",
    "render_sharded_batch",
    "sharded_loss_fn",
    "sharded_train_step",
    "sharded_train_step_batch",
]
