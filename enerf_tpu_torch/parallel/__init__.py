"""Multi-GPU data parallelism; counterpart of ``enerf_tpu/parallel``.

The JAX package shards the batch over a device mesh inside one program;
the port runs one process a GPU under ``torch.distributed.run`` (the
reference's DDP, SURVEY.md §2.6): ``dist`` starts the process group and
says which rank this process is, ``models/layers.py``'s synced BatchNorm
makes the batch statistics those of the global batch, and
``train/step.py`` wraps the model in ``DistributedDataParallel`` and
splits a frame's rays over the ranks."""

from enerf_tpu_torch.parallel.dist import (
    all_reduce_sum,
    barrier,
    init_distributed,
    is_main,
    local_batch_slice,
    rank,
    spawn_ranks,
    unwrap,
    world_size,
)

__all__ = ["init_distributed", "rank", "world_size", "is_main", "barrier",
           "local_batch_slice", "all_reduce_sum", "unwrap",
           "spawn_ranks"]
