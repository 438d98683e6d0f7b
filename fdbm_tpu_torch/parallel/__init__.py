"""Data parallelism of the port: process groups (``distributed``) and the
data-parallel steps and batch-split serving (``mesh``); see
``fdbm_tpu/parallel/`` for the JAX package's."""

from fdbm_tpu_torch.parallel.distributed import (VALID_METRIC_SCHEMA, all_gather_host_metrics,
                                                 initialize, process_count, process_index)
from fdbm_tpu_torch.parallel.mesh import (data_parallel_train_step, data_parallel_valid_step,
                                          make_mesh, make_parallel_enhance, shard_batch)

__all__ = [
    "make_mesh",
    "make_parallel_enhance",
    "data_parallel_train_step",
    "data_parallel_valid_step",
    "shard_batch",
    "all_gather_host_metrics",
    "initialize",
    "process_index",
    "process_count",
    "VALID_METRIC_SCHEMA",
]
