"""The host→device edge (pinned staging and async prefetch) and the
data-parallel gang: ``launch`` (``torch.distributed`` rendezvous, local
workers with the parameter-server role set, ssh command lines and the
submit CLI), ``backends`` (mpi, slurm, sge and kubernetes submit
generators), ``sharded`` (the part mesh, sharded ingest) and
``placement`` (``NamedSharding`` over the part mesh, ``PlacedTensor``,
``device_put``: which slice of an array each part holds). The package
exports the reference's names (``dmlc_tpu/parallel/__init__.py``)."""

from dmlc_tpu_torch.parallel.device_iter import DeviceIter, device_prefetch
from dmlc_tpu_torch.parallel.sharded import (
    ShardedRowBlockIter, make_global_batch, make_replicated,
    pad_to_bucket, stack_device_batches, stack_padded_rows, empty_block,
    next_pow2_bucket, ensure_schema,
)

__all__ = ["DeviceIter", "device_prefetch", "ShardedRowBlockIter",
           "make_global_batch", "make_replicated", "pad_to_bucket",
           "stack_device_batches", "stack_padded_rows", "empty_block",
           "next_pow2_bucket", "ensure_schema"]
