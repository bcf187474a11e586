"""Device ops over CSR batches: the CUDA kernels and their plain versions.

The package exports the reference's ops (``dmlc_tpu/ops/__init__.py``);
importing it builds nothing: a kernel is built in the call that first
launches it."""

from dmlc_tpu_torch.ops.csr import (
    csr_to_padded_rows, spmv, csr_to_dense, segment_spmv, sdot_rows,
    sharded_spmv, csr_row_ids,
)

__all__ = ["csr_to_padded_rows", "spmv", "csr_to_dense", "segment_spmv",
           "sdot_rows", "sharded_spmv", "csr_row_ids"]
