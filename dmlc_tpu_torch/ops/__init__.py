"""Device ops over CSR batches: the CUDA kernels and their plain versions."""
