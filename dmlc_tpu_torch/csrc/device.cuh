// The device properties that the kernels' launchers read, in one place
// (its torch twin: dmlc_tpu_torch/ops/kernels.py max_shared_bytes, which
// reads it through dmlc_max_shared_bytes in csr_spmv.cu).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dmlc_device {

// The dynamic shared memory a block may take without opting in.
constexpr int64_t kDefaultSharedBytes = 48 * 1024;

// Sets *out to the most shared memory, static and dynamic together, that
// a block may opt in to on the current device; *out is left alone on an
// error, which is returned.
inline cudaError_t max_shared_bytes(int64_t* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  *out = optin;
  return cudaSuccess;
}

}  // namespace dmlc_device
