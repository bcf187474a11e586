// CSR sparse matrix-vector product and its weight-gradient transpose,
// hand-written for Hopper (sm_90a), with a plain C interface bound by
// ctypes from dmlc_tpu_torch/ops/csr.py.
//
// What they replace. The JAX package has no hand-written device kernel:
// XLA compiled these computations from jnp.
//   K1 csr_spmv    <- dmlc_tpu/ops/csr.py:46 segment_spmv (with
//                     csr_row_ids :35): y[i] = sum over offset[i] <= k <
//                     offset[i+1] of value[k] * w[index[k]].
//   K2 csr_spmv_t  <- the gradient of K1 in w that jax.value_and_grad
//                     derives in dmlc_tpu/models/common.py:89-93:
//                     grad_w[index[k]] += value[k] * g[row(k)].
//
// Semantics kept from the reference:
//   - an index maps by the reference's rule (index.cuh: low 32 bits,
//     signed, negative counted from the end); an invalid one reads no
//     memory; K1 gives its row NaN (jnp.take fills NaN out of range), K2
//     drops its contribution (the gradient of the filled take drops it);
//   - rows are those of offset[0..num_rows]; nonzeros past offset[num_rows]
//     (the padded tail) are never visited, as segment_sum drops them.
//
// Bound on the card (H100 SXM, 3.35 TB/s). Both kernels move bytes and do
// almost no arithmetic (2 flops per nonzero). K1 reads index and value
// once (8 B per nonzero with a u32 index), offset and y once per row
// (12 B), and gathers w[index[k]]: 4 B per nonzero at most, and far less
// from device memory, since the 4 MB of w at full width stay in the 50 MB
// L2. At the main path's batch (8192 rows, about 290k nonzeros) that is
// about 3 MB: about 1 us at the memory rate. K2 moves the same bytes plus
// one 4-byte atomic per nonzero into grad_w. At these sizes both are
// bound by launch latency more than by bytes.
//
// Design. One warp per row: lanes stride over the row's nonzeros
// (coalesced index/value reads), gather w through the read-only path,
// accumulate in fp32 and reduce with warp shuffles. No row-id array is
// built. Criteo rows carry 25-44 nonzeros, so a warp's lanes are mostly
// busy for one or two strides. K2 scatters with fp32 atomicAdd into a
// zeroed grad_w; the order of atomics varies from run to run, so K2 is
// not bitwise deterministic. Both kernels launch on the caller's stream
// and allocate nothing; each C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "index.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;  // 8 warps = 8 rows per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void row_range(const int64_t* offset, int64_t row,
                                          int64_t nnz, int64_t* lo,
                                          int64_t* hi) {
  int64_t a = offset[row];
  int64_t b = offset[row + 1];
  // a corrupt offset array must not send a warp past index/value
  *lo = a < 0 ? 0 : (a > nnz ? nnz : a);
  *hi = b < *lo ? *lo : (b > nnz ? nnz : b);
}

template <typename IndexT>
__global__ void __launch_bounds__(kThreads)
    csr_spmv_kernel(const int64_t* __restrict__ offset,
                    const IndexT* __restrict__ index,
                    const float* __restrict__ value,
                    const float* __restrict__ w, int64_t num_rows,
                    int64_t nnz, int64_t num_features, float* __restrict__ y) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= num_rows) return;  // uniform across the warp
  int64_t lo, hi;
  row_range(offset, row, nnz, &lo, &hi);
  float acc = 0.0f;
  int bad = 0;
  for (int64_t k = lo + lane; k < hi; k += kWarp) {
    int64_t j;
    if (dmlc_index::wrap(index[k], num_features, &j)) {
      acc = fmaf(value[k], __ldg(w + j), acc);
    } else {
      bad = 1;
    }
  }
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    acc += __shfl_down_sync(kFull, acc, o);
  }
  bad = __any_sync(kFull, bad);
  if (lane == 0) y[row] = bad ? __int_as_float(0x7fc00000) : acc;  // NaN
}

template <typename IndexT>
__global__ void __launch_bounds__(kThreads)
    csr_spmv_t_kernel(const int64_t* __restrict__ offset,
                      const IndexT* __restrict__ index,
                      const float* __restrict__ value,
                      const float* __restrict__ g, int64_t num_rows,
                      int64_t nnz, int64_t num_features,
                      float* __restrict__ grad_w) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= num_rows) return;
  int64_t lo, hi;
  row_range(offset, row, nnz, &lo, &hi);
  const float gi = g[row];
  for (int64_t k = lo + lane; k < hi; k += kWarp) {
    int64_t j;
    if (dmlc_index::wrap(index[k], num_features, &j)) {
      atomicAdd(grad_w + j, value[k] * gi);
    }
  }
}

unsigned grid_for(int64_t num_rows) {
  const int64_t rows_per_block = kThreads / kWarp;
  return static_cast<unsigned>((num_rows + rows_per_block - 1) /
                               rows_per_block);
}

}  // namespace

extern "C" {

// y[num_rows] = CSR(offset[num_rows+1], index[nnz], value[nnz]) . w
// index_bytes: 4 (u32 or int32) or 8 (u64). Returns a cudaError_t.
int dmlc_csr_spmv(const void* offset, const void* index, int index_bytes,
                  const void* value, const void* w, int64_t num_rows,
                  int64_t nnz, int64_t num_features, void* y,
                  void* stream) {
  if (num_rows <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* off = static_cast<const int64_t*>(offset);
  const auto* val = static_cast<const float*>(value);
  const auto* wv = static_cast<const float*>(w);
  auto* out = static_cast<float*>(y);
  if (index_bytes == 4) {
    csr_spmv_kernel<uint32_t><<<grid_for(num_rows), kThreads, 0, s>>>(
        off, static_cast<const uint32_t*>(index), val, wv, num_rows, nnz,
        num_features, out);
  } else if (index_bytes == 8) {
    csr_spmv_kernel<uint64_t><<<grid_for(num_rows), kThreads, 0, s>>>(
        off, static_cast<const uint64_t*>(index), val, wv, num_rows, nnz,
        num_features, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// grad_w[num_features] += CSR^T . g[num_rows]; grad_w must be zeroed by
// the caller. Returns a cudaError_t.
int dmlc_csr_spmv_t(const void* offset, const void* index, int index_bytes,
                    const void* value, const void* g, int64_t num_rows,
                    int64_t nnz, int64_t num_features, void* grad_w,
                    void* stream) {
  if (num_rows <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* off = static_cast<const int64_t*>(offset);
  const auto* val = static_cast<const float*>(value);
  const auto* gv = static_cast<const float*>(g);
  auto* out = static_cast<float*>(grad_w);
  if (index_bytes == 4) {
    csr_spmv_t_kernel<uint32_t><<<grid_for(num_rows), kThreads, 0, s>>>(
        off, static_cast<const uint32_t*>(index), val, gv, num_rows, nnz,
        num_features, out);
  } else if (index_bytes == 8) {
    csr_spmv_t_kernel<uint64_t><<<grid_for(num_rows), kThreads, 0, s>>>(
        off, static_cast<const uint64_t*>(index), val, gv, num_rows, nnz,
        num_features, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
