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
//
// K2 has two routes; the wrapper picks one (ops/csr.py csr_spmv_t_route).
//   - global: the kernel above, for wide models (10^6 weights), whose
//     atomics spread over many addresses.
//   - private, for narrow models (the ranking path's 137 weights, where
//     each address would take about 4096 global atomics and they queue at
//     the L2's atomic units): a grid of `blocks` blocks, one warp per row
//     in a grid-stride loop, each block adding into its own copy of grad_w
//     in shared memory (native shared-memory float atomics, which stay in
//     the SM), then adding its copy into the zeroed grad_w with one global
//     atomic per weight. Each address takes `blocks` global atomics
//     instead of its nonzeros. A fixed-order sum of the copies by the last
//     block to finish (a workspace of blocks x F and a device counter, no
//     zero fill) lost on an H100: 10.1 us against 5.2 at the ranking
//     batch, one block's sum of 128 x 137 partials costing more than the
//     fill it saves (PERF.md section 6).

#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"
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

// ---------------------------------------------------------------- private

constexpr int kPrivateThreads = 1024;  // 32 rows of a block at a time

// grad_w += CSR^T . g with each block's copy of grad_w in shared memory
// (own: F floats of dynamic shared memory), added into grad_w at the end.
template <typename IndexT>
__global__ void __launch_bounds__(kPrivateThreads, 2)
    csr_spmv_t_private_kernel(const int64_t* __restrict__ offset,
                              const IndexT* __restrict__ index,
                              const float* __restrict__ value,
                              const float* __restrict__ g, int64_t num_rows,
                              int64_t nnz, int64_t num_features,
                              float* __restrict__ grad_w) {
  extern __shared__ float own[];
  const int F = static_cast<int>(num_features);
  const int lane = threadIdx.x % kWarp;
  constexpr int kRows = kPrivateThreads / kWarp;
  for (int c = threadIdx.x; c < F; c += kPrivateThreads) own[c] = 0.0f;
  __syncthreads();
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kRows +
                     threadIdx.x / kWarp;
       row < num_rows; row += static_cast<int64_t>(gridDim.x) * kRows) {
    int64_t lo, hi;
    row_range(offset, row, nnz, &lo, &hi);
    const float gi = g[row];
    for (int64_t k = lo + lane; k < hi; k += kWarp) {
      int64_t j;
      if (dmlc_index::wrap(index[k], num_features, &j)) {
        atomicAdd(own + j, value[k] * gi);
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < F; c += kPrivateThreads) {
    atomicAdd(grad_w + c, own[c]);
  }
}

template <typename IndexT>
cudaError_t spmv_t_private(const int64_t* offset, const IndexT* index,
                           const float* value, const float* g,
                           int64_t num_rows, int64_t nnz,
                           int64_t num_features, float* grad_w,
                           int64_t blocks, cudaStream_t s) {
  const auto kernel = csr_spmv_t_private_kernel<IndexT>;
  const int64_t bytes = num_features * static_cast<int64_t>(sizeof(float));
  int64_t most = 0;  // the kernel has no static shared memory
  cudaError_t err = dmlc_device::max_shared_bytes(&most);
  if (err != cudaSuccess) return err;
  if (bytes > most) return cudaErrorInvalidValue;
  // no more blocks than the rows fill
  const int64_t rows_per_block = kPrivateThreads / kWarp;
  const int64_t fill = (num_rows + rows_per_block - 1) / rows_per_block;
  const int64_t grid = blocks < fill ? blocks : fill;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  if (bytes > dmlc_device::kDefaultSharedBytes) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(grid), kPrivateThreads, bytes, s>>>(
      offset, index, value, g, num_rows, nnz, num_features, grad_w);
  return cudaGetLastError();
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

// The most shared memory, static and dynamic together, that a block of any
// kernel here may opt in to on the current device, into *out (int64). K2's
// private route needs num_features * 4 bytes of it; K6's shared route
// ffm_shared_floats * 4 and its static kStaticSharedBytes (fm.cu). Returns
// a cudaError_t.
int dmlc_max_shared_bytes(void* out) {
  return static_cast<int>(
      dmlc_device::max_shared_bytes(static_cast<int64_t*>(out)));
}

// grad_w[num_features] += CSR^T . g[num_rows]; grad_w must be zeroed by
// the caller. blocks: 0 for the global route, else the private route's
// most blocks (it takes no more than 32 rows a block fill). Returns a cudaError_t: cudaErrorInvalidValue where the private
// route is asked for and num_features floats do not fit a block's shared
// memory.
int dmlc_csr_spmv_t(const void* offset, const void* index, int index_bytes,
                    const void* value, const void* g, int64_t num_rows,
                    int64_t nnz, int64_t num_features, void* grad_w,
                    int64_t blocks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* off = static_cast<const int64_t*>(offset);
  const auto* val = static_cast<const float*>(value);
  const auto* gv = static_cast<const float*>(g);
  auto* out = static_cast<float*>(grad_w);
  if (num_rows <= 0) return static_cast<int>(cudaGetLastError());
  if (blocks > 0) {
    cudaError_t err = cudaErrorInvalidValue;
    if (index_bytes == 4) {
      err = spmv_t_private(off, static_cast<const uint32_t*>(index), val, gv,
                           num_rows, nnz, num_features, out, blocks, s);
    } else if (index_bytes == 8) {
      err = spmv_t_private(off, static_cast<const uint64_t*>(index), val, gv,
                           num_rows, nnz, num_features, out, blocks, s);
    }
    return static_cast<int>(err);
  }
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
