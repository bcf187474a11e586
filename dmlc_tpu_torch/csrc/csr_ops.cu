// The rest of the reference's CSR ops: a padded-ELL row dot and the CSR to
// dense scatter, hand-written for Hopper (sm_90a), with a plain C interface
// bound by ctypes from dmlc_tpu_torch/ops/csr.py.
//
// What they replace. The JAX package has no hand-written device kernel:
// XLA compiled these computations from jnp.
//   K3 sdot_rows     <- dmlc_tpu/ops/csr.py:107 sdot_rows: y[r] = sum_k
//                       w[index[r,k]] * value[r,k] over padded ELL rows
//                       [n, k] (the output of csr_to_padded_rows).
//   K4 csr_to_dense  <- dmlc_tpu/ops/csr.py:68 csr_to_dense:
//                       dense[row(k), index[k]] += value[k] into a zeroed
//                       [rows, cols] float32 matrix.
//
// Semantics kept from the reference:
//   - an index maps by the reference's rule (index.cuh: low 32 bits,
//     signed, negative counted from the end); an invalid one reads no
//     memory: K3 gives its row NaN (jnp.take fills NaN), K4 drops it (the
//     scatter drops an out-of-bounds index);
//   - K4's rows are those of offset[0..num_rows]; nonzeros past
//     offset[num_rows] (the padded tail) are never visited; duplicate
//     columns of a row add up.
//
// Bound on the card (H100 SXM, 3.35 TB/s). Both move bytes and do one or
// two flops per entry. K3 reads index and value once (8 B an entry with a
// 4-byte index), gathers w (at most 4 B an entry, far less from device
// memory: a small w stays in L2) and writes 4 B a row. K4 reads offset,
// index and value once and writes the dense matrix once, which dominates
// where the batch is dense-ish (the ranking batch: 4096 x 137 floats, 2.2
// MB).
//
// Design. K3: one warp per row, lanes striding over the row's entries with
// coalesced index/value reads, reduced with warp shuffles; the row is NaN
// when any lane met an invalid index.
//
// K4 has two routes, picked by the wrapper (ops/csr.py csr_to_dense_route):
//   - tile: a block owns rows_per_block consecutive rows, whose dense rows
//     are one contiguous run of rows_per_block * num_cols floats. The block
//     zeroes the run in shared memory, streams its rows' index and value
//     (a warp a row, each lane's five loads in flight before its adds),
//     adds each valid nonzero into the run with a shared-memory atomicAdd
//     (a row may repeat a column), then writes the whole run out once,
//     coalesced, four floats a store (rows_per_block is a multiple of 4, so
//     each run starts on 16 bytes). One launch, no fill, the matrix written
//     once; 32-bit arithmetic inside the tile. For num_cols up to what a
//     block's shared memory holds.
//   - global: the route for wider matrices. The caller zeroes the matrix;
//     a warp a row adds each nonzero into it with a global fp32 atomicAdd.
// Rows own disjoint parts of the output, so only a row's duplicate columns
// contend, and only they make K4's sums depend on the order of the atomics.
// Both launch on the caller's stream and allocate nothing; each C entry
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"
#include "index.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;  // 8 warps = 8 rows per block
constexpr unsigned kFull = 0xffffffffu;

unsigned warp_grid(int64_t num_rows) {
  const int64_t rows_per_block = kThreads / kWarp;
  return static_cast<unsigned>((num_rows + rows_per_block - 1) /
                               rows_per_block);
}

template <typename IndexT>
__global__ void __launch_bounds__(kThreads)
    sdot_rows_kernel(const IndexT* __restrict__ index,
                     const float* __restrict__ value,
                     const float* __restrict__ w, int64_t num_rows,
                     int64_t width, int64_t num_features,
                     float* __restrict__ y) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= num_rows) return;  // uniform across the warp
  const IndexT* idx = index + row * width;
  const float* val = value + row * width;
  float acc = 0.0f;
  int bad = 0;
  for (int64_t k = lane; k < width; k += kWarp) {
    int64_t j;
    if (dmlc_index::wrap(idx[k], num_features, &j)) {
      acc = fmaf(__ldg(w + j), val[k], acc);
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
    csr_to_dense_kernel(const int64_t* __restrict__ offset,
                        const IndexT* __restrict__ index,
                        const float* __restrict__ value, int64_t num_rows,
                        int64_t nnz, int64_t num_cols,
                        float* __restrict__ dense) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= num_rows) return;
  int64_t lo = offset[row];
  int64_t hi = offset[row + 1];
  // a corrupt offset array must not send a warp past index/value
  lo = lo < 0 ? 0 : (lo > nnz ? nnz : lo);
  hi = hi < lo ? lo : (hi > nnz ? nnz : hi);
  float* out = dense + row * num_cols;
  for (int64_t k = lo + lane; k < hi; k += kWarp) {
    int64_t j;
    if (dmlc_index::wrap(index[k], num_cols, &j)) atomicAdd(out + j, value[k]);
  }
}

// K4's tile route (see the head of this file): block b owns rows b*R ..
// b*R + R - 1 (R = rows_per_block, a multiple of 4; tile: R * num_cols
// floats of dynamic shared memory).
constexpr int kTileThreads = 256;  // 8 warps, a row each at a time
constexpr int kTileUnroll = 5;     // a lane's loads in flight: 160 a row

template <typename IndexT>
__global__ void __launch_bounds__(kTileThreads)
    csr_to_dense_tile_kernel(const int64_t* __restrict__ offset,
                             const IndexT* __restrict__ index,
                             const float* __restrict__ value,
                             int64_t num_rows, int64_t nnz, int num_cols,
                             int rows_per_block, float* __restrict__ dense) {
  extern __shared__ float4 tile4[];
  float* tile = reinterpret_cast<float*>(tile4);
  const int64_t first = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t left = num_rows - first;
  const int rows = left < rows_per_block ? static_cast<int>(left)
                                         : rows_per_block;
  const int n = rows * num_cols;  // the run's floats
  const int n4 = (n + 3) / 4;     // within the tile: R * num_cols % 4 == 0
  for (int c = threadIdx.x; c < n4; c += kTileThreads) {
    tile4[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();
  const int lane = threadIdx.x % kWarp;
  for (int r = threadIdx.x / kWarp; r < rows; r += kTileThreads / kWarp) {
    int64_t lo = offset[first + r];
    int64_t hi = offset[first + r + 1];
    // a corrupt offset array must not send a warp past index/value
    lo = lo < 0 ? 0 : (lo > nnz ? nnz : lo);
    hi = hi < lo ? lo : (hi > nnz ? nnz : hi);
    const IndexT* idx = index + lo;
    const float* val = value + lo;
    const int64_t len = hi - lo;
    float* out = tile + r * num_cols;
    for (int64_t t0 = lane; t0 < len; t0 += kWarp * kTileUnroll) {
      IndexT raw[kTileUnroll];
      float x[kTileUnroll];
#pragma unroll
      for (int u = 0; u < kTileUnroll; ++u) {
        const int64_t t = t0 + u * kWarp;
        raw[u] = t < len ? idx[t] : IndexT(0);
        x[u] = t < len ? val[t] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kTileUnroll; ++u) {
        int j;
        if (t0 + u * kWarp < len && dmlc_index::wrap32(raw[u], num_cols, &j)) {
          atomicAdd(out + j, x[u]);
        }
      }
    }
  }
  __syncthreads();
  float* run = dense + first * num_cols;  // 16-byte aligned (see above)
  float4* run4 = reinterpret_cast<float4*>(run);
  for (int c = threadIdx.x; c < n / 4; c += kTileThreads) run4[c] = tile4[c];
  for (int c = n / 4 * 4 + threadIdx.x; c < n; c += kTileThreads) {
    run[c] = tile[c];
  }
}

template <typename IndexT>
cudaError_t to_dense_tile(const int64_t* offset, const IndexT* index,
                          const float* value, int64_t num_rows, int64_t nnz,
                          int64_t num_cols, int64_t rows_per_block,
                          float* dense, cudaStream_t s) {
  const auto kernel = csr_to_dense_tile_kernel<IndexT>;
  if (rows_per_block % 4 != 0 || num_cols <= 0 ||
      reinterpret_cast<uintptr_t>(dense) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const int64_t bytes =
      rows_per_block * num_cols * static_cast<int64_t>(sizeof(float));
  int64_t most = 0;  // the kernel has no static shared memory
  cudaError_t err = dmlc_device::max_shared_bytes(&most);
  if (err != cudaSuccess) return err;
  if (bytes > most) return cudaErrorInvalidValue;
  const int64_t grid = (num_rows + rows_per_block - 1) / rows_per_block;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  if (bytes > dmlc_device::kDefaultSharedBytes) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(grid), kTileThreads, bytes, s>>>(
      offset, index, value, num_rows, nnz, static_cast<int>(num_cols),
      static_cast<int>(rows_per_block), dense);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y[num_rows] = sum_k w[index[r, k]] * value[r, k] over row-major
// index/value [num_rows, width]. index_bytes: 4 (u32 or int32) or 8 (u64).
// Returns a cudaError_t.
int dmlc_sdot_rows(const void* index, int index_bytes, const void* value,
                   const void* w, int64_t num_rows, int64_t width,
                   int64_t num_features, void* y, void* stream) {
  if (num_rows <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* val = static_cast<const float*>(value);
  const auto* wv = static_cast<const float*>(w);
  auto* out = static_cast<float*>(y);
  if (index_bytes == 4) {
    sdot_rows_kernel<uint32_t><<<warp_grid(num_rows), kThreads, 0, s>>>(
        static_cast<const uint32_t*>(index), val, wv, num_rows, width,
        num_features, out);
  } else if (index_bytes == 8) {
    sdot_rows_kernel<uint64_t><<<warp_grid(num_rows), kThreads, 0, s>>>(
        static_cast<const uint64_t*>(index), val, wv, num_rows, width,
        num_features, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dense[num_rows, num_cols] = the CSR batch (offset[num_rows+1],
// index[nnz], value[nnz]) scattered into a dense matrix. rows_per_block > 0:
// the tile route, that many rows a block (a multiple of 4; dense on 16
// bytes), which writes every entry; 0: the global route, which adds into a
// dense matrix the caller has zeroed. Returns a cudaError_t.
int dmlc_csr_to_dense(const void* offset, const void* index, int index_bytes,
                      const void* value, int64_t num_rows, int64_t nnz,
                      int64_t num_cols, void* dense, int64_t rows_per_block,
                      void* stream) {
  if (num_rows <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* off = static_cast<const int64_t*>(offset);
  const auto* val = static_cast<const float*>(value);
  auto* out = static_cast<float*>(dense);
  if (rows_per_block > 0) {
    cudaError_t err = cudaErrorInvalidValue;
    if (index_bytes == 4) {
      err = to_dense_tile(off, static_cast<const uint32_t*>(index), val,
                          num_rows, nnz, num_cols, rows_per_block, out, s);
    } else if (index_bytes == 8) {
      err = to_dense_tile(off, static_cast<const uint64_t*>(index), val,
                          num_rows, nnz, num_cols, rows_per_block, out, s);
    }
    return static_cast<int>(err);
  }
  if (index_bytes == 4) {
    csr_to_dense_kernel<uint32_t><<<warp_grid(num_rows), kThreads, 0, s>>>(
        off, static_cast<const uint32_t*>(index), val, num_rows, nnz,
        num_cols, out);
  } else if (index_bytes == 8) {
    csr_to_dense_kernel<uint64_t><<<warp_grid(num_rows), kThreads, 0, s>>>(
        off, static_cast<const uint64_t*>(index), val, num_rows, nnz,
        num_cols, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
