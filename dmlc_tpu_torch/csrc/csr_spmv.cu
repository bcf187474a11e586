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
// K1's design. Lanes of a row take its nonzeros lane, lane + L, ... U at
// a time: first every index and value load, then every gather of w
// through the read-only path, then the fp32 FMAs, and a shuffle tree
// within the row's lanes; 32-bit arithmetic inside a row (the C entry
// refuses 2^31 nonzeros); no row-id array. Two routes, one kernel each,
// picked by the wrapper from the bucket's nonzeros a row (ops/csr.py
// csr_spmv_route): half (L = 16, U = 4; two rows a warp) up to 64 a row,
// warp (L = 32, U = 5) beyond. On an NVIDIA H100 80GB HBM3 at 700 W,
// warm L2: 3.84-4.11 us at the linear batch and 4.08 at the FM batch (the
// warp a row before it: 4.38-4.41 and 4.52-4.77), 2.33-2.39 at the
// ranking batch (before: 2.66). What bounds it there is the gathers: an
// empty kernel of the same grid takes 1.23 us, the offsets and the index
// and value streams 0.6 more, and the 282k gathers into the 4 MB w about
// 2.0 more, against 0.3 when w is 137 floats that stay in L1 (PERF.md
// section 6). K2 scatters with fp32 atomics into a zeroed grad_w; the
// order of atomics varies from run to run, so K2 is not bitwise
// deterministic. Both kernels launch on the caller's stream and allocate
// nothing; each C entry returns cudaGetLastError().
//
// K2 takes L >= 1 parts in one launch: part p's CSR block (offset[p],
// index[p], value[p], each part with its own offsets and its own padded
// tail, never visited) and its g[p], all adding into one zeroed grad_w.
// So the data-parallel step's backward, which the reference takes as one
// jax.value_and_grad of the group's loss over shard_map
// (dmlc_tpu/models/common.py:126), is one fill and one launch for all of a
// process's parts, with no sum of per-part gradients after it. L = 1 is
// the single-part call. Two routes, one kernel each, picked by the wrapper
// (ops/csr.py csr_spmv_t_route, from the model's width and the nonzeros of
// all L parts):
//   - global, for wide models (10^6 weights), whose atomics spread over
//     many addresses: K1's lane mapping (the same rule, csr_spmv_route, on
//     a part's bucket: 16 lanes x 4 a row up to 64 nonzeros a row, 32 x 5
//     beyond), grid (rows, parts), g[row] read once a row and shuffled to
//     its lanes, every index and value load of a window before its first
//     add, 32-bit arithmetic inside a row, and fire-and-forget RED adds.
//     The first body of this route (one warp a row, a lane's index, value
//     and add in series, 64-bit arithmetic; its adds were REDG too) left
//     half the lanes idle at the linear batch's 25-44 nonzeros a row. On
//     an NVIDIA H100 80GB HBM3 at 700 W, warm L2, at the linear batch
//     (282,526 nonzeros): 4.87-4.92 us against the first body's 5.33-5.34
//     in the same calls; over 4 parts (1,130,322 nonzeros) 15.57-15.65 us, so about
//     1.3 us a launch and 12.7 ps a nonzero: about 79 G adds a second at
//     the L2, one a nonzero, which bounds it, not the 4 MB of grad_w or
//     the index and value streams (PERF.md section 6).
//   - private, for narrow models (the ranking path's 137 weights, where
//     each address would take about 4096 global atomics and they queue at
//     the L2's atomic units): a grid of `blocks` blocks, one warp per row
//     in a grid-stride loop over the rows of every part, each block adding
//     into its own copy of grad_w in shared memory (native shared-memory
//     float atomics, which stay in the SM), then adding its copy into the
//     zeroed grad_w with one global atomic per weight. Each address takes
//     `blocks` global atomics instead of its nonzeros. A fixed-order sum of
//     the copies by the last block to finish (a workspace of blocks x F and
//     a device counter, no zero fill) lost on an H100: 10.1 us against 5.2
//     at the ranking batch, one block's sum of 128 x 137 partials costing
//     more than the fill it saves (PERF.md section 6).

#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"
#include "index.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;  // 8 warps = 8 rows per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// The rows of nonzeros offset[row] .. offset[row + 1], clamped into [0,
// nnz], as 32-bit offsets (the C entry refuses nnz >= 2^31).
__device__ __forceinline__ void row_range32(const int64_t* offset, int row,
                                            int nnz, int* lo, int* hi) {
  const int64_t a = offset[row];
  const int64_t b = offset[row + 1];
  *lo = static_cast<int>(a < 0 ? 0 : (a > nnz ? nnz : a));
  *hi = static_cast<int>(b < *lo ? *lo : (b > nnz ? nnz : b));
}

// K1: kLanes lanes a row (16: two rows a warp; 32: one), each taking the
// row's nonzeros lane, lane + kLanes, ... kUnroll at a time: first every
// index and value load, then every gather of w, then the adds, so that a
// row is three dependent loads deep (offset, index, w). An invalid index
// gathers NaN, which the sum carries into the row (jnp.take's fill). The
// lanes of a row past num_rows take no nonzero and store nothing, but stay
// for the shuffles, which run within each row's kLanes lanes.
template <typename IndexT, int kLanes, int kUnroll>
__device__ __forceinline__ void spmv_rows(const int64_t* __restrict__ offset,
                                          const IndexT* __restrict__ index,
                                          const float* __restrict__ value,
                                          const float* __restrict__ w,
                                          int num_rows, int nnz,
                                          int64_t num_features,
                                          float* __restrict__ y) {
  const int row = blockIdx.x * (kThreads / kLanes) + threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  int lo = 0, hi = 0;
  if (row < num_rows) row_range32(offset, row, nnz, &lo, &hi);
  const unsigned len = static_cast<unsigned>(hi - lo);
  float acc = 0.0f;
  for (unsigned t0 = lane; t0 < len; t0 += kLanes * kUnroll) {
    IndexT raw[kUnroll];
    float x[kUnroll], v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned t = t0 + u * kLanes;
      raw[u] = t < len ? index[lo + t] : IndexT(0);
      x[u] = t < len ? value[lo + t] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      int64_t j;
      const bool ok = dmlc_index::wrap(raw[u], num_features, &j);
      v[u] = t0 + u * kLanes >= len ? 0.0f : (ok ? __ldg(w + j) : nan_f());
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = fmaf(x[u], v[u], acc);
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
    acc += __shfl_down_sync(kFull, acc, o, kLanes);
  }
  if (lane == 0 && row < num_rows) y[row] = acc;
}

// K1's two routes, one kernel each so that a trace names the route: the
// half route (kHalfLanes lanes a row) where the wrapper's rows are short
// (ops/csr.py csr_spmv_route), the warp route (a warp a row) where they
// are long.
constexpr int kHalfLanes = 16, kHalfUnroll = 4;
constexpr int kWarpLanes = 32, kWarpUnroll = 5;

template <typename IndexT>
__global__ void __launch_bounds__(kThreads)
    csr_spmv_half_kernel(const int64_t* __restrict__ offset,
                         const IndexT* __restrict__ index,
                         const float* __restrict__ value,
                         const float* __restrict__ w, int num_rows, int nnz,
                         int64_t num_features, float* __restrict__ y) {
  spmv_rows<IndexT, kHalfLanes, kHalfUnroll>(offset, index, value, w,
                                             num_rows, nnz, num_features, y);
}

template <typename IndexT>
__global__ void __launch_bounds__(kThreads)
    csr_spmv_warp_kernel(const int64_t* __restrict__ offset,
                         const IndexT* __restrict__ index,
                         const float* __restrict__ value,
                         const float* __restrict__ w, int num_rows, int nnz,
                         int64_t num_features, float* __restrict__ y) {
  spmv_rows<IndexT, kWarpLanes, kWarpUnroll>(offset, index, value, w,
                                             num_rows, nnz, num_features, y);
}

// K2's global route: kLanes lanes a row, as K1's routes (16 x 4 where the
// bucket holds at most 64 nonzeros a row, 32 x 5 beyond), over the rows of
// part blockIdx.y. Lane 0 reads g[row] beside the row's offsets and a
// shuffle gives it to the row's lanes; in each window a lane loads every
// index and value first, then adds value * g into grad_w with fp32
// atomicAdd whose result is unused, which compiles to fire-and-forget RED
// (cuobjdump -sass: REDG.E.ADD.F32.FTZ.RN.STRONG.GPU and no ATOMG in all
// four instances, scripts/k2_ab.py), so no lane waits on an add. A row is
// two dependent loads deep (offset, then index and value). An invalid
// index adds nothing. The lanes of a row past num_rows take no nonzero but
// stay for the shuffle.
template <typename IndexT, int kLanes, int kUnroll>
__global__ void __launch_bounds__(kThreads)
    csr_spmv_t_kernel(const int64_t* __restrict__ offset,
                      const IndexT* __restrict__ index,
                      const float* __restrict__ value,
                      const float* __restrict__ g, int num_rows, int nnz,
                      int64_t num_features, float* __restrict__ grad_w) {
  const int64_t part = blockIdx.y;
  offset += part * (num_rows + 1);
  index += part * nnz;
  value += part * nnz;
  g += part * num_rows;
  const int row = blockIdx.x * (kThreads / kLanes) + threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  int lo = 0, hi = 0;
  float g_lane = 0.0f;
  if (row < num_rows) {
    if (lane == 0) g_lane = g[row];
    row_range32(offset, row, nnz, &lo, &hi);
  }
  const float gi = __shfl_sync(kFull, g_lane, 0, kLanes);
  const unsigned len = static_cast<unsigned>(hi - lo);
  for (unsigned t0 = lane; t0 < len; t0 += kLanes * kUnroll) {
    IndexT raw[kUnroll];
    float x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned t = t0 + u * kLanes;
      raw[u] = t < len ? index[lo + t] : IndexT(0);
      x[u] = t < len ? value[lo + t] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      int64_t j;
      const bool ok = dmlc_index::wrap(raw[u], num_features, &j);
      if (ok && t0 + u * kLanes < len) atomicAdd(grad_w + j, x[u] * gi);
    }
  }
}

// ---------------------------------------------------------------- private

constexpr int kPrivateThreads = 1024;  // 32 rows of a block at a time

// grad_w += sum over parts of CSR_p^T . g_p with each block's copy of
// grad_w in shared memory (own: F floats of dynamic shared memory), added
// into grad_w once at the end. The rows of every part form one range of
// parts * num_rows rows (the C entry refuses 2^31), walked by a grid-stride
// loop of one warp a row.
template <typename IndexT>
__global__ void __launch_bounds__(kPrivateThreads, 2)
    csr_spmv_t_private_kernel(const int64_t* __restrict__ offset,
                              const IndexT* __restrict__ index,
                              const float* __restrict__ value,
                              const float* __restrict__ g, int parts,
                              int num_rows, int nnz, int num_features,
                              float* __restrict__ grad_w) {
  extern __shared__ float own[];
  const int lane = threadIdx.x % kWarp;
  constexpr int kRows = kPrivateThreads / kWarp;
  for (int c = threadIdx.x; c < num_features; c += kPrivateThreads) {
    own[c] = 0.0f;
  }
  __syncthreads();
  const unsigned rows = static_cast<unsigned>(parts) * num_rows;
  for (unsigned r = blockIdx.x * kRows + threadIdx.x / kWarp; r < rows;
       r += gridDim.x * kRows) {
    const int part = static_cast<int>(r / num_rows);
    const int row = static_cast<int>(r) - part * num_rows;
    const int64_t* off = offset + static_cast<int64_t>(part) * (num_rows + 1);
    const IndexT* idx = index + static_cast<int64_t>(part) * nnz;
    const float* val = value + static_cast<int64_t>(part) * nnz;
    int lo, hi;
    row_range32(off, row, nnz, &lo, &hi);
    const float gi = g[r];
    for (int k = lo + lane; k < hi; k += kWarp) {
      int j;
      if (dmlc_index::wrap32(idx[k], num_features, &j)) {
        atomicAdd(own + j, val[k] * gi);
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < num_features; c += kPrivateThreads) {
    atomicAdd(grad_w + c, own[c]);
  }
}

template <typename IndexT>
cudaError_t spmv_t_private(const int64_t* offset, const IndexT* index,
                           const float* value, const float* g, int parts,
                           int num_rows, int nnz, int64_t num_features,
                           float* grad_w, int64_t blocks, cudaStream_t s) {
  const auto kernel = csr_spmv_t_private_kernel<IndexT>;
  const int64_t bytes = num_features * static_cast<int64_t>(sizeof(float));
  int64_t most = 0;  // the kernel has no static shared memory
  cudaError_t err = dmlc_device::max_shared_bytes(&most);
  if (err != cudaSuccess) return err;
  if (bytes > most) return cudaErrorInvalidValue;
  // no more blocks than the rows of every part fill
  const int64_t rows_per_block = kPrivateThreads / kWarp;
  const int64_t rows = static_cast<int64_t>(parts) * num_rows;
  const int64_t fill = (rows + rows_per_block - 1) / rows_per_block;
  const int64_t grid = blocks < fill ? blocks : fill;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  if (bytes > dmlc_device::kDefaultSharedBytes) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(grid), kPrivateThreads, bytes, s>>>(
      offset, index, value, g, parts, num_rows, nnz,
      static_cast<int>(num_features), grad_w);
  return cudaGetLastError();
}

// The blocks of kThreads that give each of num_rows rows `lanes` lanes.
unsigned grid_for(int64_t num_rows, int lanes = kWarp) {
  const int64_t rows_per_block = kThreads / lanes;
  return static_cast<unsigned>((num_rows + rows_per_block - 1) /
                               rows_per_block);
}

template <typename IndexT>
cudaError_t spmv(int lanes, const int64_t* offset, const void* index,
                 const float* value, const float* w, int64_t num_rows,
                 int64_t nnz, int64_t num_features, float* y,
                 cudaStream_t s) {
  const auto* idx = static_cast<const IndexT*>(index);
  const int rows = static_cast<int>(num_rows);
  const int n = static_cast<int>(nnz);
  if (lanes == kHalfLanes) {
    csr_spmv_half_kernel<IndexT>
        <<<grid_for(num_rows, kHalfLanes), kThreads, 0, s>>>(
            offset, idx, value, w, rows, n, num_features, y);
  } else if (lanes == kWarpLanes) {
    csr_spmv_warp_kernel<IndexT>
        <<<grid_for(num_rows, kWarpLanes), kThreads, 0, s>>>(
            offset, idx, value, w, rows, n, num_features, y);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename IndexT>
cudaError_t spmv_t_global(int lanes, const int64_t* offset, const void* index,
                          const float* value, const float* g, int parts,
                          int num_rows, int nnz, int64_t num_features,
                          float* grad_w, cudaStream_t s) {
  const auto* idx = static_cast<const IndexT*>(index);
  const unsigned p = static_cast<unsigned>(parts);
  if (lanes == kHalfLanes) {
    csr_spmv_t_kernel<IndexT, kHalfLanes, kHalfUnroll>
        <<<dim3(grid_for(num_rows, kHalfLanes), p), kThreads, 0, s>>>(
            offset, idx, value, g, num_rows, nnz, num_features, grad_w);
  } else if (lanes == kWarpLanes) {
    csr_spmv_t_kernel<IndexT, kWarpLanes, kWarpUnroll>
        <<<dim3(grid_for(num_rows, kWarpLanes), p), kThreads, 0, s>>>(
            offset, idx, value, g, num_rows, nnz, num_features, grad_w);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y[num_rows] = CSR(offset[num_rows+1], index[nnz], value[nnz]) . w
// index_bytes: 4 (u32 or int32) or 8 (u64); lanes: 16 or 32 lanes a row.
// Returns a cudaError_t: cudaErrorInvalidValue for another index width or
// lane count, or where nnz or num_rows reaches 2^31.
int dmlc_csr_spmv(const void* offset, const void* index, int index_bytes,
                  const void* value, const void* w, int64_t num_rows,
                  int64_t nnz, int64_t num_features, void* y, int lanes,
                  void* stream) {
  if (num_rows <= 0) return static_cast<int>(cudaGetLastError());
  if (nnz > INT32_MAX || num_rows >= INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* off = static_cast<const int64_t*>(offset);
  const auto* val = static_cast<const float*>(value);
  const auto* wv = static_cast<const float*>(w);
  auto* out = static_cast<float*>(y);
  cudaError_t err = cudaErrorInvalidValue;
  if (index_bytes == 4) {
    err = spmv<uint32_t>(lanes, off, index, val, wv, num_rows, nnz,
                         num_features, out, s);
  } else if (index_bytes == 8) {
    err = spmv<uint64_t>(lanes, off, index, val, wv, num_rows, nnz,
                         num_features, out, s);
  }
  return static_cast<int>(err);
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

// grad_w[num_features] += sum over p < parts of CSR_p^T . g_p, part p's
// CSR block offset[p] [num_rows + 1], index[p] and value[p] [nnz] (its
// bucket; nonzeros past its offset[num_rows] are never read) and g[p]
// [num_rows], the parts stacked contiguously; grad_w must be zeroed by the
// caller. lanes: the global route's lanes a row (16 or 32, as K1's);
// blocks: 0 for the global route, else the private route's most blocks (it
// takes no more than 32 rows a block fill). Returns a cudaError_t:
// cudaErrorInvalidValue for another index width or lane count, where nnz
// or parts * num_rows reaches 2^31 or parts 2^16, or where the private
// route is asked for and num_features floats do not fit a block's shared
// memory.
int dmlc_csr_spmv_t(const void* offset, const void* index, int index_bytes,
                    const void* value, const void* g, int64_t parts,
                    int64_t num_rows, int64_t nnz, int64_t num_features,
                    void* grad_w, int lanes, int64_t blocks, void* stream) {
  if (num_rows <= 0 || parts <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  if (nnz > INT32_MAX || parts > 65535 || parts * num_rows >= INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* off = static_cast<const int64_t*>(offset);
  const auto* val = static_cast<const float*>(value);
  const auto* gv = static_cast<const float*>(g);
  auto* out = static_cast<float*>(grad_w);
  const int p = static_cast<int>(parts);
  const int rows = static_cast<int>(num_rows);
  const int n = static_cast<int>(nnz);
  cudaError_t err = cudaErrorInvalidValue;
  if (blocks > 0) {
    if (index_bytes == 4) {
      err = spmv_t_private(off, static_cast<const uint32_t*>(index), val, gv,
                           p, rows, n, num_features, out, blocks, s);
    } else if (index_bytes == 8) {
      err = spmv_t_private(off, static_cast<const uint64_t*>(index), val, gv,
                           p, rows, n, num_features, out, blocks, s);
    }
  } else if (index_bytes == 4) {
    err = spmv_t_global<uint32_t>(lanes, off, index, val, gv, p, rows, n,
                                  num_features, out, s);
  } else if (index_bytes == 8) {
    err = spmv_t_global<uint64_t>(lanes, off, index, val, gv, p, rows, n,
                                  num_features, out, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
