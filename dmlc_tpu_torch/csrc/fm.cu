// The pair terms of the factorization machines (FM and field-aware FFM)
// and their gradients in V, hand-written for Hopper (sm_90a), with a plain
// C interface bound by ctypes from dmlc_tpu_torch/ops/fm.py.
//
// What they replace. The JAX package has no hand-written device kernel:
// XLA compiled these computations from jnp.
//   K5 fm_pair_fwd   <- the pair term of dmlc_tpu/models/fm.py:43
//                       _fm_margins: s[r,:] = sum_k x_k V[i_k,:],
//                       sq[r,:] = sum_k (x_k V[i_k,:])^2,
//                       pair[r] = 1/2 sum_f (s^2 - sq). s is an output too:
//                       the backward reads it.
//   K5 fm_pair_bwd   <- its gradient in V (jax.value_and_grad in
//                       dmlc_tpu/models/common.py:89):
//                       gV[i_k,:] += g[r] x_k (s[r,:] - x_k V[i_k,:]).
//   K6 ffm_pair_fwd  <- the pair term of dmlc_tpu/models/fm.py:117
//                       _ffm_margins: S[a,b,:] = sum_{k: f_k = a} x_k
//                       V[i_k,b,:] per row, pair[r] = 1/2 (sum_{a,b}
//                       <S[a,b],S[b,a]> - sum_k |x_k V[i_k,f_k,:]|^2).
//   K6 ffm_pair_bwd  <- its gradient in V: gV[i_k,b,:] += g[r] x_k
//                       (S[b,f_k,:] - [b = f_k] x_k V[i_k,f_k,:]).
//
// Semantics kept from the reference:
//   - an index maps by the reference's rule (index.cuh: low 32 bits,
//     signed, negative counted from the end); an invalid one reads no
//     memory and its factors count as NaN (jnp.take fills NaN out of range): the row's pair is
//     NaN, and so are the sums that the backward reads (s, or S[f_k,:,:]),
//     exactly where jax.grad of the reference gives NaN. The out-of-range
//     nonzero itself adds nothing to gV (the gradient of the filled take
//     drops it);
//   - a field id takes its low 32 bits, signed, and is clipped into
//     [0, num_fields - 1] (astype(int32), then jnp.clip);
//   - rows are those of offset[0..num_rows]; nonzeros past offset[num_rows]
//     (the padded tail) are never visited.
//
// Bound on the card (H100 SXM, 3.35 TB/s, 67 TFLOP/s fp32). All four move
// bytes and do a few flops per byte. K5 forward gathers one K-row of V per
// nonzero (32 B at K = 8) and reads index and value (8 B); K5 backward adds
// one fp32 atomic per (nonzero, factor) and writes the dense gV (the
// wrapper zero-fills it: 32 MB at 10^6 x 8). K6 gathers nf*K floats of V
// per nonzero (624 B at 39 x 4), and its backward writes the dense gV of
// 10^6 x 39 x 4 floats (624 MB), which dominates its bound.
//
// Design, simple first (no wgmma, no TMA, dense gradient):
//   - K5: one warp per row. Lanes cover (nonzero, factor): lane = g*kp + f
//     with kp = min(next power of two >= K, 32), so a warp reads 32/kp
//     nonzeros' K-rows at once, coalesced; factors beyond 32 are covered
//     in chunks of 32. Per-lane fp32 sums are folded across the nonzero
//     groups with xor shuffles. The backward adds with fp32 atomics into
//     a zeroed gV (not bitwise deterministic), by one of two routes that
//     the wrapper picks (ops/fm.py fm_bwd_route):
//       - vector, where K % 4 == 0 and V, s and gV are 16-byte aligned:
//         a lane owns four factors of a nonzero (K/4 lanes a nonzero, 16
//         nonzeros a warp step at K = 8), reads them of V and of s as one
//         float4 each (s once a row) and adds them with one vector
//         reduction (atomicAdd on float4, global memory, sm_90), so the
//         reductions and the loads of index and value are a quarter of
//         the scalar route's;
//       - scalar, for any other K or alignment: the forward's mapping,
//         one scalar atomic per (nonzero, factor).
//   - K6: one block per row, one thread per column c = b*K + f of S (nf*K
//     columns, 156 at 39/4; the block is that rounded up to a warp, at most
//     256 threads, each owning columns c, c + blockDim, ...). S (nf*nf*K
//     floats) and the per-field squares D (nf*K floats) live in dynamic
//     shared memory, 24,960 B at 39/4. The row's nonzeros are staged in
//     shared memory 64 at a time, each wrapped and clipped once; then the
//     thread of column c reads V[j, c] for each (a whole row of V across
//     the block, coalesced; 8 nonzeros' loads in flight before their adds,
//     since one at a time left each thread waiting out the latency) and
//     adds into S[a, c], which only it writes: no atomics, a fixed order of
//     sums, and no integer division in any loop (a thread finds its b and f
//     once, in 32-bit arithmetic). The pair is each thread's sum over a and
//     one block reduction, so the forward is deterministic. The backward
//     rebuilds S the same way (it is not saved: 8192 rows of it would be
//     200 MB) and adds each valid nonzero's row of gV with coalesced fp32
//     atomics.
//   - K6, two routes for S and D. Where they fit a block's shared memory
//     (the opt-in size above 48 KB, less the static staging: 39 fields of
//     up to 37 factors) they live there, one block per row. Past that (39
//     fields of 40 factors, 120 of 4, 300 of 1) they live in a workspace in
//     device memory that the wrapper allocates: G blocks, each with its own
//     S and D, walk the rows in a grid-stride loop. The build, the column
//     ownership, the summation order and the index rule are the same; only
//     where S points and the row loop differ. The wrapper chooses the route
//     (ops/fm.py ffm_route); a shared-memory launch of a shape that does not
//     fit returns cudaErrorInvalidValue.
//   - Products that meet a subtraction are rounded on their own
//     (__fmul_rn), not contracted into an FMA, so that a pair term that is
//     exactly 0 in the reference's eager arithmetic (a row of one nonzero)
//     is exactly 0 here too: the loss's subgradient at a zero margin
//     depends on it (ROADMAP C4).
// All kernels launch on the caller's stream and allocate nothing; each C
// entry returns cudaGetLastError() (or the error it found first).

#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"
#include "index.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kWarpThreads = 256;  // K5: 8 warps = 8 rows per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ void row_range(const int64_t* offset, int64_t row,
                                          int64_t nnz, int64_t* lo,
                                          int64_t* hi) {
  int64_t a = offset[row];
  int64_t b = offset[row + 1];
  // a corrupt offset array must not send a thread past index/value
  *lo = a < 0 ? 0 : (a > nnz ? nnz : a);
  *hi = b < *lo ? *lo : (b > nnz ? nnz : b);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// ---------------------------------------------------------------- K5

// kp: lanes per nonzero (a power of two <= 32); groups = 32 / kp nonzeros
// are read at once.
template <typename IndexT>
__global__ void __launch_bounds__(kWarpThreads)
    fm_pair_fwd_kernel(const int64_t* __restrict__ offset,
                       const IndexT* __restrict__ index,
                       const float* __restrict__ value,
                       const float* __restrict__ V, int64_t num_rows,
                       int64_t nnz, int64_t num_features, int64_t K, int kp,
                       float* __restrict__ pair, float* __restrict__ s_out) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kWarpThreads + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= num_rows) return;  // uniform across the warp
  int64_t lo, hi;
  row_range(offset, row, nnz, &lo, &hi);
  const int groups = kWarp / kp;
  const int grp = lane / kp;
  float total = 0.0f;
  for (int64_t f0 = 0; f0 < K; f0 += kp) {
    const int64_t f = f0 + lane % kp;
    const bool has_f = f < K;
    float s = 0.0f, sq = 0.0f;
    for (int64_t k = lo + grp; k < hi; k += groups) {
      int64_t j;
      const bool ok = dmlc_index::wrap(index[k], num_features, &j);
      float v = 0.0f;
      if (has_f) v = ok ? __ldg(V + j * K + f) : nan_f();
      const float vx = __fmul_rn(value[k], v);
      s += vx;
      sq += __fmul_rn(vx, vx);
    }
    // fold the nonzero groups: lanes of one factor differ in bits >= kp
    for (int o = kp; o < kWarp; o <<= 1) {
      s += __shfl_xor_sync(kFull, s, o);
      sq += __shfl_xor_sync(kFull, sq, o);
    }
    float part = 0.0f;
    if (grp == 0 && has_f) {
      s_out[row * K + f] = s;
      part = __fmul_rn(s, s) - sq;
    }
    total += warp_sum(part);
  }
  if (lane == 0) pair[row] = 0.5f * total;
}

template <typename IndexT>
__global__ void __launch_bounds__(kWarpThreads)
    fm_pair_bwd_kernel(const int64_t* __restrict__ offset,
                       const IndexT* __restrict__ index,
                       const float* __restrict__ value,
                       const float* __restrict__ V,
                       const float* __restrict__ s_in,
                       const float* __restrict__ g, int64_t num_rows,
                       int64_t nnz, int64_t num_features, int64_t K, int kp,
                       float* __restrict__ gV) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kWarpThreads + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= num_rows) return;
  int64_t lo, hi;
  row_range(offset, row, nnz, &lo, &hi);
  const int groups = kWarp / kp;
  const int grp = lane / kp;
  const float gr = g[row];
  for (int64_t f0 = 0; f0 < K; f0 += kp) {
    const int64_t f = f0 + lane % kp;
    if (f >= K) continue;
    const float s = s_in[row * K + f];
    for (int64_t k = lo + grp; k < hi; k += groups) {
      int64_t j;
      if (!dmlc_index::wrap(index[k], num_features, &j)) continue;
      const float x = value[k];
      const float v = __ldg(V + j * K + f);
      atomicAdd(gV + j * K + f, gr * x * (s - __fmul_rn(x, v)));
    }
  }
}

// The vector route: qp lanes a nonzero (qp = min(K / 4, 32)), each owning
// the four factors 4q .. 4q + 3 of q = lane % qp (and q + qp, ... past 32
// quads); 32 / qp nonzeros a warp step, the lanes past them idle. The
// products are those of the scalar route, term for term.
template <typename IndexT>
__global__ void __launch_bounds__(kWarpThreads)
    fm_pair_bwd_vec_kernel(const int64_t* __restrict__ offset,
                           const IndexT* __restrict__ index,
                           const float* __restrict__ value,
                           const float* __restrict__ V,
                           const float* __restrict__ s_in,
                           const float* __restrict__ g, int64_t num_rows,
                           int64_t nnz, int64_t num_features, int64_t K,
                           int qp, float* __restrict__ gV) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kWarpThreads + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int groups = kWarp / qp;
  const int grp = lane / qp;
  if (row >= num_rows || grp >= groups) return;  // no shuffles follow
  int64_t lo, hi;
  row_range(offset, row, nnz, &lo, &hi);
  const int64_t quads = K / 4;
  const float gr = g[row];
  const auto* V4 = reinterpret_cast<const float4*>(V);
  auto* gV4 = reinterpret_cast<float4*>(gV);
  for (int64_t q = lane % qp; q < quads; q += qp) {
    const float4 s = reinterpret_cast<const float4*>(s_in)[row * quads + q];
    for (int64_t k = lo + grp; k < hi; k += groups) {
      int64_t j;
      if (!dmlc_index::wrap(index[k], num_features, &j)) continue;
      const float x = value[k];
      const float4 v = __ldg(V4 + j * quads + q);
      float4 d;
      d.x = gr * x * (s.x - __fmul_rn(x, v.x));
      d.y = gr * x * (s.y - __fmul_rn(x, v.y));
      d.z = gr * x * (s.z - __fmul_rn(x, v.z));
      d.w = gr * x * (s.w - __fmul_rn(x, v.w));
      atomicAdd(gV4 + j * quads + q, d);
    }
  }
}

int lanes_per_nonzero(int64_t K) {
  int kp = 1;
  while (kp < K && kp < kWarp) kp <<= 1;
  return kp;
}

unsigned warp_grid(int64_t num_rows) {
  const int64_t rows_per_block = kWarpThreads / kWarp;
  return static_cast<unsigned>((num_rows + rows_per_block - 1) /
                               rows_per_block);
}

// ---------------------------------------------------------------- K6

constexpr int kMaxBlockThreads = 256;  // K6: one block per row
constexpr int kChunk = 64;             // K6: nonzeros staged at once
constexpr int kBatch = 8;  // K6: loads of V a thread issues before it adds

// A row's nonzeros, kChunk at a time, in static shared memory: base = j *
// nk, the offset of the row of V that the index reads (-1 where it is
// invalid), the clipped field a and the value x.
struct Staged {
  int64_t base[kChunk];
  int a[kChunk];
  float x[kChunk];
};

// The static shared memory of a K6 block: the staged nonzeros and the
// forward's reduction scratch. ops/fm.py's ffm_route subtracts it, as
// FFM_STATIC_SHARED_BYTES, from the card's opt-in maximum.
constexpr int64_t kStaticSharedBytes =
    sizeof(Staged) + sizeof(float) * (kMaxBlockThreads / kWarp);
static_assert(kStaticSharedBytes == 1056,
              "update FFM_STATIC_SHARED_BYTES in ops/fm.py");

// The columns c = b * K + f of S[a, :, :] that a thread owns: threadIdx.x,
// then every blockDim.x on. b and f come from one 32-bit division at the
// first column and are stepped without one.
struct Column {
  int c, b, f, db, df;
  __device__ explicit Column(int K)
      : c(threadIdx.x),
        b(threadIdx.x / K),
        f(threadIdx.x % K),
        db(blockDim.x / K),
        df(blockDim.x % K) {}
  __device__ void next(int K) {
    c += blockDim.x;
    b += db;
    f += df;
    if (f >= K) {
      f -= K;
      ++b;
    }
  }
};

// Sums v over the block, in a fixed order; the result is valid in thread 0.
__device__ float block_sum(float v, float* scratch) {
  v = warp_sum(v);
  if (threadIdx.x % kWarp == 0) scratch[threadIdx.x / kWarp] = v;
  __syncthreads();
  float out = 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < static_cast<int>(blockDim.x) / kWarp; ++w) {
      out += scratch[w];
    }
  }
  return out;
}

// The floats of a K6 block's dynamic shared memory: S [nf, nf, K], then
// D [nf, K].
__host__ __device__ __forceinline__ int64_t ffm_shared_floats(int64_t nf,
                                                              int64_t K) {
  return nf * nf * K + nf * K;
}

// Stages the nonzeros k0 .. min(k0 + kChunk, hi) - 1, each wrapped and
// clipped once; returns how many. Every thread of the block calls it.
template <typename IndexT>
__device__ int stage(Staged& st, int64_t k0, int64_t hi,
                     const IndexT* __restrict__ index,
                     const float* __restrict__ value,
                     const int64_t* __restrict__ field, int64_t num_features,
                     int nf, int nk) {
  const int m = static_cast<int>(hi - k0 < kChunk ? hi - k0 : kChunk);
  __syncthreads();  // the previous chunk's readers are done
  for (int t = threadIdx.x; t < m; t += blockDim.x) {
    const int64_t k = k0 + t;
    int64_t j;
    const bool ok = dmlc_index::wrap(index[k], num_features, &j);
    st.base[t] = ok ? j * nk : -1;
    st.a[t] = static_cast<int>(dmlc_index::clip_field(field[k], nf));
    st.x[t] = value[k];
  }
  __syncthreads();
  return m;
}

// One row's S[a, b, f] = sum_{k: f_k = a} x_k V[i_k, b, f] into shared
// memory and, where D is given, D[a, f] = sum_{k: f_k = a} (x_k V[i_k, a,
// f])^2, the part of S[a, a, f]^2 that pairs a nonzero with itself. The
// thread of column c reads V[j, c] for each staged nonzero (the block reads
// a row of V whole, coalesced) and alone writes S[:, c] and D[c] (D[a, f]
// with a == b is D[c]): no atomics, and the sums run in the nonzeros'
// order. On return the staging holds the row's last chunk.
template <typename IndexT>
__device__ void build_S(float* S, float* D, Staged& st, const Column& first,
                        int64_t lo, int64_t hi,
                        const IndexT* __restrict__ index,
                        const float* __restrict__ value,
                        const int64_t* __restrict__ field,
                        const float* __restrict__ V, int64_t num_features,
                        int nf, int K) {
  const int nk = nf * K;
  const int floats = nf * nk + (D != nullptr ? nk : 0);
  for (int t = threadIdx.x; t < floats; t += blockDim.x) S[t] = 0.0f;
  for (int64_t k0 = lo; k0 < hi; k0 += kChunk) {
    const int m = stage(st, k0, hi, index, value, field, num_features, nf, nk);
    for (Column col = first; col.c < nk; col.next(K)) {
      float* s_col = S + col.c;  // S[a, b, f] at a * nk
      for (int t0 = 0; t0 < m; t0 += kBatch) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int64_t base = t0 + u < m ? st.base[t0 + u] : -1;
          v[u] = base >= 0 ? __ldg(V + base + col.c) : nan_f();
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (t0 + u >= m) break;
          const int a = st.a[t0 + u];
          const float vx = __fmul_rn(st.x[t0 + u], v[u]);
          s_col[a * nk] += vx;
          if (D != nullptr && a == col.b) D[col.c] += __fmul_rn(vx, vx);
        }
      }
    }
  }
  __syncthreads();
}

// pair = 1/2 (sum_{a != b} <S[a,b], S[b,a]> + sum_a (|S[a,a]|^2 - D[a])):
// the reference's total minus its diagonal, with the diagonal taken off
// entry by entry. Where a field holds one nonzero (Criteo's rows), its
// S[a,a,f]^2 - D[a,f] is exactly 0, and a row of one nonzero has a pair of
// exactly 0, as the reference's eager value (no FMA contraction: the
// products are rounded on their own). The thread of column (b, f) sums over
// a; its reads of S[b, a, f] fall in distinct banks across a warp (at 39/4:
// b * 156 mod 32 = 28 b). One block reduction in a fixed order makes the
// result deterministic.
//
// kGlobal: S and D in the block's part of the workspace, rows in a
// grid-stride loop; else in dynamic shared memory, one block per row.
template <typename IndexT, bool kGlobal>
__global__ void __launch_bounds__(kMaxBlockThreads)
    ffm_pair_fwd_kernel(const int64_t* __restrict__ offset,
                        const IndexT* __restrict__ index,
                        const float* __restrict__ value,
                        const int64_t* __restrict__ field,
                        const float* __restrict__ V, int64_t num_rows,
                        int64_t nnz, int64_t num_features, int nf, int K,
                        float* __restrict__ pair, float* workspace) {
  extern __shared__ float S_shared[];
  __shared__ Staged st;
  __shared__ float scratch[kMaxBlockThreads / kWarp];
  const int nk = nf * K;
  float* S = kGlobal ? workspace + blockIdx.x * ffm_shared_floats(nf, K)
                     : S_shared;
  float* D = S + nf * nk;
  const Column first(K);
  const auto one_row = [&](int64_t row) {
    int64_t lo, hi;
    row_range(offset, row, nnz, &lo, &hi);
    build_S(S, D, st, first, lo, hi, index, value, field, V, num_features,
            nf, K);
    float total = 0.0f;
    for (Column col = first; col.c < nk; col.next(K)) {
      const float* mine = S + col.c;                // S[a, b, f] at a * nk
      const float* other = S + col.b * nk + col.f;  // S[b, a, f] at a * K
      for (int a = 0; a < nf; ++a) {
        const float p = __fmul_rn(mine[a * nk], other[a * K]);
        total += a == col.b ? p - D[col.c] : p;
      }
    }
    const float sum = block_sum(total, scratch);
    if (threadIdx.x == 0) pair[row] = 0.5f * sum;
  };
  if (kGlobal) {
    for (int64_t row = blockIdx.x; row < num_rows; row += gridDim.x) {
      __syncthreads();  // the previous row's readers are done
      one_row(row);
    }
  } else {
    one_row(blockIdx.x);  // a block per row
  }
}

// gV[j_k, b, f] += g[r] x_k (S[b, a_k, f] - [b = a_k] x_k V[j_k, b, f]) for
// each valid nonzero k of the row: the thread of column c adds into gV[j_k,
// c], so each nonzero is one coalesced row of fp32 reductions. kGlobal as
// in the forward.
template <typename IndexT, bool kGlobal>
__global__ void __launch_bounds__(kMaxBlockThreads)
    ffm_pair_bwd_kernel(const int64_t* __restrict__ offset,
                        const IndexT* __restrict__ index,
                        const float* __restrict__ value,
                        const int64_t* __restrict__ field,
                        const float* __restrict__ V,
                        const float* __restrict__ g, int64_t num_rows,
                        int64_t nnz, int64_t num_features, int nf, int K,
                        float* __restrict__ gV, float* workspace) {
  extern __shared__ float S_shared[];
  __shared__ Staged st;
  const int nk = nf * K;
  float* S = kGlobal ? workspace + blockIdx.x * ffm_shared_floats(nf, K)
                     : S_shared;
  const Column first(K);
  const auto one_row = [&](int64_t row) {
    int64_t lo, hi;
    row_range(offset, row, nnz, &lo, &hi);
    build_S(S, nullptr, st, first, lo, hi, index, value, field, V,
            num_features, nf, K);
    const float gr = g[row];
    // a row of one chunk is still staged from the build
    const bool restage = hi - lo > kChunk;
    for (int64_t k0 = lo; k0 < hi; k0 += kChunk) {
      const int m = restage ? stage(st, k0, hi, index, value, field,
                                    num_features, nf, nk)
                            : static_cast<int>(hi - lo);
      for (Column col = first; col.c < nk; col.next(K)) {
        const float* s_b = S + col.b * nk + col.f;  // S[b, a, f] at a * K
        for (int t0 = 0; t0 < m; t0 += kBatch) {
          float own[kBatch];  // V[j, c] where the nonzero's field is b
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int t = t0 + u;
            const bool mine = t < m && st.base[t] >= 0 && st.a[t] == col.b;
            own[u] = mine ? __ldg(V + st.base[t] + col.c) : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int t = t0 + u;
            if (t >= m) break;
            const int64_t base = st.base[t];
            if (base < 0) continue;
            const int a = st.a[t];
            const float x = st.x[t];
            float d = s_b[a * K];
            if (a == col.b) d -= __fmul_rn(x, own[u]);
            atomicAdd(gV + base + col.c, gr * x * d);
          }
        }
      }
    }
  };
  if (kGlobal) {
    for (int64_t row = blockIdx.x; row < num_rows; row += gridDim.x) {
      __syncthreads();  // the previous row's readers are done
      one_row(row);
    }
  } else {
    one_row(blockIdx.x);  // a block per row
  }
}

// A K6 block's threads: nf * K rounded up to a warp, at most
// kMaxBlockThreads.
unsigned ffm_threads(int64_t nf, int64_t K) {
  const int64_t t = (nf * K + kWarp - 1) / kWarp * kWarp;
  return static_cast<unsigned>(t < kMaxBlockThreads ? t : kMaxBlockThreads);
}

// Checks the size of S and raises the kernel's dynamic shared-memory limit
// where S needs more than the default 48 KB.
template <typename Kernel>
cudaError_t prepare_ffm(Kernel kernel, int64_t nf, int64_t K,
                        int64_t* bytes) {
  *bytes = ffm_shared_floats(nf, K) * static_cast<int64_t>(sizeof(float));
  int64_t most = 0;
  cudaError_t err = dmlc_device::max_shared_bytes(&most);
  if (err != cudaSuccess) return err;
  if (*bytes > most - kStaticSharedBytes) return cudaErrorInvalidValue;
  if (*bytes > dmlc_device::kDefaultSharedBytes) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(*bytes));
  }
  return err;
}

// One K6 call's inputs.
struct FfmArgs {
  const int64_t* offset;
  const void* index;
  const float* value;
  const int64_t* field;
  const float* V;
  int64_t num_rows, nnz, num_features, nf, K;
  cudaStream_t stream;
};

// The grid and dynamic shared memory of a K6 launch: for the shared route
// a block per row and S in dynamic shared memory (the limit raised where S
// needs more than 48 KB), for the global route `blocks` blocks over the
// workspace.
template <bool kGlobal, typename Kernel>
cudaError_t ffm_config(Kernel kernel, const FfmArgs& a, int64_t blocks,
                       unsigned* grid, int64_t* bytes) {
  *bytes = 0;
  if (kGlobal) {
    if (blocks <= 0) return cudaErrorInvalidValue;
    *grid = static_cast<unsigned>(blocks);
    return cudaSuccess;
  }
  *grid = static_cast<unsigned>(a.num_rows);
  return prepare_ffm(kernel, a.nf, a.K, bytes);
}

template <typename IndexT, bool kGlobal>
cudaError_t ffm_fwd(const FfmArgs& a, float* pair, float* workspace,
                    int64_t blocks) {
  const auto kernel = ffm_pair_fwd_kernel<IndexT, kGlobal>;
  unsigned grid = 0;
  int64_t bytes = 0;
  const cudaError_t err = ffm_config<kGlobal>(kernel, a, blocks, &grid,
                                              &bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, ffm_threads(a.nf, a.K), bytes, a.stream>>>(
      a.offset, static_cast<const IndexT*>(a.index), a.value, a.field, a.V,
      a.num_rows, a.nnz, a.num_features, static_cast<int>(a.nf),
      static_cast<int>(a.K), pair, workspace);
  return cudaGetLastError();
}

template <typename IndexT, bool kGlobal>
cudaError_t ffm_bwd(const FfmArgs& a, const float* g, float* gV,
                    float* workspace, int64_t blocks) {
  const auto kernel = ffm_pair_bwd_kernel<IndexT, kGlobal>;
  unsigned grid = 0;
  int64_t bytes = 0;
  const cudaError_t err = ffm_config<kGlobal>(kernel, a, blocks, &grid,
                                              &bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, ffm_threads(a.nf, a.K), bytes, a.stream>>>(
      a.offset, static_cast<const IndexT*>(a.index), a.value, a.field, a.V,
      g, a.num_rows, a.nnz, a.num_features, static_cast<int>(a.nf),
      static_cast<int>(a.K), gV, workspace);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// pair[num_rows], s[num_rows, K] = the FM pair term of CSR(offset, index,
// value) over V[num_features, K]. index_bytes: 4 (u32 or int32) or 8 (u64).
int dmlc_fm_pair_fwd(const void* offset, const void* index, int index_bytes,
                     const void* value, const void* V, int64_t num_rows,
                     int64_t nnz, int64_t num_features, int64_t K,
                     void* pair, void* s, void* stream) {
  if (num_rows <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* off = static_cast<const int64_t*>(offset);
  const auto* val = static_cast<const float*>(value);
  const auto* v = static_cast<const float*>(V);
  auto* p = static_cast<float*>(pair);
  auto* so = static_cast<float*>(s);
  const int kp = lanes_per_nonzero(K);
  if (index_bytes == 4) {
    fm_pair_fwd_kernel<uint32_t><<<warp_grid(num_rows), kWarpThreads, 0, st>>>(
        off, static_cast<const uint32_t*>(index), val, v, num_rows, nnz,
        num_features, K, kp, p, so);
  } else if (index_bytes == 8) {
    fm_pair_fwd_kernel<uint64_t><<<warp_grid(num_rows), kWarpThreads, 0, st>>>(
        off, static_cast<const uint64_t*>(index), val, v, num_rows, nnz,
        num_features, K, kp, p, so);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// gV[num_features, K] += the gradient of sum_r g[r] pair[r] in V; gV must
// be zeroed by the caller, s is fm_pair_fwd's. vector: 1 for the vector
// route, 0 for the scalar one. Returns a cudaError_t:
// cudaErrorInvalidValue where the vector route is asked for and K % 4 != 0
// or V, s or gV is not 16-byte aligned.
int dmlc_fm_pair_bwd(const void* offset, const void* index, int index_bytes,
                     const void* value, const void* V, const void* s,
                     const void* g, int64_t num_rows, int64_t nnz,
                     int64_t num_features, int64_t K, void* gV, int vector,
                     void* stream) {
  if (num_rows <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* off = static_cast<const int64_t*>(offset);
  const auto* val = static_cast<const float*>(value);
  const auto* v = static_cast<const float*>(V);
  const auto* si = static_cast<const float*>(s);
  const auto* gi = static_cast<const float*>(g);
  auto* out = static_cast<float*>(gV);
  if (vector) {
    const auto misaligned = [](const void* p) {
      return reinterpret_cast<uintptr_t>(p) % 16 != 0;
    };
    if (K % 4 != 0 || misaligned(V) || misaligned(s) || misaligned(gV) ||
        (index_bytes != 4 && index_bytes != 8)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int qp = static_cast<int>(K / 4 < kWarp ? K / 4 : kWarp);
    if (index_bytes == 4) {
      fm_pair_bwd_vec_kernel<uint32_t>
          <<<warp_grid(num_rows), kWarpThreads, 0, st>>>(
              off, static_cast<const uint32_t*>(index), val, v, si, gi,
              num_rows, nnz, num_features, K, qp, out);
    } else {
      fm_pair_bwd_vec_kernel<uint64_t>
          <<<warp_grid(num_rows), kWarpThreads, 0, st>>>(
              off, static_cast<const uint64_t*>(index), val, v, si, gi,
              num_rows, nnz, num_features, K, qp, out);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int kp = lanes_per_nonzero(K);
  if (index_bytes == 4) {
    fm_pair_bwd_kernel<uint32_t><<<warp_grid(num_rows), kWarpThreads, 0, st>>>(
        off, static_cast<const uint32_t*>(index), val, v, si, gi, num_rows,
        nnz, num_features, K, kp, out);
  } else if (index_bytes == 8) {
    fm_pair_bwd_kernel<uint64_t><<<warp_grid(num_rows), kWarpThreads, 0, st>>>(
        off, static_cast<const uint64_t*>(index), val, v, si, gi, num_rows,
        nnz, num_features, K, kp, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// pair[num_rows] = the FFM pair term of CSR(offset, index, value) with
// field[nnz] (int64) over V[num_features, nf, K]. workspace: null for the
// shared-memory route, else `blocks` * (nf * nf * K + nf * K) floats for
// the global route. Returns a cudaError_t: cudaErrorInvalidValue where the
// shared route is asked for and S does not fit a block's shared memory.
int dmlc_ffm_pair_fwd(const void* offset, const void* index, int index_bytes,
                      const void* value, const void* field, const void* V,
                      int64_t num_rows, int64_t nnz, int64_t num_features,
                      int64_t nf, int64_t K, void* pair, void* workspace,
                      int64_t blocks, void* stream) {
  if (num_rows <= 0) return static_cast<int>(cudaGetLastError());
  const FfmArgs a{static_cast<const int64_t*>(offset), index,
                  static_cast<const float*>(value),
                  static_cast<const int64_t*>(field),
                  static_cast<const float*>(V), num_rows, nnz, num_features,
                  nf, K, static_cast<cudaStream_t>(stream)};
  auto* p = static_cast<float*>(pair);
  auto* ws = static_cast<float*>(workspace);
  const bool global = ws != nullptr;
  cudaError_t err;
  if (index_bytes == 4) {
    err = global ? ffm_fwd<uint32_t, true>(a, p, ws, blocks)
                 : ffm_fwd<uint32_t, false>(a, p, ws, blocks);
  } else if (index_bytes == 8) {
    err = global ? ffm_fwd<uint64_t, true>(a, p, ws, blocks)
                 : ffm_fwd<uint64_t, false>(a, p, ws, blocks);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// gV[num_features, nf, K] += the gradient of sum_r g[r] pair[r] in V; gV
// must be zeroed by the caller. workspace and the result as the forward's.
int dmlc_ffm_pair_bwd(const void* offset, const void* index, int index_bytes,
                      const void* value, const void* field, const void* V,
                      const void* g, int64_t num_rows, int64_t nnz,
                      int64_t num_features, int64_t nf, int64_t K, void* gV,
                      void* workspace, int64_t blocks, void* stream) {
  if (num_rows <= 0) return static_cast<int>(cudaGetLastError());
  const FfmArgs a{static_cast<const int64_t*>(offset), index,
                  static_cast<const float*>(value),
                  static_cast<const int64_t*>(field),
                  static_cast<const float*>(V), num_rows, nnz, num_features,
                  nf, K, static_cast<cudaStream_t>(stream)};
  const auto* gi = static_cast<const float*>(g);
  auto* out = static_cast<float*>(gV);
  auto* ws = static_cast<float*>(workspace);
  const bool global = ws != nullptr;
  cudaError_t err;
  if (index_bytes == 4) {
    err = global ? ffm_bwd<uint32_t, true>(a, gi, out, ws, blocks)
                 : ffm_bwd<uint32_t, false>(a, gi, out, ws, blocks);
  } else if (index_bytes == 8) {
    err = global ? ffm_bwd<uint64_t, true>(a, gi, out, ws, blocks)
                 : ffm_bwd<uint64_t, false>(a, gi, out, ws, blocks);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
