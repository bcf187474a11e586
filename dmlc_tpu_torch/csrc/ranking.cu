// The pairwise ranking loss (RankNet) over one batch and its gradient in
// the margins, hand-written for Hopper (sm_90a), with a plain C interface
// bound by ctypes from dmlc_tpu_torch/ops/ranking.py.
//
// What they replace. The JAX package has no hand-written device kernel:
// XLA compiled these computations from jnp.
//   K7 pair_sums_fwd <- dmlc_tpu/models/ranking.py:51 _pair_weights and :64
//                       _pair_sums: pw[i,j] = w_i w_j where qid_i == qid_j
//                       >= 0 and label_i > label_j (else 0);
//                       lsum = sum_ij softplus(-(m_i - m_j)) pw[i,j],
//                       wsum = sum_ij pw[i,j].
//   K7 pair_sums_bwd <- its gradient in the margins (jax.value_and_grad in
//                       dmlc_tpu/models/common.py:89): for the cotangent s
//                       of lsum, g_i = sum_j (s pw[j,i]) sp'(m_i - m_j) -
//                       sum_j (s pw[i,j]) sp'(m_j - m_i).
//
// Semantics kept from the reference, which evaluates all n^2 pairs:
//   - every pair is evaluated and softplus(-d) * pw formed, those with
//     pw = 0 too, so a NaN or infinite margin anywhere makes lsum NaN
//     (NaN * 0, and inf - inf on the diagonal), and the gradient is NaN
//     exactly where jax.vjp puts it;
//   - softplus is jax.nn.softplus (logaddexp(x, 0)): x where x is NaN,
//     else max(x, 0) + log1p(exp(-|x|)); its derivative is the one jax's
//     logaddexp jvp forms, exp(x - softplus(x)) with +inf read as 0. No
//     fast-math intrinsics: expf and log1pf are the accurate ones;
//   - pw is (w_i * w_j) * [pair], so a NaN weight poisons its pairs as in
//     the reference.
//
// Bound on the card (H100 SXM, 3.35 TB/s, 67 TFLOP/s fp32). The inputs are
// 20 B a row (margin, label, weight, qid), so the bytes bound is well
// under a microsecond at the reference's 4096 rows. The operations that
// the batch needs are those of the pairs with pw != 0, a few hundred
// thousand at 4096 rows: also under a microsecond. Evaluating all 16.7M
// pairs, as the reference does, costs far more than either: a first kernel
// that is right, not one that is fast. A later one can skip tiles with no
// weighted pair, once it keeps the NaN semantics by another route.
//
// Design. Rows of the batch are documents. One warp per row i, 8 rows a
// block; the block sweeps j in tiles of 256 documents that its threads
// load into shared memory (margin, label, weight, qid), each warp's lanes
// striding over the tile. No [n, n] array exists.
//   - forward: each warp writes its row's (sum_j softplus * pw, sum_j pw)
//     to a scratch of 2n floats (the wrapper's); a second kernel, one
//     block, sums them in a fixed order, so lsum and wsum are
//     deterministic;
//   - backward: each warp writes g_i; no atomics, deterministic.
// Both launch on the caller's stream and allocate nothing; each C entry
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;  // 8 warps = 8 rows per block
constexpr int kRowsPerBlock = kThreads / kWarp;
constexpr int kTile = kThreads;  // documents j per shared-memory tile
constexpr int kSumThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// jax.nn.softplus: logaddexp(x, 0).
__device__ __forceinline__ float softplus(float x) {
  if (isnan(x)) return x;
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// d softplus / dx as jax's logaddexp jvp forms it: exp(x - softplus(x)),
// each +inf read as 0.
__device__ __forceinline__ float softplus_grad(float x) {
  const float sp = softplus(x);
  const float xr = (isinf(x) && x > 0.0f) ? 0.0f : x;
  const float sr = (isinf(sp) && sp > 0.0f) ? 0.0f : sp;
  return expf(xr - sr);
}

// pw of the ordered pair (a, b): (w_a * w_b) * [qid_a == qid_b >= 0 and
// label_a > label_b].
__device__ __forceinline__ float pair_weight(int64_t qa, int64_t qb, float la,
                                             float lb, float wa, float wb) {
  const bool on = qa >= 0 && qb >= 0 && qa == qb && la > lb;
  return __fmul_rn(__fmul_rn(wa, wb), on ? 1.0f : 0.0f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

struct Tile {
  float m[kTile];
  float label[kTile];
  float weight[kTile];
  int64_t qid[kTile];
};

// Loads documents [j0, j0 + kTile) into the tile (one per thread); returns
// how many there are.
__device__ __forceinline__ int load_tile(Tile* t, int64_t j0, int64_t n,
                                         const float* __restrict__ m,
                                         const float* __restrict__ label,
                                         const int64_t* __restrict__ qid,
                                         const float* __restrict__ weight) {
  const int64_t j = j0 + threadIdx.x;
  if (j < n) {
    t->m[threadIdx.x] = m[j];
    t->label[threadIdx.x] = label[j];
    t->weight[threadIdx.x] = weight[j];
    t->qid[threadIdx.x] = qid[j];
  }
  return static_cast<int>(n - j0 < kTile ? n - j0 : kTile);
}

__global__ void __launch_bounds__(kThreads)
    pair_rows_fwd_kernel(const float* __restrict__ m,
                         const float* __restrict__ label,
                         const int64_t* __restrict__ qid,
                         const float* __restrict__ weight, int64_t n,
                         float* __restrict__ row_l, float* __restrict__ row_w) {
  __shared__ Tile tile;
  const int lane = threadIdx.x % kWarp;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                    threadIdx.x / kWarp;
  const bool has_i = i < n;  // no early return: the block syncs per tile
  const float mi = has_i ? m[i] : 0.0f;
  const float li = has_i ? label[i] : 0.0f;
  const float wi = has_i ? weight[i] : 0.0f;
  const int64_t qi = has_i ? qid[i] : -1;
  float acc_l = 0.0f, acc_w = 0.0f;
  for (int64_t j0 = 0; j0 < n; j0 += kTile) {
    const int count = load_tile(&tile, j0, n, m, label, qid, weight);
    __syncthreads();
    if (has_i) {
      for (int t = lane; t < count; t += kWarp) {
        const float pw = pair_weight(qi, tile.qid[t], li, tile.label[t], wi,
                                     tile.weight[t]);
        acc_l += __fmul_rn(softplus(-(mi - tile.m[t])), pw);
        acc_w += pw;
      }
    }
    __syncthreads();
  }
  acc_l = warp_sum(acc_l);
  acc_w = warp_sum(acc_w);
  if (has_i && lane == 0) {
    row_l[i] = acc_l;
    row_w[i] = acc_w;
  }
}

// lsum = sum_i row_l[i], wsum = sum_i row_w[i], in a fixed order.
__global__ void __launch_bounds__(kSumThreads)
    sum_rows_kernel(const float* __restrict__ row_l,
                    const float* __restrict__ row_w, int64_t n,
                    float* __restrict__ lsum, float* __restrict__ wsum) {
  __shared__ float part_l[kSumThreads / kWarp], part_w[kSumThreads / kWarp];
  float a = 0.0f, b = 0.0f;
  for (int64_t i = threadIdx.x; i < n; i += kSumThreads) {
    a += row_l[i];
    b += row_w[i];
  }
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  if (lane == 0) {
    part_l[warp] = a;
    part_w[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = warp_sum(part_l[lane]);
    b = warp_sum(part_w[lane]);
    if (lane == 0) {
      *lsum = a;
      *wsum = b;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    pair_rows_bwd_kernel(const float* __restrict__ m,
                         const float* __restrict__ label,
                         const int64_t* __restrict__ qid,
                         const float* __restrict__ weight,
                         const float* __restrict__ s_in, int64_t n,
                         float* __restrict__ g) {
  __shared__ Tile tile;
  const int lane = threadIdx.x % kWarp;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                    threadIdx.x / kWarp;
  const bool has_i = i < n;
  const float s = *s_in;
  const float mi = has_i ? m[i] : 0.0f;
  const float li = has_i ? label[i] : 0.0f;
  const float wi = has_i ? weight[i] : 0.0f;
  const int64_t qi = has_i ? qid[i] : -1;
  float acc = 0.0f;
  for (int64_t j0 = 0; j0 < n; j0 += kTile) {
    const int count = load_tile(&tile, j0, n, m, label, qid, weight);
    __syncthreads();
    if (has_i) {
      for (int t = lane; t < count; t += kWarp) {
        const float mj = tile.m[t], lj = tile.label[t], wj = tile.weight[t];
        const int64_t qj = tile.qid[t];
        // pair (j, i): softplus(-(m_j - m_i)) pulls m_i up
        const float up = __fmul_rn(
            __fmul_rn(s, pair_weight(qj, qi, lj, li, wj, wi)),
            softplus_grad(-(mj - mi)));
        // pair (i, j): softplus(-(m_i - m_j)) pushes m_i down
        const float down = __fmul_rn(
            __fmul_rn(s, pair_weight(qi, qj, li, lj, wi, wj)),
            softplus_grad(-(mi - mj)));
        acc += up - down;
      }
    }
    __syncthreads();
  }
  acc = warp_sum(acc);
  if (has_i && lane == 0) g[i] = acc;
}

unsigned row_grid(int64_t n) {
  return static_cast<unsigned>((n + kRowsPerBlock - 1) / kRowsPerBlock);
}

}  // namespace

extern "C" {

// *lsum, *wsum of the batch's n documents (margins, label, weight float32;
// qid int64, -1 for padding). row_sums: scratch of 2n floats. Returns a
// cudaError_t.
int dmlc_pair_sums_fwd(const void* margins, const void* label,
                       const void* qid, const void* weight, int64_t n,
                       void* row_sums, void* lsum, void* wsum,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* rows = static_cast<float*>(row_sums);
  if (n > 0) {
    pair_rows_fwd_kernel<<<row_grid(n), kThreads, 0, s>>>(
        static_cast<const float*>(margins), static_cast<const float*>(label),
        static_cast<const int64_t*>(qid), static_cast<const float*>(weight),
        n, rows, rows + n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sum_rows_kernel<<<1, kSumThreads, 0, s>>>(rows, rows + n, n,
                                            static_cast<float*>(lsum),
                                            static_cast<float*>(wsum));
  return static_cast<int>(cudaGetLastError());
}

// g[n] = the gradient of s * lsum in the margins, s read from the device
// scalar s. Returns a cudaError_t.
int dmlc_pair_sums_bwd(const void* margins, const void* label,
                       const void* qid, const void* weight, const void* s,
                       int64_t n, void* g, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  pair_rows_bwd_kernel<<<row_grid(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(margins), static_cast<const float*>(label),
      static_cast<const int64_t*>(qid), static_cast<const float*>(weight),
      static_cast<const float*>(s), n, static_cast<float*>(g));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
