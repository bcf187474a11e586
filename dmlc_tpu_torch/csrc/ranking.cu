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
//   - every pair's softplus(-d) * pw counts, those with pw = 0 too, so a
//     NaN or infinite margin anywhere makes lsum NaN (NaN * 0, and
//     inf - inf on the diagonal), and the gradient is NaN exactly where
//     jax.vjp puts it;
//   - softplus is jax.nn.softplus (logaddexp(x, 0)): x where x is NaN,
//     else max(x, 0) + log1p(exp(-|x|)); its derivative is the one jax's
//     logaddexp jvp forms, exp(x - softplus(x)) with +inf read as 0. No
//     fast-math intrinsics: expf and log1pf are the accurate ones;
//   - pw is (w_i * w_j) * [pair], so a NaN weight poisons its pairs as in
//     the reference.
//
// The skip rule. A pair with pw = 0 adds exactly +-0 to lsum, wsum and g
// (and so changes no sum) when the batch is "safe":
//   - every margin and every weight is finite;
//   - fl(max m - min m) is finite, so every m_i - m_j is (rounding is
//     monotone), its softplus is finite and sp' lies in [0, 1];
//   - fl(max|w| * max|w|) is finite, so every w_i * w_j is, and
//     (w_i * w_j) * 0 is +-0;
//   - in the backward, the cotangent s is finite, so s * pw is +-0.
// Then only pairs with pw != 0 need evaluating, and those have qid_i ==
// qid_j >= 0. Each condition that fails is a case where the reference
// answers NaN or inf somewhere (the diagonal pair is never weighted, so
// max|w|^2 overflowing means some unweighted product overflows); there the
// kernels evaluate every pair, as the reference does. The decision stays on
// the device: a pre-pass writes the flag into a tile table that every block
// reads.
//
// Bound on the card (H100 SXM, 3.35 TB/s, 67 TFLOP/s fp32). The inputs are
// 20 B a row (margin, label, weight, qid), so the bytes bound is well under
// a microsecond at the reference's 4096 rows. The operations the batch
// needs are those of the pairs with pw != 0, a few hundred thousand at
// 4096 rows: also under a microsecond. What is left is latency: two short
// dependent kernels (pre-pass, pairs) in the forward, one in the backward,
// each a chain of round trips to memory that the design keeps short.
//
// Design. Rows of the batch are documents, cut into tiles of T documents.
//   - pre-pass (one block): the safe flag, and for each tile the least and
//     the largest qid of its valid documents (qid >= 0; an empty tile gets
//     the empty interval [INT64_MAX, -1]). The table, int64 [2 + 2 tiles]:
//     table[0] the flag, table[1] the forward's count of finished blocks,
//     table[2 + 2t], table[3 + 2t] tile t's interval. The forward writes
//     it; the backward reads the forward's.
//   - pairs: one warp per row i, R rows a block. The block computes its
//     rows' valid-qid interval and, when the flag is set, skips every tile
//     whose interval does not meet it (a tile skipped is one whose pairs
//     with the block's rows all have pw = 0, whatever the qid order: qids
//     in contiguous queries, as LETOR files keep them, give a block one to
//     four tiles of 128 to visit). Its threads read the table's entries at
//     once, R * 32 tiles at a time, and list the tiles to visit in shared
//     memory (a ballot and a prefix count), so a skipped tile costs no
//     round trip. A visited tile is loaded into shared memory (margin,
//     label, weight, qid) from registers that were filled while the block
//     worked on the one before, and each warp's lanes stride over it; a
//     warp whose own qid lies outside the tile's interval skips it too.
//     With the flag set, the transcendentals run only where pw != 0; with
//     it clear, every pair is evaluated as the reference does. Either way
//     the nonzero terms are summed in the same lane order, so skipping
//     changes no bit of any result.
//   - forward: each warp writes its row's (sum_j softplus * pw, sum_j pw)
//     to a scratch of 2n floats (the wrapper's); the last block to finish
//     (a count in the table) sums them in a fixed order, so lsum and wsum
//     are deterministic;
//   - backward: each warp writes g_i; no atomics, deterministic.
// T = 128 and R = 8 (kTile, kRows) were chosen by measurement on the H100
// at the ranking path's first batch (PERF.md). All kernels launch on the
// caller's stream and allocate nothing; each C entry returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kPrepThreads = 1024;  // 32 warps: one warp folds them
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kNoQid = INT64_MAX;  // the low end of an empty interval
constexpr int kTableHead = 2;  // the flag and the forward's block count
constexpr int kTile = 128;     // T: documents a tile (ops/ranking.py: _TILE)
constexpr int kRows = 8;       // R: rows a block, one warp each
constexpr int kThreads = kRows * kWarp;
// documents of a tile that one thread loads
constexpr int kPerThread = (kTile + kThreads - 1) / kThreads;

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

__device__ __forceinline__ int64_t warp_min(int64_t v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    const long long u = __shfl_xor_sync(kFull, static_cast<long long>(v), o);
    v = u < v ? u : v;
  }
  return v;
}

__device__ __forceinline__ int64_t warp_max(int64_t v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    const long long u = __shfl_xor_sync(kFull, static_cast<long long>(v), o);
    v = u > v ? u : v;
  }
  return v;
}

// The tile table (see the design note above). One block of kPrepThreads.
__global__ void __launch_bounds__(kPrepThreads)
    tile_table_kernel(const float* __restrict__ m,
                      const int64_t* __restrict__ qid,
                      const float* __restrict__ weight, int64_t n,
                      int64_t* __restrict__ table) {
  __shared__ float part[3][kPrepThreads / kWarp];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  bool finite = true;
  float hi = -INFINITY, lo = INFINITY, wmax = 0.0f;
  for (int64_t i = threadIdx.x; i < n; i += kPrepThreads) {
    const float mi = m[i], wi = weight[i];
    finite = finite && isfinite(mi) && isfinite(wi);
    hi = fmaxf(hi, mi);
    lo = fminf(lo, mi);
    wmax = fmaxf(wmax, fabsf(wi));
  }
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
    wmax = fmaxf(wmax, __shfl_xor_sync(kFull, wmax, o));
  }
  if (lane == 0) {
    part[0][warp] = hi;
    part[1][warp] = lo;
    part[2][warp] = wmax;
  }
  // every tile's valid-qid interval: warp w takes tiles w, w + 32, ...
  const int64_t tiles = (n + kTile - 1) / kTile;
  for (int64_t t = warp; t < tiles; t += kPrepThreads / kWarp) {
    int64_t qlo = kNoQid, qhi = -1;
    const int64_t end = (t + 1) * kTile < n ? (t + 1) * kTile : n;
    for (int64_t j = t * kTile + lane; j < end; j += kWarp) {
      const int64_t q = qid[j];
      if (q >= 0) {
        qlo = q < qlo ? q : qlo;
        qhi = q > qhi ? q : qhi;
      }
    }
    qlo = warp_min(qlo);
    qhi = warp_max(qhi);
    if (lane == 0) {
      table[kTableHead + 2 * t] = qlo;
      table[kTableHead + 2 * t + 1] = qhi;
    }
  }
  const bool all_finite = __syncthreads_and(finite);
  if (warp == 0) {  // one warp folds the 32 warps' partials
    hi = part[0][lane];
    lo = part[1][lane];
    wmax = part[2][lane];
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1) {
      hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
      lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
      wmax = fmaxf(wmax, __shfl_xor_sync(kFull, wmax, o));
    }
    if (lane == 0) {
      const float spread = hi - lo;
      const float wsq = __fmul_rn(wmax, wmax);
      table[0] = all_finite && isfinite(spread) && isfinite(wsq) ? 1 : 0;
      table[1] = 0;  // the forward's count of finished blocks
    }
  }
}

struct Tile {
  float m[kTile];
  float label[kTile];
  float weight[kTile];
  int64_t qid[kTile];
};

// The documents of a tile that one thread loads, k = threadIdx.x + u *
// kThreads for u < kPerThread: the next tile's are read into these
// registers while the block works on the current one, then stored into
// the tile.
struct Prefetch {
  float m[kPerThread], label[kPerThread], weight[kPerThread];
  int64_t qid[kPerThread];
  int count;

  __device__ void load(int64_t j0, int64_t n, const float* __restrict__ ms,
                       const float* __restrict__ labels,
                       const int64_t* __restrict__ qids,
                       const float* __restrict__ weights) {
    count = static_cast<int>(n - j0 < kTile ? n - j0 : kTile);
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int k = threadIdx.x + u * kThreads;
      if (k < count) {
        m[u] = ms[j0 + k];
        label[u] = labels[j0 + k];
        weight[u] = weights[j0 + k];
        qid[u] = qids[j0 + k];
      }
    }
  }

  __device__ void store(Tile* t) const {
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int k = threadIdx.x + u * kThreads;
      if (k < count) {
        t->m[k] = m[u];
        t->label[k] = label[u];
        t->weight[k] = weight[u];
        t->qid[k] = qid[u];
      }
    }
  }
};

// The tiles a block visits, one chunk of kThreads tiles of the table at a
// time, in order: their index and interval.
struct Visits {
  int64_t tile[kThreads], lo[kThreads], hi[kThreads];
  int per_warp[kRows];
};

// What a block of kRows rows shares: its rows' valid-qid interval, and whether
// it may skip (the flag, and in the backward a finite s).
struct BlockView {
  int64_t lo, hi;
  bool safe;
};

// Every thread of the block calls it; qi is -1 where the warp has no row.
__device__ BlockView block_view(int64_t qi, bool safe) {
  __shared__ int64_t row_q[kRows];
  const int warp = threadIdx.x / kWarp;
  if (threadIdx.x % kWarp == 0) row_q[warp] = qi;
  __syncthreads();
  BlockView v{kNoQid, -1, safe};
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t q = row_q[r];
    if (q >= 0) {
      v.lo = q < v.lo ? q : v.lo;
      v.hi = q > v.hi ? q : v.hi;
    }
  }
  return v;
}

// Lists, in order, the tiles c0 .. c0 + kThreads - 1 that the block visits:
// every tile when it may not skip, else those whose interval meets the
// block's (an empty interval meets nothing). Each thread reads one tile's
// entry of the table, so a chunk costs one round trip to memory. Every
// thread calls it; returns how many tiles were listed.
__device__ int list_visits(Visits* v, const BlockView& b,
                           const int64_t* __restrict__ table, int64_t tiles,
                           int64_t c0) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int64_t t = c0 + threadIdx.x;
  int64_t lo = kNoQid, hi = -1;
  if (t < tiles) {
    lo = table[kTableHead + 2 * t];
    hi = table[kTableHead + 2 * t + 1];
  }
  const bool on = t < tiles && (!b.safe || (lo <= b.hi && hi >= b.lo));
  const unsigned mask = __ballot_sync(kFull, on);
  __syncthreads();  // the previous chunk's list has been read
  if (lane == 0) v->per_warp[warp] = __popc(mask);
  __syncthreads();
  int at = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kRows; ++w) {
    at += w < warp ? v->per_warp[w] : 0;
    total += v->per_warp[w];
  }
  if (on) {
    at += __popc(mask & ((1u << lane) - 1u));
    v->tile[at] = t;
    v->lo[at] = lo;
    v->hi[at] = hi;
  }
  __syncthreads();
  return total;
}

// Walks the tiles the block visits, each loaded into shared memory while
// the next one's documents are in flight, and calls visit(tile, tlo, thi,
// count) on each. Every thread calls it.
template <typename Visit>
__device__ void walk_tiles(const BlockView& b,
                           const int64_t* __restrict__ table, int64_t n,
                           const float* __restrict__ m,
                           const float* __restrict__ label,
                           const int64_t* __restrict__ qid,
                           const float* __restrict__ weight, Visit visit) {
  __shared__ Tile tile;
  __shared__ Visits v;
  Prefetch next;
  const int64_t tiles = (n + kTile - 1) / kTile;
  for (int64_t c0 = 0; c0 < tiles; c0 += kThreads) {
    const int listed = list_visits(&v, b, table, tiles, c0);
    if (listed > 0) next.load(v.tile[0] * kTile, n, m, label, qid, weight);
    for (int k = 0; k < listed; ++k) {
      const int64_t tlo = v.lo[k], thi = v.hi[k];
      __syncthreads();  // the previous tile's readers are done
      next.store(&tile);
      const int count = next.count;
      __syncthreads();
      if (k + 1 < listed) {
        next.load(v.tile[k + 1] * kTile, n, m, label, qid, weight);
      }
      visit(tile, tlo, thi, count);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    pair_rows_fwd_kernel(const float* __restrict__ m,
                         const float* __restrict__ label,
                         const int64_t* __restrict__ qid,
                         const float* __restrict__ weight, int64_t* table,
                         int64_t n, float* row_l, float* row_w,
                         float* __restrict__ lsum, float* __restrict__ wsum) {
  const int lane = threadIdx.x % kWarp;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kRows + threadIdx.x / kWarp;
  const bool has_i = i < n;  // no early return: the block syncs per tile
  const float mi = has_i ? m[i] : 0.0f;
  const float li = has_i ? label[i] : 0.0f;
  const float wi = has_i ? weight[i] : 0.0f;
  const int64_t qi = has_i ? qid[i] : -1;
  const BlockView b = block_view(qi, table[0] != 0);
  float acc_l = 0.0f, acc_w = 0.0f;
  walk_tiles(b, table, n, m, label, qid, weight,
             [&](const Tile& tile, int64_t tlo, int64_t thi, int count) {
    if (!has_i) return;
    if (!b.safe) {
      for (int k = lane; k < count; k += kWarp) {
        const float pw = pair_weight(qi, tile.qid[k], li, tile.label[k], wi,
                                     tile.weight[k]);
        acc_l += __fmul_rn(softplus(-(mi - tile.m[k])), pw);
        acc_w += pw;
      }
    } else if (tlo <= qi && qi <= thi) {
      for (int k = lane; k < count; k += kWarp) {
        const float pw = pair_weight(qi, tile.qid[k], li, tile.label[k], wi,
                                     tile.weight[k]);
        if (pw != 0.0f) {
          acc_l += __fmul_rn(softplus(-(mi - tile.m[k])), pw);
          acc_w += pw;
        }
      }
    }
  });
  acc_l = warp_sum(acc_l);
  acc_w = warp_sum(acc_w);
  if (has_i && lane == 0) {
    row_l[i] = acc_l;
    row_w[i] = acc_w;
  }
  // The last block to finish sums the rows in a fixed order, so lsum and
  // wsum do not depend on which block that is.
  __shared__ bool last;
  __shared__ float part_l[kRows], part_w[kRows];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long done = atomicAdd(
        reinterpret_cast<unsigned long long*>(table + 1), 1ull);
    last = done == gridDim.x - 1ull;
  }
  __syncthreads();
  if (!last) return;
  float a = 0.0f, c = 0.0f;
  for (int64_t r = threadIdx.x; r < n; r += kThreads) {
    a += __ldcg(row_l + r);
    c += __ldcg(row_w + r);
  }
  a = warp_sum(a);
  c = warp_sum(c);
  if (lane == 0) {
    part_l[threadIdx.x / kWarp] = a;
    part_w[threadIdx.x / kWarp] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = c = 0.0f;
    for (int w = 0; w < kRows; ++w) {
      a += part_l[w];
      c += part_w[w];
    }
    *lsum = a;
    *wsum = c;
  }
}

__global__ void __launch_bounds__(kThreads)
    pair_rows_bwd_kernel(const float* __restrict__ m,
                         const float* __restrict__ label,
                         const int64_t* __restrict__ qid,
                         const float* __restrict__ weight,
                         const float* __restrict__ s_in,
                         const int64_t* __restrict__ table, int64_t n,
                         float* __restrict__ g) {
  const int lane = threadIdx.x % kWarp;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kRows + threadIdx.x / kWarp;
  const bool has_i = i < n;
  const float s = *s_in;
  const float mi = has_i ? m[i] : 0.0f;
  const float li = has_i ? label[i] : 0.0f;
  const float wi = has_i ? weight[i] : 0.0f;
  const int64_t qi = has_i ? qid[i] : -1;
  const BlockView b = block_view(qi, table[0] != 0 && isfinite(s));
  float acc = 0.0f;
  walk_tiles(b, table, n, m, label, qid, weight,
             [&](const Tile& tile, int64_t tlo, int64_t thi, int count) {
    if (!has_i) return;
    if (!b.safe) {
      for (int k = lane; k < count; k += kWarp) {
        const float mj = tile.m[k], lj = tile.label[k], wj = tile.weight[k];
        const int64_t qj = tile.qid[k];
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
    } else if (tlo <= qi && qi <= thi) {
      // at most one of the two directions is weighted (label_i > label_j
      // or label_j > label_i), and the other adds exactly +-0: up - (+-0)
      // is up, (+-0) - down is -down
      for (int k = lane; k < count; k += kWarp) {
        const float mj = tile.m[k], lj = tile.label[k], wj = tile.weight[k];
        const int64_t qj = tile.qid[k];
        const float pw_up = pair_weight(qj, qi, lj, li, wj, wi);
        const float pw_down = pair_weight(qi, qj, li, lj, wi, wj);
        if (pw_up != 0.0f) {
          acc += __fmul_rn(__fmul_rn(s, pw_up), softplus_grad(-(mj - mi)));
        } else if (pw_down != 0.0f) {
          acc += -__fmul_rn(__fmul_rn(s, pw_down),
                            softplus_grad(-(mi - mj)));
        }
      }
    }
  });
  acc = warp_sum(acc);
  if (has_i && lane == 0) g[i] = acc;
}

struct Args {
  const float* m;
  const float* label;
  const int64_t* qid;
  const float* weight;
  int64_t n;
  cudaStream_t stream;
};

Args make_args(const void* margins, const void* label, const void* qid,
               const void* weight, int64_t n, void* stream) {
  return Args{static_cast<const float*>(margins),
              static_cast<const float*>(label),
              static_cast<const int64_t*>(qid),
              static_cast<const float*>(weight), n,
              static_cast<cudaStream_t>(stream)};
}

unsigned row_blocks(int64_t n) {
  return static_cast<unsigned>((n + kRows - 1) / kRows);
}

}  // namespace

extern "C" {

// *lsum, *wsum of the batch's n documents (margins, label, weight float32;
// qid int64, -1 for padding). row_sums: scratch of 2n floats; table: int64
// [2 + 2 * ceil(n / 128)], the tile table, written here for the backward.
// Returns a cudaError_t.
int dmlc_pair_sums_fwd(const void* margins, const void* label,
                       const void* qid, const void* weight, int64_t n,
                       void* row_sums, void* table, void* lsum, void* wsum,
                       void* stream) {
  const Args a = make_args(margins, label, qid, weight, n, stream);
  if (n <= 0) {
    cudaError_t err = cudaMemsetAsync(lsum, 0, sizeof(float), a.stream);
    if (err == cudaSuccess) {
      err = cudaMemsetAsync(wsum, 0, sizeof(float), a.stream);
    }
    return static_cast<int>(err);
  }
  int64_t* tb = static_cast<int64_t*>(table);
  float* rows = static_cast<float*>(row_sums);
  tile_table_kernel<<<1, kPrepThreads, 0, a.stream>>>(a.m, a.qid, a.weight,
                                                      a.n, tb);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_rows_fwd_kernel<<<row_blocks(n), kThreads, 0, a.stream>>>(
      a.m, a.label, a.qid, a.weight, tb, a.n, rows, rows + a.n,
      static_cast<float*>(lsum), static_cast<float*>(wsum));
  return static_cast<int>(cudaGetLastError());
}

// g[n] = the gradient of s * lsum in the margins, s read from the device
// scalar s, with the tile table that dmlc_pair_sums_fwd wrote on the same
// inputs. Returns a cudaError_t.
int dmlc_pair_sums_bwd(const void* margins, const void* label,
                       const void* qid, const void* weight, const void* s,
                       int64_t n, const void* table, void* g, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const Args a = make_args(margins, label, qid, weight, n, stream);
  pair_rows_bwd_kernel<<<row_blocks(n), kThreads, 0, a.stream>>>(
      a.m, a.label, a.qid, a.weight, static_cast<const float*>(s),
      static_cast<const int64_t*>(table), a.n, static_cast<float*>(g));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
