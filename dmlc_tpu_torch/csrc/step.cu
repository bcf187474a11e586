// The SGD step's objective and update, hand-written for Hopper (sm_90a),
// with a plain C interface bound by ctypes from dmlc_tpu_torch/ops/step.py.
//
// What they replace. The JAX package has no hand-written device kernel:
// XLA compiled these computations from jnp inside the one jitted
// train_step (dmlc_tpu/models/common.py:88) and sharded step (:130).
//   K8 logistic_*  <- stable_bce_on_logits (:28) and _weighted_mean (:18),
//                     summed by the linear and factor models'
//                     _block_objective (models/linear.py:58,
//                     models/fm.py:71), and their jax.value_and_grad in the
//                     margins.
//   K9 sgd_update  <- jax.tree.map(lambda p, g: p - lr * g) (:91, :133)
//                     with the l2 term of _l2_term (:62).
//
// K8. A row's margin is m = t0 (+ t1) + b (the model's margin terms, then
// its bias, added in the reference's order), y = label > 0, its loss
// max(m, 0) - m*y + log1p(exp(-|m|)), and d, the loss's derivative in m:
// sigma(m) - y where m != 0, and -y at m == 0 exactly, where the
// reference's jnp.maximum splits the tie in half and jnp.abs takes slope
// +1 (ROADMAP C4). sigma is formed stably from e = exp(-|m|): 1 / (1 + e)
// for m >= 0, e / (1 + e) below. lsum = sum weight*loss, wsum = sum weight,
// W = wsum if wsum > 0 else 1 (_weighted_mean's guard, not max(W, 1)), and
// g = (weight / W) * d, whose sum is the bias's gradient. A NaN margin
// gives a NaN loss (m*y is NaN even at y = 0) and a NaN d. expf and log1pf
// are the accurate library functions: the build has no fast math.
//
// Bound on the card (H100 SXM, 3.35 TB/s): K8 reads 12 bytes a row (t0,
// label, weight; 4 more with t1) and writes 4 (g): at the main path's 8192
// rows, 131 KB, 0.04 us, so a launch's latency bounds it. On one part, one
// block of 1024 threads takes every row: each thread sums its rows i,
// i + 1024, ... in order and the block reduces the threads in a fixed
// tree, so the result does not vary from run to run, and the block knows W
// without a second launch. It then computes g in a second sweep over the
// same rows (from L1/L2). The sharded step's W is the group's, after an
// all-reduce of (lsum, wsum) over the processes, so there it is two
// launches, each a grid of blocks of kGridRows rows: logistic_sums writes
// this process's (lsum, wsum), and logistic_grad reads the all-reduced pair
// from device memory (never from the host) and writes the loss, g and
// sum g. Their sums over the grid are grid_sum's: fixed in order too.
//
// K9. p <- p - lr * (g + 2 * l2 * p) for every parameter, the l2 term only
// where the parameter's flag says so (every parameter but the bias), in
// one launch: the table of (p, g, numel, flag) travels by value as the
// kernel's argument, so no copy to the device precedes it. It moves 12
// bytes a float (read p and g, write p) and does 3 flops: bound by bytes
// (FFM's w and V, 1.56e8 floats: 1.88 GB, 562 us). Each parameter is cut
// into a scalar head up to p's first 16-byte boundary, a float4 body and a
// scalar tail (all scalar where p and g are not aligned alike), and the
// grid strides over each parameter's pieces in turn. Where the caller asks
// for the loss's l2 term, each thread also sums p*p of the old p over the
// flagged parameters, and grid_sum adds them up in a fixed order; its last
// block adds l2 times the sum to the loss.
//
// grid_sum's counter of finished blocks is one device unsigned that
// atomicInc wraps back to 0 at each launch's last block, so it needs no
// fill between launches; two launches that share it must not overlap, so
// the caller gives each stream its own (ops/step.py).
//
// Each C entry launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kObjectiveThreads = 1024;
constexpr int kGridThreads = 256;
constexpr int kGridRows = 512;  // ops/step.py OBJECTIVE_GRID_ROWS
constexpr int kSgdThreads = 256;
constexpr int kSgdMaxParams = 16;  // ops/step.py SGD_MAX_PARAMS

// Sums v[0..N) over the block in a fixed order (lanes by a shuffle tree,
// then the warps' sums by warp 0) and gives every thread the sums. scratch
// holds N * kWarp floats; the block's threads are a multiple of kWarp.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* scratch) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1) {
      v[k] += __shfl_down_sync(kFull, v[k], o);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) scratch[k * kWarp + warp] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float x = lane < warps ? scratch[k * kWarp + lane] : 0.0f;
#pragma unroll
      for (int o = kWarp / 2; o > 0; o >>= 1) {
        x += __shfl_down_sync(kFull, x, o);
      }
      if (lane == 0) scratch[k * kWarp] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = scratch[k * kWarp];
  __syncthreads();  // scratch may be written again right after
}

// Sums v[0..N) over the grid in a fixed order: each block's sums
// (block_sum) go to partial[N * blockIdx.x + k], and the grid's last block
// to finish (counter, see the note at the top) sums the blocks' sums in
// block order. Returns true in that block, every thread of which then
// holds the grid's sums in v; false in the others. Every thread of the
// block calls it.
template <int N>
__device__ __forceinline__ bool grid_sum(float (&v)[N],
                                         float* __restrict__ partial,
                                         unsigned* counter, float* scratch) {
  __shared__ bool last;
  block_sum(v, scratch);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) partial[N * blockIdx.x + k] = v[k];
    __threadfence();
    last = atomicInc(counter, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return false;
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = 0.0f;
  for (unsigned i = threadIdx.x; i < gridDim.x; i += blockDim.x) {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] += __ldcg(partial + N * i + k);
  }
  block_sum(v, scratch);
  return true;
}

// The margin inputs of K8: t0 [n], t1 [n] or null, bias (one float) or null.
struct Margins {
  const float* t0;
  const float* t1;
  const float* bias;
};

__device__ __forceinline__ float margin_at(const Margins& mg, int64_t i) {
  float m = mg.t0[i];
  if (mg.t1 != nullptr) m += mg.t1[i];
  if (mg.bias != nullptr) m += *mg.bias;
  return m;
}

// The row's loss and d (see the note at the top).
__device__ __forceinline__ void row_loss(float m, float label, float* loss,
                                         float* d) {
  const float y = label > 0.0f ? 1.0f : 0.0f;
  const float e = expf(-(m >= 0.0f ? m : -m));
  *loss = (m > 0.0f ? m : 0.0f) - m * y + log1pf(e);
  const float sigma = m >= 0.0f ? 1.0f / (1.0f + e) : e / (1.0f + e);
  *d = m == 0.0f ? -y : sigma - y;
}

// This thread's share of (lsum, wsum) over rows [begin, end): rows
// begin + threadIdx.x, + blockDim.x, ... in order.
__device__ __forceinline__ void thread_sums(
    const Margins& mg, const float* __restrict__ label,
    const float* __restrict__ weight, int64_t begin, int64_t end,
    float (&sums)[2]) {
  sums[0] = sums[1] = 0.0f;
  for (int64_t i = begin + threadIdx.x; i < end; i += blockDim.x) {
    float loss, d;
    row_loss(margin_at(mg, i), label[i], &loss, &d);
    const float w = weight[i];
    sums[0] += loss * w;
    sums[1] += w;
  }
}

// g = (weight / W) * d over rows [begin, end), as thread_sums visits them;
// returns this thread's share of sum g.
__device__ __forceinline__ float thread_grad(
    const Margins& mg, const float* __restrict__ label,
    const float* __restrict__ weight, int64_t begin, int64_t end, float W,
    float* __restrict__ g) {
  const float inv = 1.0f / W;
  float gsum = 0.0f;
  for (int64_t i = begin + threadIdx.x; i < end; i += blockDim.x) {
    float loss, d;
    row_loss(margin_at(mg, i), label[i], &loss, &d);
    const float gi = (weight[i] * inv) * d;
    g[i] = gi;
    gsum += gi;
  }
  return gsum;
}

__device__ __forceinline__ float guarded(float wsum) {
  return wsum > 0.0f ? wsum : 1.0f;
}

__global__ void __launch_bounds__(kObjectiveThreads)
    logistic_step_kernel(Margins mg, const float* __restrict__ label,
                         const float* __restrict__ weight, int64_t n,
                         float* __restrict__ loss, float* __restrict__ g,
                         float* __restrict__ gb) {
  __shared__ float scratch[2 * kWarp];
  float sums[2];
  thread_sums(mg, label, weight, 0, n, sums);
  block_sum(sums, scratch);
  const float W = guarded(sums[1]);
  float gsum[1] = {thread_grad(mg, label, weight, 0, n, W, g)};
  block_sum(gsum, scratch);
  if (threadIdx.x == 0) {
    *loss = sums[0] / W;
    *gb = gsum[0];
  }
}

// The sharded launches: block b takes rows [b * kGridRows, + kGridRows).
__device__ __forceinline__ int64_t grid_begin() {
  return static_cast<int64_t>(blockIdx.x) * kGridRows;
}

__device__ __forceinline__ int64_t grid_end(int64_t n) {
  const int64_t end = grid_begin() + kGridRows;
  return end < n ? end : n;
}

__global__ void __launch_bounds__(kGridThreads)
    logistic_sums_kernel(Margins mg, const float* __restrict__ label,
                         const float* __restrict__ weight, int64_t n,
                         float* __restrict__ partial, unsigned* counter,
                         float* __restrict__ total) {
  __shared__ float scratch[2 * kWarp];
  float sums[2];
  thread_sums(mg, label, weight, grid_begin(), grid_end(n), sums);
  if (grid_sum(sums, partial, counter, scratch) && threadIdx.x == 0) {
    total[0] = sums[0];
    total[1] = sums[1];
  }
}

__global__ void __launch_bounds__(kGridThreads)
    logistic_grad_kernel(Margins mg, const float* __restrict__ label,
                         const float* __restrict__ weight, int64_t n,
                         const float* __restrict__ total,
                         float* __restrict__ loss, float* __restrict__ g,
                         float* __restrict__ partial, unsigned* counter,
                         float* __restrict__ gb) {
  __shared__ float scratch[kWarp];
  const float W = guarded(total[1]);
  float gsum[1] = {
      thread_grad(mg, label, weight, grid_begin(), grid_end(n), W, g)};
  if (grid_sum(gsum, partial, counter, scratch) && threadIdx.x == 0) {
    *loss = total[0] / W;
    *gb = gsum[0];
  }
}

// ---------------------------------------------------------------- K9

// One launch's parameters, by value: p[k] (numel[k] floats) and its
// gradient g[k], cut into head[k] scalars, body[k] float4s and the rest
// scalars; decay[k]: whether the l2 term applies.
struct SgdTable {
  float* p[kSgdMaxParams];
  const float* g[kSgdMaxParams];
  int64_t numel[kSgdMaxParams];
  int64_t head[kSgdMaxParams];
  int64_t body[kSgdMaxParams];
  int decay[kSgdMaxParams];
  int count;
};

__device__ __forceinline__ float sgd_one(float p, float g, float lr,
                                         float two_l2, bool decay,
                                         float* sq) {
  if (decay) {
    *sq += p * p;
    g = fmaf(two_l2, p, g);
  }
  return fmaf(-lr, g, p);
}

__global__ void __launch_bounds__(kSgdThreads)
    sgd_update_kernel(SgdTable t, float lr, float l2,
                      float* __restrict__ partial, unsigned* counter,
                      float* __restrict__ loss) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const float two_l2 = 2.0f * l2;
  float sq = 0.0f;
  for (int k = 0; k < t.count; ++k) {
    float* __restrict__ p = t.p[k];
    const float* __restrict__ g = t.g[k];
    const bool decay = t.decay[k] != 0 && l2 != 0.0f;
    const int64_t head = t.head[k], body = t.body[k];
    const int64_t tail = t.numel[k] - head - 4 * body;
    const int64_t units = head + body + tail;
    for (int64_t u = tid; u < units; u += stride) {
      const int64_t v = u - head;
      if (v >= 0 && v < body) {
        float4* p4 = reinterpret_cast<float4*>(p + head) + v;
        const float4 g4 = reinterpret_cast<const float4*>(g + head)[v];
        float4 a = *p4;
        a.x = sgd_one(a.x, g4.x, lr, two_l2, decay, &sq);
        a.y = sgd_one(a.y, g4.y, lr, two_l2, decay, &sq);
        a.z = sgd_one(a.z, g4.z, lr, two_l2, decay, &sq);
        a.w = sgd_one(a.w, g4.w, lr, two_l2, decay, &sq);
        *p4 = a;
      } else {
        const int64_t j = v < 0 ? u : head + 4 * body + (v - body);
        p[j] = sgd_one(p[j], g[j], lr, two_l2, decay, &sq);
      }
    }
  }
  if (loss == nullptr) return;  // the same for every thread of the grid
  __shared__ float scratch[kWarp];
  float s[1] = {sq};
  if (grid_sum(s, partial, counter, scratch) && threadIdx.x == 0) {
    *loss += l2 * s[0];
  }
}

Margins margins(const void* t0, const void* t1, const void* bias) {
  return Margins{static_cast<const float*>(t0),
                 static_cast<const float*>(t1),
                 static_cast<const float*>(bias)};
}

// The sharded launches' grid: blocks must be ceil(n / kGridRows), at least
// 1; partial holds 2 * blocks floats (logistic_sums) or blocks
// (logistic_grad), and counter is a device unsigned at 0 that no launch in
// flight shares.
bool bad_grid(int64_t n, int64_t blocks) {
  const int64_t want = n > 0 ? (n + kGridRows - 1) / kGridRows : 1;
  return blocks != want || blocks > 0x7fffffff;
}

}  // namespace

extern "C" {

// K8 on one part: loss (one float) = lsum / W, g[n] and gb (one float) =
// sum g, for margins t0[n] (+ t1[n], or null) (+ *bias, or null), label[n]
// and weight[n]. One block.
int dmlc_logistic_step(const void* t0, const void* t1, const void* bias,
                       const void* label, const void* weight, int64_t n,
                       void* loss, void* g, void* gb, void* stream) {
  logistic_step_kernel<<<1, kObjectiveThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      margins(t0, t1, bias), static_cast<const float*>(label),
      static_cast<const float*>(weight), n, static_cast<float*>(loss),
      static_cast<float*>(g), static_cast<float*>(gb));
  return static_cast<int>(cudaGetLastError());
}

// K8's first sharded launch: total[0] = lsum, total[1] = wsum of the n rows.
int dmlc_logistic_sums(const void* t0, const void* t1, const void* bias,
                       const void* label, const void* weight, int64_t n,
                       void* partial, void* counter, void* total,
                       int64_t blocks, void* stream) {
  if (bad_grid(n, blocks)) return static_cast<int>(cudaErrorInvalidValue);
  logistic_sums_kernel<<<static_cast<unsigned>(blocks), kGridThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      margins(t0, t1, bias), static_cast<const float*>(label),
      static_cast<const float*>(weight), n, static_cast<float*>(partial),
      static_cast<unsigned*>(counter), static_cast<float*>(total));
  return static_cast<int>(cudaGetLastError());
}

// K8's second sharded launch: loss, g[n] and gb as dmlc_logistic_step
// gives them, with (lsum, wsum) read from total[0], total[1] on the device.
int dmlc_logistic_grad(const void* t0, const void* t1, const void* bias,
                       const void* label, const void* weight, int64_t n,
                       const void* total, void* loss, void* g, void* partial,
                       void* counter, void* gb, int64_t blocks,
                       void* stream) {
  if (bad_grid(n, blocks)) return static_cast<int>(cudaErrorInvalidValue);
  logistic_grad_kernel<<<static_cast<unsigned>(blocks), kGridThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      margins(t0, t1, bias), static_cast<const float*>(label),
      static_cast<const float*>(weight), n,
      static_cast<const float*>(total), static_cast<float*>(loss),
      static_cast<float*>(g), static_cast<float*>(partial),
      static_cast<unsigned*>(counter), static_cast<float*>(gb));
  return static_cast<int>(cudaGetLastError());
}

// K9: params[k] -= lr * (grads[k] + 2 * l2 * params[k]) for k < count (the
// l2 term where decay[k] != 0), numel[k] floats each; params, grads,
// numel and decay are host arrays of count entries. Where loss is not null,
// *loss += l2 * sum of the old params[k]^2 over the decayed k; partial
// (blocks floats) and counter (a device unsigned at 0 that no launch in
// flight shares) are then its workspace. Returns cudaErrorInvalidValue
// for more than kSgdMaxParams parameters or a grid outside [1, 2^31).
int dmlc_sgd_update(const void* params, const void* grads, const void* numel,
                    const void* decay, int count, float lr, float l2,
                    void* partial, void* counter, void* loss, int64_t blocks,
                    void* stream) {
  if (count < 0 || count > kSgdMaxParams || blocks < 1 ||
      blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SgdTable t = {};
  t.count = count;
  for (int k = 0; k < count; ++k) {
    t.p[k] = static_cast<float* const*>(params)[k];
    t.g[k] = static_cast<const float* const*>(grads)[k];
    const int64_t n = static_cast<const int64_t*>(numel)[k];
    t.numel[k] = n;
    t.decay[k] = static_cast<const int*>(decay)[k];
    const uintptr_t pa = reinterpret_cast<uintptr_t>(t.p[k]);
    const uintptr_t ga = reinterpret_cast<uintptr_t>(t.g[k]);
    int64_t head = n;  // all scalar unless p and g align alike
    if (pa % 16 == ga % 16 && pa % 4 == 0) {
      head = static_cast<int64_t>((16 - pa % 16) % 16 / 4);
      if (head > n) head = n;
    }
    t.head[k] = head;
    t.body[k] = (n - head) / 4;
  }
  sgd_update_kernel<<<static_cast<unsigned>(blocks), kSgdThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      t, lr, l2, static_cast<float*>(partial),
      static_cast<unsigned*>(counter), static_cast<float*>(loss));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
