// The index rule of every kernel that gathers or scatters by a raw index,
// in one place (its torch twin: dmlc_tpu_torch/ops/index.py).
//
// The reference reads an index the way JAX does without x64: a u64 index
// is cut to its low 32 bits when it becomes a device array, every gather
// casts it with astype(int32), and jnp.take / .at[] count a negative index
// from the end. So a raw index (u32, u64 or int32) maps to
//   1. its low 32 bits, as a signed int32 j;
//   2. j + n where j < 0;
//   3. valid where 0 <= j < n. A forward reads NaN for an invalid index
//      (jnp.take fills NaN) and a backward or a scatter drops it.
// u32 2^32-1 reads the last entry, u32 2^31 is invalid, u64 2^32+3 reads
// entry 3. A field id (FFM) takes the same low 32 bits, signed, and is then
// clipped into [0, nf - 1] (jnp.clip), so a field of 2^31 reads field 0.

#pragma once

#include <stdint.h>

namespace dmlc_index {

// Sets *j to the entry of a table of n that `raw` reads; returns whether
// it is valid. Branch-free: a sign extension, a select and one unsigned
// compare (a wrapped index still negative is past any table). Forms that
// branch on the table's size or on the index were slower on the card.
template <typename IndexT>
__device__ __forceinline__ bool wrap(IndexT raw, int64_t n, int64_t* j) {
  const int64_t v = static_cast<int32_t>(static_cast<uint32_t>(raw));
  const int64_t w = v < 0 ? v + n : v;
  *j = w;
  return static_cast<uint64_t>(w) < static_cast<uint64_t>(n);
}

// wrap for a table of n < 2^31 entries, in 32-bit arithmetic: the same
// entry and validity (j + n cannot overflow where j < 0 and n < 2^31).
template <typename IndexT>
__device__ __forceinline__ bool wrap32(IndexT raw, int n, int* j) {
  const int v = static_cast<int>(static_cast<uint32_t>(raw));
  const int w = v < 0 ? v + n : v;
  *j = w;
  return static_cast<unsigned>(w) < static_cast<unsigned>(n);
}

// The field a raw (int64) field id selects among nf fields.
__device__ __forceinline__ int64_t clip_field(int64_t raw, int64_t nf) {
  const int64_t a = static_cast<int32_t>(static_cast<uint32_t>(raw));
  return a < 0 ? 0 : (a >= nf ? nf - 1 : a);
}

}  // namespace dmlc_index
