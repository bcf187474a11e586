// The page tier's round unpack: one round of a spill file, as its raw bytes
// on the card, into the padded [L, ...] batch, hand-written for Hopper
// (sm_90a), with a plain C interface bound by ctypes from
// dmlc_tpu_torch/ops/pages.py.
//
// What it replaces. No TPU kernel: the reference pads a replayed round on
// the host (dmlc_tpu/data/padding.py stack_padded_rows, after
// RoundSpillFile.iter_rows has decoded every array of the round). Here the
// host reads the round's bytes once into a pinned slot, one copy takes
// them to the card, and this kernel writes every key of the batch
// (data/padding.py stack_spec) from them:
//   offset [L, rb+1] int64   the block's offsets, the tail set to nnz;
//   label, weight [L, rb]    f32 (weight 1 where absent), 0 in the tail;
//   index [L, nb]            u32 or u64 (the width the caller asks for:
//                            the round's first block's), 0 in the tail;
//   value [L, nb]            f32 (1 where absent), 0 in the tail;
//   qid [L, rb], field [L, nb] int64 where asked for: -1 and 0 where
//                            absent and in the tail;
//   num_rows, num_nnz [L]    int32.
// The output is stack_padded_rows's, byte for byte: floats are copied as
// their bits, and an index of another width converts as numpy's assignment
// does (a u64 keeps its low 32 bits in a u32, a u32 widens with zeros).
//
// The round table (data/row_iter.py ROUND_TABLE_COLUMNS), one row of
// int64 a part, gives each part's n, nnz, source index width and the byte
// position of each array's data in the round (-1: absent). The headers
// before each array hold a dtype string of variable length, so the
// arrays sit at arbitrary byte offsets: an element is read with one load
// where its address is aligned to its size, else byte by byte (never a
// wide load that could trap on a misaligned address). The alignment is
// the same for every element of an array, so the branch is uniform.
//
// Bound on the card (H100 SXM, 3.35 TB/s): a copy. It reads each array
// once and writes each output element once; at the spill path's round (4
// parts of 8192 rows, nnz_bucket 368640) that is about 8.7 MB read and
// 12.3 MB written, 6.3 us at the card's memory rate. Design: a grid of
// (blocks, parts); a thread a position of the part, striding over
// max(rb + 1, nb) positions; the part's table row in shared memory;
// consecutive threads read and write consecutive elements. It launches on
// the caller's stream, allocates nothing and returns cudaGetLastError().
//
// Two entries. dmlc_round_unpack launches the kernel on bytes already on
// the card. dmlc_round_stage is a page epoch's whole round in one call
// from the host: it enqueues the copy of the round's bytes from a pinned
// host slot into the card's byte buffer, then the kernel, on one stream,
// so the serve thread pays one call's worth of Python a round.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
// the columns of a round-table row (data/row_iter.py ROUND_TABLE_COLUMNS)
enum Column {
  kBlock, kFlags, kRows, kNnz, kIndexBytes, kOffset, kLabel, kIndex, kValue,
  kWeight, kQid, kField, kColumns
};
constexpr uint32_t kOneBits = 0x3f800000u;  // 1.0f

// The T at byte address p, which may sit at any byte.
template <typename T>
__device__ __forceinline__ T load(const uint8_t* p) {
  T v;
  if ((reinterpret_cast<uintptr_t>(p) & (sizeof(T) - 1)) == 0) {
    v = *reinterpret_cast<const T*>(p);
  } else {
    uint8_t b[sizeof(T)];
#pragma unroll
    for (int k = 0; k < static_cast<int>(sizeof(T)); ++k) b[k] = p[k];
    memcpy(&v, b, sizeof(T));
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
    round_unpack_kernel(const uint8_t* __restrict__ raw,
                        const int64_t* __restrict__ table, int64_t rb,
                        int64_t nb, int out_index_bytes,
                        int64_t* __restrict__ offset,
                        uint32_t* __restrict__ label,
                        uint32_t* __restrict__ weight,
                        uint8_t* __restrict__ index,
                        uint32_t* __restrict__ value,
                        int64_t* __restrict__ qid,
                        int64_t* __restrict__ field,
                        int32_t* __restrict__ num_rows,
                        int32_t* __restrict__ num_nnz) {
  __shared__ int64_t t[kColumns];
  const int64_t part = blockIdx.y;
  if (threadIdx.x < kColumns) t[threadIdx.x] = table[part * kColumns +
                                                     threadIdx.x];
  __syncthreads();
  const int64_t n = t[kRows], nnz = t[kNnz];
  const bool wide_src = t[kIndexBytes] == 8;
  offset += part * (rb + 1);
  label += part * rb;
  weight += part * rb;
  index += part * nb * out_index_bytes;
  value += part * nb;
  if (qid != nullptr) qid += part * rb;
  if (field != nullptr) field += part * nb;
  const int64_t span = rb + 1 > nb ? rb + 1 : nb;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       p < span; p += stride) {
    if (p <= rb) {
      offset[p] = p <= n ? load<int64_t>(raw + t[kOffset] + 8 * p) : nnz;
    }
    if (p < rb) {
      const bool row = p < n;
      label[p] = row ? load<uint32_t>(raw + t[kLabel] + 4 * p) : 0u;
      weight[p] = !row ? 0u
                  : t[kWeight] >= 0 ? load<uint32_t>(raw + t[kWeight] + 4 * p)
                                    : kOneBits;
      if (qid != nullptr) {
        qid[p] = row && t[kQid] >= 0 ? load<int64_t>(raw + t[kQid] + 8 * p)
                                     : -1;
      }
    }
    if (p < nb) {
      const bool nz = p < nnz;
      uint64_t ix = 0;
      if (nz) {
        ix = wide_src ? load<uint64_t>(raw + t[kIndex] + 8 * p)
                      : load<uint32_t>(raw + t[kIndex] + 4 * p);
      }
      if (out_index_bytes == 8) {
        reinterpret_cast<uint64_t*>(index)[p] = ix;
      } else {
        reinterpret_cast<uint32_t*>(index)[p] = static_cast<uint32_t>(ix);
      }
      value[p] = !nz ? 0u
                 : t[kValue] >= 0 ? load<uint32_t>(raw + t[kValue] + 4 * p)
                                  : kOneBits;
      if (field != nullptr) {
        field[p] = nz && t[kField] >= 0
                       ? load<int64_t>(raw + t[kField] + 8 * p)
                       : 0;
      }
    }
    if (p == 0) {
      num_rows[part] = static_cast<int32_t>(n);
      num_nnz[part] = static_cast<int32_t>(nnz);
    }
  }
}

}  // namespace

extern "C" {

// raw: the round's bytes on the card; table: its parts' rows [parts,
// kColumns]; qid and field may be null (not asked for). The caller has
// checked every part's n <= row_bucket and nnz <= nnz_bucket. Returns a
// cudaError_t.
int dmlc_round_unpack(const void* raw, const void* table, int64_t parts,
                      int64_t row_bucket, int64_t nnz_bucket,
                      int out_index_bytes, void* offset, void* label,
                      void* weight, void* index, void* value, void* qid,
                      void* field, void* num_rows, void* num_nnz,
                      void* stream) {
  if (parts <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t span =
      row_bucket + 1 > nnz_bucket ? row_bucket + 1 : nnz_bucket;
  int64_t blocks = (span + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(parts));
  round_unpack_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(raw), static_cast<const int64_t*>(table),
      row_bucket, nnz_bucket, out_index_bytes, static_cast<int64_t*>(offset),
      static_cast<uint32_t*>(label), static_cast<uint32_t*>(weight),
      static_cast<uint8_t*>(index), static_cast<uint32_t*>(value),
      static_cast<int64_t*>(qid), static_cast<int64_t*>(field),
      static_cast<int32_t*>(num_rows), static_cast<int32_t*>(num_nnz));
  return static_cast<int>(cudaGetLastError());
}

// host: the round's nbytes in a pinned host slot; dev_raw: a card buffer
// of at least nbytes; the rest as dmlc_round_unpack. Enqueues the copy
// host -> dev_raw and then the kernel on stream; returns a cudaError_t.
int dmlc_round_stage(const void* host, void* dev_raw, int64_t nbytes,
                     const void* table, int64_t parts, int64_t row_bucket,
                     int64_t nnz_bucket, int out_index_bytes, void* offset,
                     void* label, void* weight, void* index, void* value,
                     void* qid, void* field, void* num_rows, void* num_nnz,
                     void* stream) {
  if (nbytes > 0) {
    const cudaError_t err =
        cudaMemcpyAsync(dev_raw, host, static_cast<size_t>(nbytes),
                        cudaMemcpyHostToDevice,
                        static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return dmlc_round_unpack(dev_raw, table, parts, row_bucket, nnz_bucket,
                           out_index_bytes, offset, label, weight, index,
                           value, qid, field, num_rows, num_nnz, stream);
}

}  // extern "C"
