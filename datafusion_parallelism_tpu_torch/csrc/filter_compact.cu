// K5 filter_compact: stable stream compaction of packed rows, and the plain
// row gather.
//
// Replaces the JAX package's `compaction_indices` (utils/columnar.py:418:
// a stable argsort of ~mask), `compact_rows` (:594), `filter_rows` (:447),
// `take_rows_fused` (:549), `PackedTable.take_rows` (:491) and
// `gather_table` (:406).
//
// Bound on the H100: memory traffic. Compaction reads the mask twice (the
// scan of scan.cuh) and every word of the input once, and writes every
// word of the survivors once. It is a flag scan, then each survivor is
// written at its rank, which is the order of the JAX stable argsort, so the
// comparison with it can be exact. One thread per source row: the reads of
// a warp are one coalesced line per word row, and the survivors of a warp
// have consecutive ranks, so neighbouring threads write neighbouring output
// rows of one word. Survivors past out_cap are dropped and the returned
// count stays the true one; output rows at or past the count are zeros
// (the JAX package zeroes only their validity words).
//
// The gather (row j = source row idx[j]) is bound by random reads. One
// thread per output row and word (or float64 sidecar), the blocks of one
// word together, so each thread makes one random read, many are in flight,
// and every write is coalesced; idx is read once per word. The wrapper
// picks the rows a thread takes from the source's size (`gather_layout`,
// against the L2 size the device reports):
// - WORD, one row, while a word row of the source fits in L2: the random
//   reads of a word row hit there (at the 13-word sort of 4 M rows, 16 MB
//   a word row: 0.69 ms this way, 1.89 ms with one thread a row looping
//   over its words, 1.87 ms with the words of a row range in consecutive
//   blocks);
// - WORD4, four rows 256 apart, past that: no order keeps a word row in
//   L2, so each read costs an HBM sector, and a quarter of the blocks
//   with four reads in flight a thread win where part of the rows are
//   zeros or in order (Q20's grouping: 2.03 ms against 2.25, its 67 M rows
//   of 5 words, 13.7% read; one thread a row reading its words back to
//   back, 1.95 there, lost by 8-40% on every full permutation; PERF.md).
// With a count n, rows at or past n are zeros and read nothing (not even
// idx): a caller that reads only a valid prefix passes it.

// The float64 sidecars move as 8-byte integers, a bit copy with no
// arithmetic and no canonicalisation: callers rely on it (the SORT build
// carries its int64 keys, all denormal doubles, through this path as a
// sidecar; ops/hash_table.py `sort_table_rows`), and so must any change.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

using dfp::i64;

__global__ void survivor_scatter_kernel(const uint8_t* __restrict__ mask,
                                        const int32_t* __restrict__ rank, i64 cap, i64 out_cap,
                                        const int32_t* __restrict__ words, int W,
                                        const i64* __restrict__ f64, int F,
                                        int32_t* __restrict__ out, i64* __restrict__ out_f64) {
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap || !mask[i]) return;
  const i64 r = rank[i];
  if (r >= out_cap) return;
  for (int w = 0; w < W; ++w) out[w * out_cap + r] = words[w * cap + i];
  for (int f = 0; f < F; ++f) out_f64[f * out_cap + r] = f64[f * cap + i];
}

// rows j in [*n, m) become zeros (n == nullptr: none)
__global__ void zero_tail_kernel(const i64* __restrict__ n, i64 m, int W, int F,
                                 int32_t* __restrict__ out, i64* __restrict__ out_f64) {
  const i64 j = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m || j < *n) return;
  for (int w = 0; w < W; ++w) out[w * m + j] = 0;
  for (int f = 0; f < F; ++f) out_f64[f * m + j] = 0;
}

// WORD: one thread per (output row, word): blockIdx.y picks the word, W
// of them and then the F sidecars.
__global__ void row_gather_kernel(const int32_t* __restrict__ words, int W,
                                  const i64* __restrict__ f64, i64 cap,
                                  const int32_t* __restrict__ idx, i64 m,
                                  const i64* __restrict__ n, int32_t* __restrict__ out,
                                  i64* __restrict__ out_f64) {
  const i64 j = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const int w = blockIdx.y;
  const bool zero = cap == 0 || (n != nullptr && j >= *n);
  i64 s = zero ? 0 : idx[j];
  s = s < 0 ? 0 : (s >= cap ? cap - 1 : s);  // mode="clip"
  if (w < W) {
    out[w * m + j] = zero ? 0 : words[w * cap + s];
  } else {
    const i64 f = w - W;
    out_f64[f * m + j] = zero ? 0 : f64[f * cap + s];
  }
}

// WORD4: WORD with four output rows a thread (256 apart), their idx and
// word reads issued together.
__global__ void row_gather_word4_kernel(const int32_t* __restrict__ words, int W,
                                        const i64* __restrict__ f64, i64 cap,
                                        const int32_t* __restrict__ idx, i64 m,
                                        const i64* __restrict__ n, int32_t* __restrict__ out,
                                        i64* __restrict__ out_f64) {
  const i64 j0 = (i64)blockIdx.x * 1024 + threadIdx.x;
  const int w = blockIdx.y;
  const i64 count = n != nullptr ? *n : m;
  i64 s[4];
  bool read[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const i64 j = j0 + 256 * u;
    read[u] = cap > 0 && j < m && j < count;
    s[u] = read[u] ? idx[j] : 0;
    s[u] = s[u] < 0 ? 0 : (s[u] >= cap ? cap - 1 : s[u]);  // mode="clip"
  }
  if (w < W) {
    int32_t v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = read[u] ? words[w * cap + s[u]] : 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) if (j0 + 256 * u < m) out[w * m + j0 + 256 * u] = v[u];
  } else {
    const i64 f = w - W;
    i64 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = read[u] ? f64[f * cap + s[u]] : 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) if (j0 + 256 * u < m) out_f64[f * m + j0 + 256 * u] = v[u];
  }
}

i64 align256(i64 b) { return (b + 255) / 256 * 256; }

}  // namespace

extern "C" long long dfp_filter_compact_scratch_bytes(long long cap, long long out_cap) {
  (void)out_cap;
  return align256(cap * 4) + dfp::scan_scratch_bytes(cap);
}

// mask [cap] -> n (device int64, the true survivor count) and, for
// j < out_cap, out[:, j] = words[:, j-th survivor] (+ the float64 sidecars
// moved as 64-bit words), zeros at j >= n.
extern "C" int dfp_filter_compact(const void* mask, long long cap, const void* words, int W,
                                  const void* f64, int F, long long out_cap, void* out,
                                  void* out_f64, void* n, void* scratch,
                                  long long scratch_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (scratch_bytes < dfp_filter_compact_scratch_bytes(cap, out_cap)) return (int)cudaErrorInvalidValue;
  int32_t* rank = (int32_t*)scratch;
  void* scan = (char*)scratch + align256(cap * 4);
  dfp::exclusive_scan<uint8_t, int32_t>((const uint8_t*)mask, cap, rank, (i64*)n, scan, st);
  if (cap > 0) {
    survivor_scatter_kernel<<<dfp::grid_for(cap, 256), 256, 0, st>>>(
        (const uint8_t*)mask, rank, cap, out_cap, (const int32_t*)words, W, (const i64*)f64, F,
        (int32_t*)out, (i64*)out_f64);
  }
  if (out_cap > 0) {
    zero_tail_kernel<<<dfp::grid_for(out_cap, 256), 256, 0, st>>>(
        (const i64*)n, out_cap, W, F, (int32_t*)out, (i64*)out_f64);
  }
  return (int)cudaGetLastError();
}

// out[:, j] = words[:, clip(idx[j])] for j < m (+ sidecars); with n
// (device int64, may be nullptr), rows j >= *n are zeros. layout: 0 WORD,
// 1 WORD4 (the header says when each is taken).
extern "C" int dfp_row_gather(const void* words, int W, const void* f64, int F, long long cap,
                              const void* idx, long long m, const void* n, void* out,
                              void* out_f64, int layout, void* stream) {
  if (layout != 0 && layout != 1) return (int)cudaErrorInvalidValue;
  if (W + F > 65535) return (int)cudaErrorInvalidValue;  // the grid's y limit
  if (m > 0 && W + F > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    if (layout == 0) {
      row_gather_kernel<<<dim3(dfp::grid_for(m, 256), (unsigned)(W + F)), 256, 0, st>>>(
          (const int32_t*)words, W, (const i64*)f64, cap, (const int32_t*)idx, m, (const i64*)n,
          (int32_t*)out, (i64*)out_f64);
    } else {
      row_gather_word4_kernel<<<dim3(dfp::grid_for(m, 1024), (unsigned)(W + F)), 256, 0, st>>>(
          (const int32_t*)words, W, (const i64*)f64, cap, (const int32_t*)idx, m, (const i64*)n,
          (int32_t*)out, (i64*)out_f64);
    }
  }
  return (int)cudaGetLastError();
}
