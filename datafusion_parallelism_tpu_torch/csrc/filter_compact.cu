// K5 filter_compact: stable stream compaction of packed rows, and the plain
// row gather.
//
// Replaces the JAX package's `compaction_indices` (utils/columnar.py:418:
// a stable argsort of ~mask), `compact_rows` (:594), `filter_rows` (:447),
// `take_rows_fused` (:549), `PackedTable.take_rows` (:491) and
// `gather_table` (:406).
//
// Compaction is bound by memory traffic: the mask read once, each
// survivor's words read and written once, the zero tail [n, out_cap)
// written once (Q19 at SF10: 67,108,864 mask bytes, 2,144,860 survivors of
// 10 words, a 16,777,216-row tail: 0.246 ms at 3.35 TB/s, most of it the
// tail's zeros). One pass by decoupled look-back (scan.cuh, as K2's
// partition): a block takes the next tile of 4,096 rows from the counter,
// loads its 4,096 mask bytes 16 to a thread (one 16-byte load where
// aligned), ranks the tile's survivors by a block scan and lists their
// offsets in shared memory in row order; the tile's base is the survivors
// of the tiles before it (lookback_prefix). Then every word row and
// sidecar of the tile's survivors is read from the tile's window of the
// source and written as one contiguous run at the base, neighbouring
// threads on neighbouring output rows: no rank array touches device
// memory, and the order is the JAX stable argsort's, so the comparison
// with it is exact. The last tile's inclusive prefix is the true count n;
// survivors past out_cap drop. A second launch writes the zero tail, four
// rows a thread in 16-byte stores (the JAX package zeroes only its
// validity words). With the memset of the look-back's status words, three
// launches. Measured on an H100 80GB HBM3 at 700 W (PERF.md): 0.72 ms at
// Q19, the pass 0.48 ms, bound by its survivors' reads, a 32-byte sector
// each a word row at 3% density (~0.69 GB, which the bound does not
// count), the tail 0.18 ms at 3.3 TB/s.

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

constexpr int FC_THREADS = 256;
constexpr int FC_ITEMS = 16;                        // mask bytes a thread ranks
constexpr int FC_TILE = FC_THREADS * FC_ITEMS;      // rows a compaction block takes
constexpr int GATHER_BATCH = 4;     // a survivor's words read before any is written

inline i64 compact_tiles(i64 cap) { return (cap + FC_TILE - 1) / FC_TILE; }

// The tiles of FC_TILE rows in look-back order: survivor j of a tile (its base the survivors of the tiles before it) goes to output row
// base + j, every word row and sidecar, while that row is below out_cap;
// the last tile writes the survivor count to *n.
__global__ void __launch_bounds__(FC_THREADS) compact_kernel(
    const uint8_t* __restrict__ mask, i64 cap, i64 out_cap, const int32_t* __restrict__ words,
    int W, const i64* __restrict__ f64, int F, int32_t* __restrict__ out,
    i64* __restrict__ out_f64, i64* __restrict__ n, uint64_t* status, i64 tiles) {
  constexpr int ITEMS = FC_ITEMS, TILE = FC_TILE, WORDS = ITEMS / 4, BATCH = GATHER_BATCH;
  __shared__ uint16_t src[TILE];  // the survivors' offsets in the tile, in order
  __shared__ i64 smem[33];
  __shared__ i64 prefix;
  __shared__ int tile_sh;
  const int tid = threadIdx.x;
  const i64 tile = dfp::lookback_tile(status, tiles, &tile_sh);
  const i64 first = tile * TILE;
  const int rows = (int)(cap - first < TILE ? cap - first : TILE);
  const int r0 = tid * ITEMS;  // this thread's rows of the tile
  uint32_t m[WORDS];
  if (rows == TILE && ((uintptr_t)mask & 15) == 0) {
#pragma unroll
    for (int q = 0; q < WORDS; q += 4) {
      const uint4 v = *(const uint4*)(mask + first + r0 + 4 * q);
      m[q] = v.x, m[q + 1] = v.y, m[q + 2] = v.z, m[q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < WORDS; ++q) {
      m[q] = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = r0 + 4 * q + b;
        if (j < rows && mask[first + j]) m[q] |= 1u << (8 * b);
      }
    }
  }
  // bool bytes are 0 or 1: a word's set bits are its survivors
  int own = 0;
#pragma unroll
  for (int q = 0; q < WORDS; ++q) own += __popc(m[q]);
  i64 agg;
  int at = (int)dfp::block_exclusive_scan(own, smem, &agg);
  const i64 base = dfp::lookback_prefix(status, tile, agg, &prefix);
#pragma unroll
  for (int b = 0; b < ITEMS; ++b)
    if ((m[b >> 2] >> (8 * (b & 3))) & 1u) src[at++] = (uint16_t)(r0 + b);
  if (tile == tiles - 1 && tid == 0) *n = base + agg;
  __syncthreads();
  const i64 k = out_cap - base < agg ? out_cap - base : agg;  // survivors kept
  for (i64 j = tid; j < k; j += FC_THREADS) {
    const i64 s = first + src[j], d = base + j;
    // up to BATCH words read before any is written
    for (int w0 = 0; w0 < W; w0 += BATCH) {
      int32_t v[BATCH];
#pragma unroll
      for (int q = 0; q < BATCH; ++q)
        if (w0 + q < W) v[q] = words[(w0 + q) * cap + s];
#pragma unroll
      for (int q = 0; q < BATCH; ++q)
        if (w0 + q < W) out[(w0 + q) * out_cap + d] = v[q];
    }
    for (int f0 = 0; f0 < F; f0 += BATCH) {
      i64 v[BATCH];
#pragma unroll
      for (int q = 0; q < BATCH; ++q)
        if (f0 + q < F) v[q] = f64[(f0 + q) * cap + s];
#pragma unroll
      for (int q = 0; q < BATCH; ++q)
        if (f0 + q < F) out_f64[(f0 + q) * out_cap + d] = v[q];
    }
  }
}

// Output rows [*n, m) become zeros: a thread takes four rows of every word
// row and sidecar, 16-byte stores where the rows are aligned (m a multiple
// of 4), element by element where not.
__global__ void zero_tail_kernel(const i64* __restrict__ n, i64 m, int W, int F,
                                 int32_t* __restrict__ out, i64* __restrict__ out_f64) {
  const i64 e0 = 4 * ((i64)blockIdx.x * blockDim.x + threadIdx.x);
  const i64 lo = *n;
  if (e0 >= m || e0 + 4 <= lo) return;
  const bool vec = e0 >= lo && e0 + 4 <= m && (m & 3) == 0 && ((uintptr_t)out & 15) == 0 &&
                   ((uintptr_t)out_f64 & 15) == 0;
  const i64 a = e0 < lo ? lo : e0, b = e0 + 4 < m ? e0 + 4 : m;
  for (int w = 0; w < W; ++w) {
    if (vec) {
      *(uint4*)(out + w * m + e0) = make_uint4(0, 0, 0, 0);
    } else {
      for (i64 e = a; e < b; ++e) out[w * m + e] = 0;
    }
  }
  for (int f = 0; f < F; ++f) {
    if (vec) {
      *(uint4*)(out_f64 + f * m + e0) = make_uint4(0, 0, 0, 0);
      *(uint4*)(out_f64 + f * m + e0 + 2) = make_uint4(0, 0, 0, 0);
    } else {
      for (i64 e = a; e < b; ++e) out_f64[f * m + e] = 0;
    }
  }
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

}  // namespace

extern "C" long long dfp_filter_compact_scratch_bytes(long long cap, long long out_cap) {
  (void)out_cap;
  return dfp::lookback_scratch_bytes(compact_tiles(cap));
}

// mask [cap] -> n (device int64, the true survivor count) and, for
// j < out_cap, out[:, j] = words[:, j-th survivor] (+ the float64 sidecars
// moved as 64-bit words), zeros at j >= n.
extern "C" int dfp_filter_compact(const void* mask, long long cap, const void* words, int W,
                                  const void* f64, int F, long long out_cap, void* out,
                                  void* out_f64, void* n, void* scratch,
                                  long long scratch_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const i64 tiles = compact_tiles(cap);
  if (scratch_bytes < dfp::lookback_scratch_bytes(tiles)) return (int)cudaErrorInvalidValue;
  if (tiles == 0) {
    cudaMemsetAsync(n, 0, sizeof(i64), st);
  } else {
    cudaMemsetAsync(scratch, 0, dfp::lookback_scratch_bytes(tiles), st);
    compact_kernel<<<(unsigned)tiles, FC_THREADS, 0, st>>>(
        (const uint8_t*)mask, cap, out_cap, (const int32_t*)words, W, (const i64*)f64, F,
        (int32_t*)out, (i64*)out_f64, (i64*)n, (uint64_t*)scratch, tiles);
  }
  if (out_cap > 0 && W + F > 0) {
    zero_tail_kernel<<<dfp::grid_for(out_cap, 4 * 256), 256, 0, st>>>(
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
