// K4 compact_gather: stable compaction of the matched candidates, and the
// columns of both join sides gathered at the surviving pairs.
//
// Replaces the JAX package's `compaction_indices` (utils/columnar.py:418-444),
// the deferred `pairs_table` gathers (ops/join.py:393-416) and
// `_zero_validity_past` (ops/join.py:140-146).
//
// Bound on the H100: random access. Each output row reads, at two random
// source rows, the value and the validity byte of every column of both
// sides (a 32-byte sector each); the matches' flags and ids are read once
// and the output columns written once. The design:
//   * the input columns themselves, no packed rows: a descriptor a column
//     (values, validity, width 1, 4 or 8 bytes, side, and the output's),
//     MAX_COLS of them by value in the kernel's parameters (K12's Spec,
//     csrc/pack_rows.cu), a wider pair of tables taking a launch a group;
//     a packed word matrix of each side, gathered and unpacked, made the
//     same random reads with a K12 pack of both inputs and an unpack of
//     the result around them;
//   * one pass by decoupled look-back (scan.cuh, as K5's compaction): a
//     block takes the next tile of CG_TILE candidate slots, ranks its
//     matches by a block scan, lists their offsets in shared memory in
//     slot order and takes its base from the tiles before it; every match
//     is written at its final row, neighbouring threads on neighbouring
//     rows, four matches a thread with their reads in flight together. So
//     the order is the candidates' (the JAX stable argsort's) and the
//     comparison with it is exact. The tiles cover the slots below
//     min(total, out_cap), read on the card: a block past them leaves at
//     once;
//   * a zero tail writes rows [n_match, out_cap) of every output column,
//     values 0 and validity False, a warp 128 rows in 16-byte stores.
// With the memset of the look-back's status words, three launches a group.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md): at Q9's call (3,147,082
// matches of 7 columns in 33,554,432 slots) 1.11 ms, the pass 0.56 and the
// tail (1.43 GB of zeros) 0.45, against 4.54 for K12's pack of both inputs,
// the packed K4 and K12's unpack; eight matches a thread measured level.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

using dfp::i64;

constexpr int CG_THREADS = 256;
constexpr int CG_ITEMS = 16;                     // candidate slots a thread ranks
constexpr int CG_TILE = CG_THREADS * CG_ITEMS;   // slots a block takes
constexpr int CG_BATCH = 4;                      // matches a thread gathers together
constexpr int MAX_COLS = 64;

inline i64 cg_tiles(i64 out_cap) { return (out_cap + CG_TILE - 1) / CG_TILE; }

// laid out as kernels/compact_gather.py's ColC and SpecC
struct Col {
  const void* src;
  const uint8_t* src_valid;
  void* out;
  uint8_t* out_valid;
  int width;  // bytes a value: 1 (bool), 4, 8
  int side;   // 0: rows by build_id, 1: by probe_idx
};

struct Spec {
  int n;
  Col c[MAX_COLS];
};

template <typename T>
__device__ __forceinline__ void gather_col(const Col& c, const i64 (&at)[CG_BATCH],
                                           const bool (&on)[CG_BATCH], i64 row0) {
  T v[CG_BATCH];
  uint8_t ok[CG_BATCH];
#pragma unroll
  for (int u = 0; u < CG_BATCH; ++u) {
    v[u] = on[u] ? __ldg((const T*)c.src + at[u]) : T(0);
    ok[u] = on[u] ? __ldg(c.src_valid + at[u]) : 0;
  }
#pragma unroll
  for (int u = 0; u < CG_BATCH; ++u) {
    if (!on[u]) continue;
    ((T*)c.out)[row0 + u * CG_THREADS] = v[u];
    c.out_valid[row0 + u * CG_THREADS] = ok[u];
  }
}

// spec is __grid_constant__: its descriptors are read in place, never
// copied to local memory
__global__ void __launch_bounds__(CG_THREADS) cg_pass_kernel(
    const __grid_constant__ Spec spec, const uint8_t* __restrict__ match,
    const int32_t* __restrict__ build_id, const int32_t* __restrict__ probe_idx,
    const int32_t* __restrict__ total, i64 out_cap,
    i64* __restrict__ n_match, uint64_t* status, i64 tiles) {
  constexpr int WORDS = CG_ITEMS / 4;
  __shared__ uint16_t src[CG_TILE];  // the matches' offsets in the tile, in order
  __shared__ i64 smem[33];
  __shared__ i64 prefix;
  __shared__ int tile_sh;
  const int tid = threadIdx.x;
  const i64 tile = dfp::lookback_tile(status, tiles, &tile_sh);
  const i64 first = tile * CG_TILE;
  i64 k = out_cap;  // the candidate slots
  if (total != nullptr) {
    const i64 t = *total;
    k = t < out_cap ? t : out_cap;
  }
  if (first >= k) {  // past the candidates
    if (tile == 0 && tid == 0) *n_match = 0;
    return;
  }
  const int rows = (int)(k - first < CG_TILE ? k - first : CG_TILE);
  const int r0 = tid * CG_ITEMS;  // this thread's slots of the tile
  uint32_t m[WORDS];
  if (rows == CG_TILE && ((uintptr_t)match & 15) == 0) {
#pragma unroll
    for (int q = 0; q < WORDS; q += 4) {
      const uint4 v = *(const uint4*)(match + first + r0 + 4 * q);
      m[q] = v.x, m[q + 1] = v.y, m[q + 2] = v.z, m[q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < WORDS; ++q) {
      m[q] = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = r0 + 4 * q + b;
        if (j < rows && match[first + j]) m[q] |= 1u << (8 * b);
      }
    }
  }
  // bool bytes are 0 or 1: a word's set bits are its matches
  int own = 0;
#pragma unroll
  for (int q = 0; q < WORDS; ++q) own += __popc(m[q]);
  i64 agg;
  int at = (int)dfp::block_exclusive_scan(own, smem, &agg);
  const i64 base = dfp::lookback_prefix(status, tile, agg, &prefix);
#pragma unroll
  for (int b = 0; b < CG_ITEMS; ++b)
    if ((m[b >> 2] >> (8 * (b & 3))) & 1u) src[at++] = (uint16_t)(r0 + b);
  if (first + CG_TILE >= k && tid == 0) *n_match = base + agg;
  __syncthreads();
  // match q of the tile -> output row base + q
  for (int q0 = 0; q0 < agg; q0 += CG_THREADS * CG_BATCH) {
    i64 b[CG_BATCH], p[CG_BATCH];
    bool on[CG_BATCH];
#pragma unroll
    for (int u = 0; u < CG_BATCH; ++u) {
      const int q = q0 + u * CG_THREADS + tid;
      on[u] = q < agg;
      const i64 s = first + (on[u] ? src[q] : 0);
      b[u] = on[u] ? __ldg(build_id + s) : 0;
      p[u] = on[u] ? __ldg(probe_idx + s) : 0;
    }
    const i64 row0 = base + q0 + tid;
    for (int c = 0; c < spec.n; ++c) {
      const Col& col = spec.c[c];
      i64 idx[CG_BATCH];
#pragma unroll
      for (int u = 0; u < CG_BATCH; ++u) idx[u] = col.side ? p[u] : b[u];
      if (col.width == 8) gather_col<long long>(col, idx, on, row0);
      else if (col.width == 4) gather_col<int32_t>(col, idx, on, row0);
      else gather_col<uint8_t>(col, idx, on, row0);
    }
  }
}

// Rows [*n_match, out_cap) of every output column become zeros: a warp
// takes 128 rows, in 16-byte stores where they lie past n_match and the
// buffers are aligned, a row at a time where not.
__global__ void cg_zero_tail_kernel(const __grid_constant__ Spec spec,
                                    const i64* __restrict__ n_match, i64 out_cap) {
  const int lane = threadIdx.x & 31;
  const i64 c0 = ((i64)blockIdx.x * blockDim.x + threadIdx.x) / 32 * 128;
  const i64 lo = *n_match < out_cap ? *n_match : out_cap;
  if (c0 >= out_cap || c0 + 128 <= lo) return;
  const bool whole = c0 >= lo && c0 + 128 <= out_cap;
  const uint4 z = make_uint4(0, 0, 0, 0);
  for (int k = 0; k < spec.n; ++k) {
    const Col& c = spec.c[k];
    const bool vec = whole && (((uintptr_t)c.out | (uintptr_t)c.out_valid) & 15) == 0;
    if (vec) {
      char* v = (char*)c.out + c0 * c.width;
      for (int off = 16 * lane; off < 128 * c.width; off += 512) *(uint4*)(v + off) = z;
      if (lane < 8) *(uint4*)(c.out_valid + c0 + 16 * lane) = z;
      continue;
    }
    for (i64 g = c0 + lane; g < c0 + 128 && g < out_cap; g += 32) {
      if (g < lo) continue;
      if (c.width == 8) ((long long*)c.out)[g] = 0;
      else if (c.width == 4) ((int32_t*)c.out)[g] = 0;
      else ((uint8_t*)c.out)[g] = 0;
      c.out_valid[g] = 0;
    }
  }
}

}  // namespace

extern "C" long long dfp_compact_gather_scratch_bytes(long long out_cap) {
  return dfp::lookback_scratch_bytes(cg_tiles(out_cap));
}

// match [out_cap] (with build_id, probe_idx [out_cap]) -> n_match (device
// int64) and, for every column of spec (a host struct laid out as Spec),
// out[j] = src[id[slot of the j-th match]] and out_valid likewise, where
// id is build_id or probe_idx by the column's side; rows past
// min(n_match, out_cap) are zeros. total (a device int32, or null): the
// candidate slots are those below min(total, out_cap); match past them
// is not read (it is False there by K3's contract).
extern "C" int dfp_compact_gather(const void* spec, const void* match, const void* build_id,
                                  const void* probe_idx, const void* total, long long out_cap,
                                  void* n_match64, void* scratch, long long scratch_bytes,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Spec* s = (const Spec*)spec;
  const i64 tiles = cg_tiles(out_cap);
  if (s->n < 0 || s->n > MAX_COLS || out_cap < 0 ||
      scratch_bytes < dfp::lookback_scratch_bytes(tiles))
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < s->n; ++k) {
    const int w = s->c[k].width;
    if ((w != 1 && w != 4 && w != 8) || (s->c[k].side != 0 && s->c[k].side != 1))
      return (int)cudaErrorInvalidValue;
  }
  if (tiles == 0) {
    cudaMemsetAsync(n_match64, 0, sizeof(i64), st);
    return (int)cudaGetLastError();
  }
  cudaMemsetAsync(scratch, 0, dfp::lookback_scratch_bytes(tiles), st);
  cg_pass_kernel<<<(unsigned)tiles, CG_THREADS, 0, st>>>(
      *s, (const uint8_t*)match, (const int32_t*)build_id, (const int32_t*)probe_idx,
      (const int32_t*)total, out_cap, (i64*)n_match64, (uint64_t*)scratch, tiles);
  if (s->n > 0)
    cg_zero_tail_kernel<<<dfp::grid_for(out_cap, 4 * 256), 256, 0, st>>>(
        *s, (const i64*)n_match64, out_cap);
  return (int)cudaGetLastError();
}
