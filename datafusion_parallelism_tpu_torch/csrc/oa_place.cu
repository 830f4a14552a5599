// K15 oa_place: the open-addressing table's slots from the build rows
// sorted by (invalid, home slot, hash).
//
// Replaces the JAX package's placement in `build_oa`
// (ops/hash_table.py:160-175): the parking-function displacement
// `disp = cummax(where(ok, home - i, -cap))`, `pos = i + disp`, and the two
// scatters into zeroed slot and perm arrays of S = T + T/4 entries.
//
// Bound on the H100: memory traffic, most of it the S-slot outputs (2.0 GB
// at S = 167,772,160). The sort puts the valid rows first, so sorted row i
// is valid exactly when i < n_valid, the count of `ok`: no `ok` gather. A
// row's home is slot_of(hash, T) (T = 4S/5; a mask for a power of two,
// else floor(hash * T / 2^32)), as both callers make it: computed from the
// hash, so each row gathers one random word, not two.
// Placement needs no sequential insertion: the i-th sorted row lands at
// i + the largest (home_j - j) over j <= i, a max-scan, and the valid
// rows' slots strictly increase with i. So a tile of sorted rows owns the
// slots from just past the row before it to its own last row, and writes
// each of them once, a row's entry or a zero:
//
//   count, grid-stride over `ok`: n_valid;
//   place, one launch: a block takes the next tile of PLACE_TILE sorted
//          rows below n_valid (PLACE_ITEMS consecutive rows a thread),
//          reads `order` coalesced and gathers each row's hash; the
//          displacement is a block max-scan of home - i, carried between
//          tiles by decoupled look-back as home - i + cap (>= 0; scan.cuh);
//          the slot before the tile's first row, (first - 1) + the prefix,
//          bounds its span; the span goes out in chunks of SPAN_CHUNK
//          slots staged in shared memory (zeros, then the rows in the
//          chunk), each chunk written coalesced; the tile of the last
//          valid row records the slot past it;
//   tail,  grid-stride: zeros from that slot to S (at least T/4 slots:
//          one block alone would hold the launch up).
//
// A valid row lands at slots[pos] = (hash << 32) | (o + 1), perm[pos] = o;
// every other entry is 0. A position past S (a home out of range, which
// the callers never pass) drops, as JAX's mode="drop".
//
// Measured on an H100 80GB HBM3 at 700 W (PERF.md): at Q7's shape
// (15,000,000 valid rows at capacity 2^25, S = 167,772,160) 3.56 ms for
// the memsets, a displacement pass, a three-launch max-scan and a scatter,
// about 1.4 here; the memsets kept with only the rows written by the pass
// 3.49, the home gathered 1.84.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"
#include "slot_of.cuh"

namespace {

using dfp::i64;

constexpr int PLACE_BLOCK = 256;
constexpr int PLACE_ITEMS = 8;
constexpr int PLACE_TILE = PLACE_BLOCK * PLACE_ITEMS;  // sorted rows a block takes
constexpr int SPAN_CHUNK = 2048;                       // slots a block stages at a time
constexpr int COUNT_BLOCK = 256;
constexpr int TAIL_BLOCK = 256;

inline i64 place_tiles(i64 cap) { return (cap + PLACE_TILE - 1) / PLACE_TILE; }

// scratch: the look-back's status words and counter, then n_valid and the
// tail's first slot (all zeroed by one memset)
inline i64 scratch_need(i64 cap) {
  return dfp::lookback_scratch_bytes(place_tiles(cap)) + 2 * (i64)sizeof(i64);
}

// *n_valid += the count of `ok` (bytes 0 or 1), 16 bytes a thread
__global__ void __launch_bounds__(COUNT_BLOCK) count_valid_kernel(const uint8_t* __restrict__ ok,
                                                                  i64 cap,
                                                                  unsigned long long* n_valid) {
  __shared__ unsigned warp_sums[COUNT_BLOCK / 32];
  unsigned c = 0;
  const bool aligned = ((uintptr_t)ok & 15) == 0;
  for (i64 i = ((i64)blockIdx.x * COUNT_BLOCK + threadIdx.x) * 16; i < cap;
       i += (i64)gridDim.x * COUNT_BLOCK * 16) {
    if (aligned && i + 16 <= cap) {
      const uint4 w = __ldg((const uint4*)(ok + i));
      c += __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
    } else {
      for (i64 j = i; j < i + 16 && j < cap; ++j) c += ok[j] != 0;
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) c += __shfl_xor_sync(0xffffffffu, c, d);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long s = 0;
    for (int w = 0; w < COUNT_BLOCK / 32; ++w) s += warp_sums[w];
    if (s) atomicAdd(n_valid, s);
  }
}

__global__ void __launch_bounds__(PLACE_BLOCK) place_kernel(
    const int32_t* __restrict__ order, const int32_t* __restrict__ hashes, i64 cap, i64 S,
    uint64_t T,
    const unsigned long long* __restrict__ n_valid, uint64_t* status, i64 tiles,
    i64* __restrict__ tail_at, unsigned long long* __restrict__ slots,
    int32_t* __restrict__ perm) {
  __shared__ __align__(16) unsigned long long sl[SPAN_CHUNK];
  __shared__ __align__(16) int32_t pm[SPAN_CHUNK];
  __shared__ i64 smem[33];
  __shared__ i64 prefix;
  __shared__ i64 span_end;
  __shared__ int tile_sh;
  const int tid = threadIdx.x;
  const i64 L = (i64)*n_valid;
  const i64 tile = dfp::lookback_tile(status, tiles, &tile_sh);
  const i64 f = tile * PLACE_TILE;
  if (f >= L) return;  // tiles are taken in order: no tile past this one waits on it
  const i64 r0 = f + (i64)tid * PLACE_ITEMS;
  int32_t o[PLACE_ITEMS], hs[PLACE_ITEMS];
  i64 inc[PLACE_ITEMS];
#pragma unroll
  for (int k = 0; k < PLACE_ITEMS; ++k) o[k] = r0 + k < L ? __ldg(order + r0 + k) : 0;
  // the running max of home - i + cap over the thread's rows (0: none yet)
  i64 run = 0;
#pragma unroll
  for (int k = 0; k < PLACE_ITEMS; ++k) {
    if (r0 + k < L) {
      hs[k] = __ldg(hashes + o[k]);
      const i64 v = dfp::slot_of((uint32_t)hs[k], T) - (r0 + k) + cap;
      run = v > run ? v : run;
    }
    inc[k] = run;
  }
  i64 tile_max;
  const i64 ex = dfp::block_exclusive_max(run, smem, &tile_max);
  const i64 excl = dfp::lookback_prefix<dfp::LookbackMax>(status, tile, tile_max, &prefix);
  const i64 before = ex > excl ? ex : excl;
  const i64 last = (f + PLACE_TILE < L ? f + PLACE_TILE : L) - 1;  // the tile's last row
  int32_t pos[PLACE_ITEMS];  // below S < 2^31 (past S: dropped)
  i64 mine_lo = S, mine_hi = -1;  // the slots of the thread's first and last valid rows
#pragma unroll
  for (int k = 0; k < PLACE_ITEMS; ++k) {
    const i64 p = r0 + k + ((inc[k] > before ? inc[k] : before) - cap);
    pos[k] = (int32_t)(p < S ? p : S);
    if (r0 + k < L) {
      mine_lo = k == 0 ? p : mine_lo;
      mine_hi = p;
    }
    if (r0 + k == last) {
      span_end = p < S ? p : S - 1;
      if (last == L - 1) *tail_at = p + 1 < S ? p + 1 : S;
    }
  }
  __syncthreads();
  // the slots past the row before the tile's first, up to its last row's
  const i64 a = f == 0 ? 0 : f + (excl - cap), e = span_end;
  ulonglong2* sl2 = reinterpret_cast<ulonglong2*>(sl);
  int4* pm4 = reinterpret_cast<int4*>(pm);
  for (i64 c0 = a & ~(i64)(SPAN_CHUNK - 1); c0 <= e; c0 += SPAN_CHUNK) {
    for (int j = tid; j < SPAN_CHUNK / 2; j += PLACE_BLOCK) sl2[j] = make_ulonglong2(0, 0);
    for (int j = tid; j < SPAN_CHUNK / 4; j += PLACE_BLOCK) pm4[j] = make_int4(0, 0, 0, 0);
    __syncthreads();
    if (mine_lo < c0 + SPAN_CHUNK && mine_hi >= c0) {
#pragma unroll
      for (int k = 0; k < PLACE_ITEMS; ++k) {
        if (r0 + k < L && pos[k] >= c0 && pos[k] < c0 + SPAN_CHUNK) {
          sl[pos[k] - c0] = ((unsigned long long)(uint32_t)hs[k] << 32) |
                            (unsigned long long)(uint32_t)(o[k] + 1);
          pm[pos[k] - c0] = o[k];
        }
      }
    }
    __syncthreads();
    // out in 16-byte stores (c0 is a multiple of SPAN_CHUNK), the span's
    // two ends a slot at a time
    for (int j = tid; j < SPAN_CHUNK / 2; j += PLACE_BLOCK) {
      const i64 s0 = c0 + 2 * j;
      if (s0 >= a && s0 + 1 <= e) {
        reinterpret_cast<ulonglong2*>(slots)[s0 >> 1] = sl2[j];
      } else {
        for (int q = 0; q < 2; ++q)
          if (s0 + q >= a && s0 + q <= e) slots[s0 + q] = sl[2 * j + q];
      }
    }
    for (int j = tid; j < SPAN_CHUNK / 4; j += PLACE_BLOCK) {
      const i64 s0 = c0 + 4 * j;
      if (s0 >= a && s0 + 3 <= e) {
        reinterpret_cast<int4*>(perm)[s0 >> 2] = pm4[j];
      } else {
        for (int q = 0; q < 4; ++q)
          if (s0 + q >= a && s0 + q <= e) perm[s0 + q] = pm[4 * j + q];
      }
    }
    __syncthreads();
  }
}

// zeros from *tail_at to S: slots in 16-byte stores from the first even
// slot, perm from the first multiple of 4, the slots before them one at a
// time
__global__ void __launch_bounds__(TAIL_BLOCK) zero_tail_kernel(
    const i64* __restrict__ tail_at, i64 S, unsigned long long* __restrict__ slots,
    int32_t* __restrict__ perm) {
  const i64 t0 = *tail_at;
  const i64 gid = (i64)blockIdx.x * TAIL_BLOCK + threadIdx.x, step = (i64)gridDim.x * TAIL_BLOCK;
  const i64 s2 = (t0 + 1) >> 1, s4 = (t0 + 3) >> 2;  // the first pair and quad wholly past t0
  if (gid < 4) {
    if (t0 + gid < 2 * s2 && t0 + gid < S) slots[t0 + gid] = 0;
    if (t0 + gid < 4 * s4 && t0 + gid < S) perm[t0 + gid] = 0;
  }
  for (i64 p = s2 + gid; 2 * p < S; p += step) {
    if (2 * p + 1 < S) reinterpret_cast<ulonglong2*>(slots)[p] = make_ulonglong2(0, 0);
    else slots[2 * p] = 0;
  }
  for (i64 p = s4 + gid; 4 * p < S; p += step) {
    if (4 * p + 3 < S) {
      reinterpret_cast<int4*>(perm)[p] = make_int4(0, 0, 0, 0);
    } else {
      for (i64 q = 4 * p; q < S; ++q) perm[q] = 0;
    }
  }
}

}  // namespace

// The launch plan this file was built with, which kernels/oa_place.py
// copies for its scratch sizes and its host replay: entry i of
// (PLACE_ITEMS, PLACE_TILE, SPAN_CHUNK), -1 past them; and the scratch
// bytes of a launch.
extern "C" long long dfp_oa_place_plan(int i) {
  const long long plan[] = {PLACE_ITEMS, PLACE_TILE, SPAN_CHUNK};
  return i >= 0 && i < (int)(sizeof(plan) / sizeof(plan[0])) ? plan[i] : -1;
}

extern "C" long long dfp_oa_place_scratch_bytes(long long cap) { return scratch_need(cap); }

// order int32[cap] (the stable sort by (invalid, home, hash): the valid
// rows first), hashes int32[cap], ok bool[cap] in row order; S = T + T/4
// slots: slots int64[S], perm int32[S] are written whole; sms: the
// device's SM count.
extern "C" int dfp_oa_place(const void* order, const void* hashes, const void* ok,
                            long long cap, long long S, long long T, void* slots, void* perm,
                            void* scratch, long long scratch_bytes, int sms, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (scratch_bytes < scratch_need(cap) || T < 1 || S != T + T / 4 || sms < 1)
    return (int)cudaErrorInvalidValue;
  const i64 tiles = place_tiles(cap);
  uint64_t* status = (uint64_t*)scratch;
  unsigned long long* n_valid =
      (unsigned long long*)((char*)scratch + dfp::lookback_scratch_bytes(tiles));
  i64* tail_at = (i64*)(n_valid + 1);
  cudaMemsetAsync(scratch, 0, (size_t)scratch_need(cap), st);
  if (cap > 0) {
    const i64 count_blocks = (cap + COUNT_BLOCK * 16 - 1) / (COUNT_BLOCK * 16);
    count_valid_kernel<<<(unsigned)(count_blocks < 8 * sms ? count_blocks : 8 * sms),
                         COUNT_BLOCK, 0, st>>>((const uint8_t*)ok, cap, n_valid);
    place_kernel<<<(unsigned)tiles, PLACE_BLOCK, 0, st>>>(
        (const int32_t*)order, (const int32_t*)hashes, cap, S, (uint64_t)T, n_valid,
        status, tiles, tail_at, (unsigned long long*)slots, (int32_t*)perm);
  }
  zero_tail_kernel<<<(unsigned)(8 * sms), TAIL_BLOCK, 0, st>>>(tail_at, S,
                                                              (unsigned long long*)slots,
                                                              (int32_t*)perm);
  return (int)cudaGetLastError();
}
