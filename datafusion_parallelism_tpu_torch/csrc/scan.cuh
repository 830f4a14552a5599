// Device-wide prefix sums by decoupled look-back, and the block-wide scans
// they are built from: the CSR build's padding partition (K2), the CSR,
// SORT and OA probes' candidate bases (K3, K14, K16), K5's and K4's
// compactions (each tile's base), K7's group ranks, K18's per-destination
// positions (a status word a tile and destination) and, with a max in
// place of the sum, K15's displacement.
//
// Replaces the `jnp.cumsum` calls of the JAX package (hash_table.py:118-119,
// :287; columnar.py:418-444's survivor count).
//
// Bound on the H100: memory traffic. A kernel that takes its tile's prefix
// here reads its input once and writes its output once; the look-back adds
// one 8-byte status word a tile. Sums are carried in int64, so a total past
// 2^31 is reported exactly instead of wrapping.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Everything here has internal linkage: several .cu files of one library
// include it, and each gets its own copy of the kernels.
namespace dfp {
namespace {

typedef long long i64;

// one padding slot every 16 int64s keeps a thread's 16 consecutive
// elements on distinct banks
__device__ __forceinline__ int scan_pad(int j) { return j + (j >> 4); }

__device__ __forceinline__ i64 warp_inclusive_scan(i64 v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    i64 u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// Exclusive scan of one value per thread over the whole block (blockDim a
// multiple of 32, at most 1024). `smem` holds 33 int64. Returns the
// thread's exclusive prefix and stores the block total in *total.
__device__ __forceinline__ i64 block_exclusive_scan(i64 v, i64* smem, i64* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  i64 inc = warp_inclusive_scan(v);
  if (lane == 31) smem[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    i64 w = lane < nwarps ? smem[lane] : 0;
    i64 winc = warp_inclusive_scan(w);
    if (lane < nwarps) smem[lane] = winc - w;
    if (lane == 31) smem[32] = winc;
  }
  __syncthreads();
  i64 res = smem[warp] + inc - v;
  *total = smem[32];
  __syncthreads();  // smem is reused by the caller's next scan
  return res;
}

inline unsigned grid_for(i64 n, int block) { return (unsigned)((n + block - 1) / block); }

// ---------------------------------------------------------------------------
// Single-pass scans by decoupled look-back (Merrill and Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back", NVIDIA 2016): K2's padding
// partition, K3's, K14's and K16's candidate bases, K4's, K5's and K7's
// ranks, K15's displacement (K18 keeps a status word a tile and
// destination, each read back by its own thread, with the same flags). A
// block takes the next tile id from a counter, so a tile only waits on tiles
// already running; it publishes its aggregate at once, then warp 0 reads
// the status words of the 32 tiles before it at a time and combines them
// (a sum, or a max) up to the nearest one that holds its inclusive prefix.
// A status word is 64 bits: bit 63 marks an inclusive prefix, bit 62 an
// aggregate, bits 0-61 the value (below 2^62 and >= 0: K3's total of m
// rows' counts, each below 2^31; K15's displacement plus the capacity).
// The counter and the status words start zeroed: one memset of
// lookback_scratch_bytes.
// ---------------------------------------------------------------------------

constexpr uint64_t LB_INCLUSIVE = 1ull << 63;
constexpr uint64_t LB_AGGREGATE = 1ull << 62;
constexpr uint64_t LB_VALUE = LB_AGGREGATE - 1;

// status words of `tiles` tiles, then the tile counter
inline i64 lookback_scratch_bytes(i64 tiles) { return (tiles + 1) * (i64)sizeof(uint64_t); }

// The block's tile id, from the counter after the status words (every
// thread; one atomic).
__device__ __forceinline__ i64 lookback_tile(uint64_t* status, i64 tiles, int* smem_tile) {
  if (threadIdx.x == 0) *smem_tile = atomicAdd((int*)(status + tiles), 1);
  __syncthreads();
  return *smem_tile;
}

// The look-back's combines, each with 0 as its identity (the values are >= 0)
struct LookbackSum {
  __device__ __forceinline__ static i64 op(i64 a, i64 b) { return a + b; }
};
struct LookbackMax {
  __device__ __forceinline__ static i64 op(i64 a, i64 b) { return a > b ? a : b; }
};

// The sum (or, with LookbackMax, the max) of the tiles before `tile`, given
// this tile's `aggregate`; 0 for tile 0 (every thread of the block calls
// it; the result in every thread).
template <typename Combine = LookbackSum>
__device__ __forceinline__ i64 lookback_prefix(uint64_t* status, i64 tile, i64 aggregate,
                                               i64* smem_prefix) {
  volatile uint64_t* vs = status;
  if (threadIdx.x == 0) {
    vs[tile] = (tile == 0 ? LB_INCLUSIVE : LB_AGGREGATE) | (uint64_t)aggregate;
    if (tile == 0) *smem_prefix = 0;
  }
  if (tile > 0 && threadIdx.x < 32) {
    const int lane = threadIdx.x;
    i64 excl = 0;
    for (i64 t = tile - 1;; t -= 32) {
      const i64 at = t - lane;
      uint64_t s = LB_INCLUSIVE;  // before tile 0: an inclusive prefix of 0
      if (at >= 0) {
        do {
          s = vs[at];
        } while ((s & (LB_INCLUSIVE | LB_AGGREGATE)) == 0);
      }
      const unsigned inc = __ballot_sync(0xffffffffu, (s & LB_INCLUSIVE) != 0);
      // the lanes up to the nearest inclusive one (the lowest lane) count
      i64 v = (inc == 0u || lane <= __ffs(inc) - 1) ? (i64)(s & LB_VALUE) : 0;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) v = Combine::op(v, __shfl_xor_sync(0xffffffffu, v, d));
      excl = Combine::op(excl, v);
      if (inc != 0u) break;
    }
    if (lane == 0) {
      vs[tile] = LB_INCLUSIVE | (uint64_t)Combine::op(excl, aggregate);
      *smem_prefix = excl;
    }
  }
  __syncthreads();
  return *smem_prefix;
}

// ---------------------------------------------------------------------------
// Block-wide max-scan of int64: K3's marks and K15's displacement prefix
// (JAX `lax.cummax`, hash_table.py:169) inside a tile.
// ---------------------------------------------------------------------------

constexpr i64 MAX_IDENTITY = (i64)(-0x7fffffffffffffffLL - 1);

__device__ __forceinline__ i64 warp_inclusive_max(i64 v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    i64 u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = v > u ? v : u;
  }
  return v;
}

// Exclusive max of one value per thread over the block (MAX_IDENTITY for
// thread 0); *total = the block's max. `smem` holds 33 int64.
__device__ __forceinline__ i64 block_exclusive_max(i64 v, i64* smem, i64* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  i64 inc = warp_inclusive_max(v);
  i64 ex = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) ex = MAX_IDENTITY;
  if (lane == 31) smem[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    i64 w = lane < nwarps ? smem[lane] : MAX_IDENTITY;
    i64 winc = warp_inclusive_max(w);
    i64 wex = __shfl_up_sync(0xffffffffu, winc, 1);
    if (lane == 0) wex = MAX_IDENTITY;
    if (lane < nwarps) smem[lane] = wex;
    if (lane == 31) smem[32] = winc;
  }
  __syncthreads();
  const i64 before = smem[warp];
  i64 res = before > ex ? before : ex;
  *total = smem[32];
  __syncthreads();
  return res;
}

}  // namespace
}  // namespace dfp
