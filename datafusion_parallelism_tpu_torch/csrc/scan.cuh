// Device-wide exclusive prefix sums: the three-pass scan of K4's
// compaction (survivor positions), K18's counting sort and the SORT and
// OA probes' candidate bases (K14, K16), and the single-pass look-back scan
// of the CSR build's padding partition, the CSR probe (candidate bases),
// K5's compaction (each tile's base) and K7's group ranks.
//
// Replaces the `jnp.cumsum` calls of the JAX package (hash_table.py:118-119,
// :287; columnar.py:418-444's survivor count).
//
// Bound on the H100: memory traffic. The input is read twice (reduce, then
// downsweep) and the output written once; everything else is one int64 per
// 4096-element tile. Blocks run in no order on 132 SMs, so the scan is the
// classic three passes: per-tile sums -> one block scans the tile sums ->
// each tile rescans itself from its offset. Sums are carried in int64, so a
// total past 2^31 is reported exactly instead of wrapping.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Everything here has internal linkage: several .cu files of one library
// include it, and each gets its own copy of the kernels.
namespace dfp {
namespace {

typedef long long i64;

constexpr int SCAN_BLOCK = 256;
constexpr int SCAN_ITEMS = 16;
constexpr int SCAN_TILE = SCAN_BLOCK * SCAN_ITEMS;

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

template <typename In>
__global__ void scan_reduce_kernel(const In* __restrict__ in, i64 n, i64* __restrict__ tile_sums) {
  __shared__ i64 smem[33];
  const i64 base = (i64)blockIdx.x * SCAN_TILE;
  i64 s = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    i64 i = base + (i64)k * SCAN_BLOCK + threadIdx.x;
    if (i < n) s += (i64)in[i];
  }
  i64 total;
  block_exclusive_scan(s, smem, &total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// One block of 1024 threads: tile sums -> exclusive tile offsets (in place);
// the grand total goes to *total.
__global__ void scan_tile_sums_kernel(i64* __restrict__ tile_sums, i64 n_tiles, i64* __restrict__ total) {
  __shared__ i64 smem[33];
  i64 carry = 0;
  for (i64 base = 0; base < n_tiles; base += blockDim.x) {
    const i64 i = base + threadIdx.x;
    const i64 v = i < n_tiles ? tile_sums[i] : 0;
    i64 chunk;
    const i64 ex = block_exclusive_scan(v, smem, &chunk);
    if (i < n_tiles) tile_sums[i] = carry + ex;
    carry += chunk;
  }
  if (threadIdx.x == 0) *total = carry;
}

template <typename In, typename Out>
__global__ void scan_downsweep_kernel(const In* in, i64 n,  // in, out may alias
                                      const i64* __restrict__ tile_offsets,
                                      Out* out) {
  __shared__ i64 tile[SCAN_TILE + SCAN_TILE / 16];
  __shared__ i64 smem[33];
  const i64 base = (i64)blockIdx.x * SCAN_TILE;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int j = k * SCAN_BLOCK + threadIdx.x;
    const i64 i = base + j;
    tile[scan_pad(j)] = i < n ? (i64)in[i] : 0;
  }
  __syncthreads();
  i64 s = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) s += tile[scan_pad(threadIdx.x * SCAN_ITEMS + k)];
  i64 unused;
  i64 run = block_exclusive_scan(s, smem, &unused) + tile_offsets[blockIdx.x];
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int j = scan_pad(threadIdx.x * SCAN_ITEMS + k);
    const i64 v = tile[j];
    tile[j] = run;
    run += v;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int j = k * SCAN_BLOCK + threadIdx.x;
    const i64 i = base + j;
    if (i < n) out[i] = (Out)tile[scan_pad(j)];
  }
}

inline i64 scan_tiles(i64 n) { return (n + SCAN_TILE - 1) / SCAN_TILE; }

// Scratch bytes exclusive_scan needs for n elements.
inline i64 scan_scratch_bytes(i64 n) { return (scan_tiles(n) + 1) * (i64)sizeof(i64); }

// out[i] = in[0] + ... + in[i-1] for i < n; *total (device int64) = the sum
// of all n. `in` and `out` may alias: every tile is read into shared memory
// before it is written. Launches only; the caller checks cudaGetLastError.
template <typename In, typename Out>
void exclusive_scan(const In* in, i64 n, Out* out, i64* total, void* scratch,
                    cudaStream_t stream) {
  i64* tile_sums = static_cast<i64*>(scratch);
  const i64 n_tiles = scan_tiles(n);
  if (n_tiles > 0) scan_reduce_kernel<In><<<(unsigned)n_tiles, SCAN_BLOCK, 0, stream>>>(in, n, tile_sums);
  scan_tile_sums_kernel<<<1, 1024, 0, stream>>>(tile_sums, n_tiles, total);
  if (n_tiles > 0)
    scan_downsweep_kernel<In, Out><<<(unsigned)n_tiles, SCAN_BLOCK, 0, stream>>>(in, n, tile_sums, out);
}

inline unsigned grid_for(i64 n, int block) { return (unsigned)((n + block - 1) / block); }

// ---------------------------------------------------------------------------
// Single-pass scans by decoupled look-back (Merrill and Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back", NVIDIA 2016): K2's padding
// partition and K3's candidate bases. A block takes the
// next tile id from a counter, so a tile only waits on tiles already
// running; it publishes its aggregate at once, then warp 0 reads the status
// words of the 32 tiles before it at a time and adds them up to the nearest
// one that holds its inclusive prefix. A status word is 64 bits: bit 63
// marks an inclusive prefix, bit 62 an aggregate, bits 0-61 the value (a
// sum below 2^62: K3's total of m rows' counts, each below 2^31). The
// counter and the status words start zeroed: one memset of
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

// The sum of the tiles before `tile`, given this tile's `aggregate` (every
// thread of the block calls it; the result in every thread).
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
      for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
      excl += v;
      if (inc != 0u) break;
    }
    if (lane == 0) {
      vs[tile] = LB_INCLUSIVE | (uint64_t)(excl + aggregate);
      *smem_prefix = excl;
    }
  }
  __syncthreads();
  return *smem_prefix;
}

// ---------------------------------------------------------------------------
// Device-wide inclusive MAX-scan of int64, in place: the open-addressing
// build's displacement prefix (JAX `lax.cummax`, hash_table.py:169). The
// same three passes as the sum: per-tile maxima -> one block turns them
// into exclusive tile prefixes -> each tile rescans itself from its prefix.
// Templates, so that a source which does not use it compiles none of it.
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

template <typename Unused = void>
__global__ void max_reduce_kernel(const i64* __restrict__ in, i64 n, i64* __restrict__ tile_max) {
  __shared__ i64 smem[33];
  const i64 base = (i64)blockIdx.x * SCAN_TILE;
  i64 s = MAX_IDENTITY;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const i64 i = base + (i64)k * SCAN_BLOCK + threadIdx.x;
    if (i < n && in[i] > s) s = in[i];
  }
  i64 total;
  block_exclusive_max(s, smem, &total);
  if (threadIdx.x == 0) tile_max[blockIdx.x] = total;
}

// One block of 1024 threads: tile maxima -> exclusive tile prefixes, in place.
template <typename Unused = void>
__global__ void max_tiles_kernel(i64* __restrict__ tile_max, i64 n_tiles) {
  __shared__ i64 smem[33];
  i64 carry = MAX_IDENTITY;
  for (i64 base = 0; base < n_tiles; base += blockDim.x) {
    const i64 i = base + threadIdx.x;
    const i64 v = i < n_tiles ? tile_max[i] : MAX_IDENTITY;
    i64 chunk;
    const i64 ex = block_exclusive_max(v, smem, &chunk);
    if (i < n_tiles) tile_max[i] = carry > ex ? carry : ex;
    if (chunk > carry) carry = chunk;
  }
}

template <typename Unused = void>
__global__ void max_downsweep_kernel(i64* data, i64 n, const i64* __restrict__ tile_prefix) {
  __shared__ i64 tile[SCAN_TILE + SCAN_TILE / 16];
  __shared__ i64 smem[33];
  const i64 base = (i64)blockIdx.x * SCAN_TILE;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int j = k * SCAN_BLOCK + threadIdx.x;
    const i64 i = base + j;
    tile[scan_pad(j)] = i < n ? data[i] : MAX_IDENTITY;
  }
  __syncthreads();
  i64 s = MAX_IDENTITY;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const i64 v = tile[scan_pad(threadIdx.x * SCAN_ITEMS + k)];
    if (v > s) s = v;
  }
  i64 unused;
  i64 run = block_exclusive_max(s, smem, &unused);
  const i64 prefix = tile_prefix[blockIdx.x];
  if (prefix > run) run = prefix;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int j = scan_pad(threadIdx.x * SCAN_ITEMS + k);
    if (tile[j] > run) run = tile[j];
    tile[j] = run;  // inclusive
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int j = k * SCAN_BLOCK + threadIdx.x;
    const i64 i = base + j;
    if (i < n) data[i] = tile[scan_pad(j)];
  }
}

// Scratch bytes inclusive_max_scan needs for n elements.
inline i64 max_scan_scratch_bytes(i64 n) { return (scan_tiles(n) + 1) * (i64)sizeof(i64); }

// data[i] = max(data[0..i]) for i < n, in place. Launches only; the caller
// checks cudaGetLastError.
inline void inclusive_max_scan(i64* data, i64 n, void* scratch, cudaStream_t stream) {
  i64* tile_max = static_cast<i64*>(scratch);
  const i64 n_tiles = scan_tiles(n);
  if (n_tiles == 0) return;
  max_reduce_kernel<><<<(unsigned)n_tiles, SCAN_BLOCK, 0, stream>>>(data, n, tile_max);
  max_tiles_kernel<><<<1, 1024, 0, stream>>>(tile_max, n_tiles);
  max_downsweep_kernel<><<<(unsigned)n_tiles, SCAN_BLOCK, 0, stream>>>(data, n, tile_max);
}

}  // namespace
}  // namespace dfp
