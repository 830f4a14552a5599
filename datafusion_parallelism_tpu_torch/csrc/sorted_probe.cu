// K14 sorted_probe: candidate ranges of the probe rows against the SORT
// strategy's table (build rows sorted by hash).
//
// Replaces the JAX package's SORT branch of `probe_ranges`
// (ops/hash_table.py:257-263: two `jnp.searchsorted` of the probe hash in
// the sorted int64 keys) and `probe_candidates`' cumsum (:283-288).
//
// Bound on the H100: random reads. A binary search over the whole
// capacity (268 MB of keys at 2^25, past the 50 MB L2) costs a probe row
// 25 dependent loads, each a 32-byte sector for 8 bytes. A probe key is
// the hash as unsigned, below 2^32, so its place is fixed by its top
// `bits` bits to within one bucket of a directory over the sorted keys:
//
//   dir[k] = the first position whose key is >= k << (32 - bits),
//            for k = 0 .. 2^bits (dir[2^bits]: the keys below 2^32),
//
// and both its bounds lie in [dir[k], dir[k+1]) for k its top bits: every
// key of a lower bucket lies before dir[k], every key of a higher one at
// or past dir[k+1]. The wrapper picks `bits` from the capacity (about 8
// keys a bucket: a 16 MB directory at 2^25, held in the L2), so a row
// reads one directory pair and a bucket of one or two sectors. This holds
// for any sorted int64 keys: negative ones lie before dir[0], those of
// 2^32 or more (the table's 2^33 of null keys and padding) past
// dir[2^bits], and no probe reaches either. Each launch builds its
// directory into its scratch:
//
//   bounds, one thread a tile of DIR_TILE entries: the tile's first
//           position, by one binary search (as K2's tile_bounds_kernel);
//   fill,   a block a tile: the tile's keys mark where each entry starts
//           in shared memory (a key whose entry differs from the key
//           before it starts the entries between them), then the tile is
//           written out coalesced; a tile of more than DIR_SCAN_KEYS keys
//           (a hot key) finds each entry by a binary search, or a gallop
//           from the one before (as K2's fill_kernel);
//   probe,  one launch: a block takes the next tile of PROBE_TILE probe
//           rows, reads each row's directory pair, counts the keys below
//           and at its key in a bucket of at most BUCKET_SCAN keys (all
//           its loads at once), else searches the bucket: the lower bound
//           by a binary search, the end of its run by reading on RUN_SCAN
//           keys and past them by a second binary search (a hot key costs
//           log2 of its bucket, not its run's length); start = the lower
//           bound, count = end - start, or 0 for a row out of range or
//           with a null key (its start is kept, as JAX keeps
//           searchsorted's answer); base = the exclusive sum of count by
//           decoupled look-back (scan.cuh), the total in int64.
//
// Measured on an H100 80GB HBM3 at 700 W (PERF.md): at a Q7-shaped call
// (2^26 probe rows, 15,000,000 keys at capacity 2^25) 3.48 ms for the
// binary search over the capacity, about 2.0 here. Fewer keys a bucket
// gain at most 0.1 ms there and lose at a sparse build; a 32-byte record a
// bucket with its first keys inline (one sector a row: 268 MB of records
// to write each launch), and a thread's rows searching in lockstep, lost.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

using dfp::i64;

constexpr int MAX_BITS = 28;
constexpr int DIR_BLOCK = 256;
constexpr int DIR_ITEMS = 16;
constexpr int DIR_TILE = DIR_BLOCK * DIR_ITEMS;    // directory entries a fill block writes
constexpr int DIR_SCAN_KEYS = 16 * DIR_TILE;       // past this, a fill tile searches
constexpr int PROBE_BLOCK = 256;
constexpr int PROBE_ITEMS = 8;
constexpr int PROBE_TILE = PROBE_BLOCK * PROBE_ITEMS;  // probe rows a block takes
constexpr int BUCKET_SCAN = 8;  // a bucket of at most this many keys is read whole
constexpr int RUN_SCAN = 8;     // keys read on from the lower bound before a search

inline i64 dir_entries(int bits) { return ((i64)1 << bits) + 1; }
inline i64 dir_tiles(int bits) { return (dir_entries(bits) + DIR_TILE - 1) / DIR_TILE; }
inline i64 probe_tiles(i64 m) { return (m + PROBE_TILE - 1) / PROBE_TILE; }
inline i64 align8(i64 b) { return (b + 7) & ~(i64)7; }

// scratch: the look-back's status words and counter, the directory, the
// fill tiles' first positions
inline i64 status_bytes(i64 m) { return dfp::lookback_scratch_bytes(probe_tiles(m)); }
inline i64 dir_bytes(int bits) { return align8(dir_entries(bits) * (i64)sizeof(int32_t)); }
inline i64 scratch_need(i64 m, int bits) {
  return status_bytes(m) + dir_bytes(bits) + (dir_tiles(bits) + 1) * (i64)sizeof(int32_t);
}

// entry k's least key
__device__ __forceinline__ i64 entry_key(i64 k, int bits) { return k << (32 - bits); }

// the entry a key starts: -1 below 0, its top bits, 2^bits from 2^32 on
__device__ __forceinline__ i64 entry_of(i64 key, int bits) {
  if (key < 0) return -1;
  const i64 e = key >> (32 - bits), top = (i64)1 << bits;
  return e < top ? e : top;
}

// the first position in [lo, hi) whose key is >= t (<= t with `upper`), else hi
template <bool upper>
__device__ __forceinline__ i64 search(const i64* __restrict__ keys, i64 lo, i64 hi, i64 t) {
  while (lo < hi) {
    const i64 mid = (lo + hi) >> 1;
    const i64 k = __ldg(keys + mid);
    if (upper ? k <= t : k < t) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// first[t] = the first position of the n sorted keys at or past entry
// min(t * DIR_TILE, 2^bits), for t in [0, tiles]: the keys of 2^32 or more
// belong to no tile
__global__ void __launch_bounds__(256) dir_bounds_kernel(const i64* __restrict__ keys, i64 n,
                                                         int bits, i64 tiles,
                                                         int32_t* __restrict__ first) {
  const i64 t = (i64)blockIdx.x * 256 + threadIdx.x;
  if (t > tiles) return;
  const i64 top = (i64)1 << bits, e = t * DIR_TILE;
  first[t] = (int32_t)search<false>(keys, 0, n, entry_key(e < top ? e : top, bits));
}

// Block t writes entries [t * DIR_TILE, +DIR_TILE) of the 2^bits + 1: the
// keys [first[t], first[t+1]) start entries of this tile alone.
__global__ void __launch_bounds__(DIR_BLOCK) dir_fill_kernel(const i64* __restrict__ keys,
                                                             int bits,
                                                             const int32_t* __restrict__ first,
                                                             int32_t* __restrict__ dir) {
  __shared__ int32_t d[DIR_TILE];
  const int tid = threadIdx.x;
  const i64 k0 = (i64)blockIdx.x * DIR_TILE;
  const i64 lo = first[blockIdx.x], hi = first[blockIdx.x + 1];
  if (hi - lo <= DIR_SCAN_KEYS) {
    // an entry no key of the tile starts begins at hi
#pragma unroll
    for (int k = 0; k < DIR_ITEMS; ++k) d[k * DIR_BLOCK + tid] = (int32_t)hi;
    __syncthreads();
    // key i starts the entries past its predecessor's, up to its own
    for (i64 i = lo + tid; i < hi; i += DIR_BLOCK) {
      const i64 e = entry_of(__ldg(keys + i), bits);
      const i64 before = i == lo ? k0 - 1 : entry_of(__ldg(keys + i - 1), bits);
      for (i64 k = before + 1; k <= e; ++k) d[k - k0] = (int32_t)i;
    }
  } else {  // a hot tile: a thread's 16 entries in order, the first by a binary
            // search, each next one by a gallop from the one before
    i64 at = lo;
#pragma unroll 1
    for (int k = 0; k < DIR_ITEMS; ++k) {
      const i64 t = entry_key(k0 + tid * DIR_ITEMS + k, bits);
      i64 l = at, h = hi;
      if (k > 0) {  // every position before `at` holds a key < t
        h = at;
        for (i64 step = 1; h < hi && __ldg(keys + h) < t; step <<= 1) {
          l = h + 1;
          h += step;
        }
        h = h < hi ? h : hi;
      }
      at = search<false>(keys, l, h, t);
      d[tid * DIR_ITEMS + k] = (int32_t)at;
    }
  }
  __syncthreads();
  const i64 entries = ((i64)1 << bits) + 1;
#pragma unroll
  for (int k = 0; k < DIR_ITEMS; ++k) {
    const i64 e = k0 + k * DIR_BLOCK + tid;
    if (e < entries) dir[e] = d[k * DIR_BLOCK + tid];
  }
}

// (lower, upper) bounds of `key` among the sorted keys [lo, hi), which hold
// every key of its bucket: a binary search for the lower, then the run's
// end by reading on RUN_SCAN keys and, past them, a second search
__device__ __forceinline__ void wide_bounds(const i64* __restrict__ keys, i64 lo, i64 hi,
                                            i64 key, int32_t& s, int32_t& e) {
  const i64 l = search<false>(keys, lo, hi, key);
  i64 r = l;
  const i64 stop = l + RUN_SCAN < hi ? l + RUN_SCAN : hi;
  while (r < stop && __ldg(keys + r) == key) ++r;
  if (r == stop && stop < hi) r = search<true>(keys, r, hi, key);  // a long run
  s = (int32_t)l;
  e = (int32_t)r;
}

// (lower, upper) bounds of `key` among the sorted keys [lo, hi), which hold
// every key of its bucket: a bucket of at most BUCKET_SCAN keys is read
// whole (its loads at once, most of them in the first one's sector)
__device__ __forceinline__ void bucket_bounds(const i64* __restrict__ keys, i64 lo, i64 hi,
                                              i64 key, int32_t& s, int32_t& e) {
  if (hi - lo > BUCKET_SCAN) {
    wide_bounds(keys, lo, hi, key, s, e);
    return;
  }
  int below = 0, upto = 0;
#pragma unroll
  for (int q = 0; q < BUCKET_SCAN; ++q) {
    if (lo + q < hi) {
      const i64 k = __ldg(keys + lo + q);
      below += k < key;
      upto += k <= key;
    }
  }
  s = (int32_t)(lo + below);
  e = (int32_t)(lo + upto);
}

__global__ void __launch_bounds__(PROBE_BLOCK) probe_kernel(
    const int32_t* __restrict__ hashes, const uint8_t* __restrict__ ok, i64 m,
    const i64* __restrict__ keys, const int32_t* __restrict__ dir, int bits, uint64_t* status,
    i64 tiles, int32_t* __restrict__ start, int32_t* __restrict__ count,
    int32_t* __restrict__ base, i64* __restrict__ total) {
  __shared__ int32_t cnt[PROBE_TILE + PROBE_TILE / 16];
  __shared__ i64 smem[33];
  __shared__ i64 prefix;
  __shared__ int tile_sh;
  const int tid = threadIdx.x;
  const i64 tile = dfp::lookback_tile(status, tiles, &tile_sh);
  const i64 first = tile * PROBE_TILE;
  // every hash and directory read of the tile in flight at once, rows striped
  uint32_t h[PROBE_ITEMS];
  bool valid[PROBE_ITEMS];
#pragma unroll
  for (int k = 0; k < PROBE_ITEMS; ++k) {
    const i64 i = first + k * PROBE_BLOCK + tid;
    h[k] = i < m ? (uint32_t)__ldg(hashes + i) : 0u;
    valid[k] = i < m && __ldg(ok + i) != 0;
  }
  int32_t lo[PROBE_ITEMS], hi[PROBE_ITEMS];
#pragma unroll
  for (int k = 0; k < PROBE_ITEMS; ++k) {
    const i64 b = (i64)((uint64_t)h[k] >> (32 - bits));
    const bool in = first + k * PROBE_BLOCK + tid < m;
    lo[k] = in ? __ldg(dir + b) : 0;
    hi[k] = in ? __ldg(dir + b + 1) : 0;
  }
#pragma unroll
  for (int k = 0; k < PROBE_ITEMS; ++k) {
    const int j = k * PROBE_BLOCK + tid;
    int32_t lower, upper;
    bucket_bounds(keys, lo[k], hi[k], (i64)h[k], lower, upper);
    const int32_t c = valid[k] ? upper - lower : 0;
    cnt[dfp::scan_pad(j)] = c;
    if (first + j < m) {
      start[first + j] = lower;
      count[first + j] = c;
    }
  }
  __syncthreads();
  // thread tid: rows tid * PROBE_ITEMS .. +PROBE_ITEMS of the tile, in order
  i64 sum = 0;
#pragma unroll
  for (int k = 0; k < PROBE_ITEMS; ++k) sum += cnt[dfp::scan_pad(tid * PROBE_ITEMS + k)];
  i64 agg;
  const i64 ex = dfp::block_exclusive_scan(sum, smem, &agg);
  const i64 excl = dfp::lookback_prefix(status, tile, agg, &prefix);
  i64 run = excl + ex;
#pragma unroll
  for (int k = 0; k < PROBE_ITEMS; ++k) {
    const int j = dfp::scan_pad(tid * PROBE_ITEMS + k);
    const int32_t c = cnt[j];
    cnt[j] = (int32_t)run;
    run += c;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PROBE_ITEMS; ++k) {
    const int j = k * PROBE_BLOCK + tid;
    if (first + j < m) base[first + j] = cnt[dfp::scan_pad(j)];
  }
  if (tile == tiles - 1 && tid == 0) *total = excl + agg;
}

}  // namespace

// The launch plan this file was built with, which kernels/sorted_probe.py
// copies for its scratch sizes and its host replay: entry i of (MAX_BITS,
// DIR_TILE, DIR_SCAN_KEYS, PROBE_TILE, BUCKET_SCAN, RUN_SCAN), -1 past
// them; and the scratch bytes of a launch.
extern "C" long long dfp_sorted_probe_plan(int i) {
  const long long plan[] = {MAX_BITS, DIR_TILE, DIR_SCAN_KEYS, PROBE_TILE, BUCKET_SCAN, RUN_SCAN};
  return i >= 0 && i < (int)(sizeof(plan) / sizeof(plan[0])) ? plan[i] : -1;
}

extern "C" long long dfp_sorted_probe_scratch_bytes(long long m, int bits) {
  return scratch_need(m, bits);
}

// hashes int32[m] (uint32 bits), ok bool[m], sorted int64[cap] ascending;
// bits in [0, 28]: the directory's 2^bits buckets; start, count, base
// int32[m]; total64 a device int64.
extern "C" int dfp_sorted_probe(const void* hashes, const void* ok, long long m,
                                const void* sorted, long long cap, int bits, void* start,
                                void* count, void* base, void* total64, void* scratch,
                                long long scratch_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m < 1 || bits < 0 || bits > MAX_BITS || scratch_bytes < scratch_need(m, bits))
    return (int)cudaErrorInvalidValue;
  uint64_t* status = (uint64_t*)scratch;
  int32_t* dir = (int32_t*)((char*)scratch + status_bytes(m));
  int32_t* first = (int32_t*)((char*)dir + dir_bytes(bits));
  const i64 tiles = probe_tiles(m), dtiles = dir_tiles(bits);
  const i64* keys = (const i64*)sorted;
  cudaMemsetAsync(status, 0, (size_t)status_bytes(m), st);
  dir_bounds_kernel<<<dfp::grid_for(dtiles + 1, 256), 256, 0, st>>>(keys, cap, bits, dtiles,
                                                                     first);
  dir_fill_kernel<<<(unsigned)dtiles, DIR_BLOCK, 0, st>>>(keys, bits, first, dir);
  probe_kernel<<<(unsigned)tiles, PROBE_BLOCK, 0, st>>>(
      (const int32_t*)hashes, (const uint8_t*)ok, m, keys, dir, bits, status, tiles,
      (int32_t*)start, (int32_t*)count, (int32_t*)base, (i64*)total64);
  return (int)cudaGetLastError();
}
