// The stable LSD radix pass that K2 csr_build and K6 radix_sort share.
//
// A pass sorts the rows stably by one 8-bit digit of a 32-bit key: it
// counts digits per 4096-row tile, scans the counts digit-major across
// tiles (scan.cuh), and scatters each row to its rank. Inside a warp the
// rank comes from __match_any_sync + __popc, a shared-memory prefix over
// the block's 8 warps orders the warps, and the 16 chunks of a tile are
// taken in order, so the pass is stable and linear in the rows whatever
// the key distribution (one value in every row costs what uniform keys
// cost).
//
// The callers differ in where the key of row i comes from (the `Load`
// functor: the key carried from the previous pass, or a word read through
// the current permutation) and in what the scatter writes besides the key
// and row id (the `Emit` functor: K2's last pass scatters its narrow rows
// there). The digit is read from key ^ flip, so a signed word sorts with
// its sign bit flipped (flip = 0x80000000) and an unsigned one as it is.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace dfp {
namespace {

constexpr int RADIX = 256;
constexpr int SORT_BLOCK = 256;  // == RADIX: thread d owns digit d in the warp prefix
constexpr int SORT_WARPS = SORT_BLOCK / 32;
constexpr int SORT_CHUNKS = 16;
constexpr int SORT_TILE = SORT_BLOCK * SORT_CHUNKS;

inline i64 sort_tiles(i64 n) { return (n + SORT_TILE - 1) / SORT_TILE; }

// the key of row i is keys[i]: carried in the current order (read through
// the read-only cache, as a __restrict__ kernel argument would be)
struct CarriedKey {
  const int32_t* keys;
  __device__ __forceinline__ uint32_t operator()(i64 i) const { return (uint32_t)__ldg(keys + i); }
};

// nothing is written besides the key and the row id
struct NoEmit {
  __device__ __forceinline__ void operator()(i64, int) const {}
};

// hist[d * n_tiles + tile] = rows of the tile whose digit is d
template <class Load>
__global__ void radix_hist_kernel(Load load, i64 n, int shift, uint32_t flip, i64 n_tiles,
                                  int32_t* __restrict__ hist) {
  __shared__ int cnt[RADIX];
  cnt[threadIdx.x] = 0;
  __syncthreads();
  const i64 base = (i64)blockIdx.x * SORT_TILE;
  for (int c = 0; c < SORT_CHUNKS; ++c) {
    const i64 i = base + (i64)c * SORT_BLOCK + threadIdx.x;
    const bool active = i < n;
    const int d = active ? (int)(((load(i) ^ flip) >> shift) & (RADIX - 1)) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (active && (int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&cnt[d], __popc(peers));
  }
  __syncthreads();
  hist[(i64)threadIdx.x * n_tiles + blockIdx.x] = cnt[threadIdx.x];
}

// Stable scatter of one tile by digit. `offsets` is the exclusive scan of
// the digit-major histogram; vals_in == nullptr means the row id;
// keys_out == nullptr when the next pass does not read the carried key.
// Held to 32 registers, 8 blocks an SM: K2's row-emitting last pass would
// otherwise take 34 and lose a quarter of its resident warps.
template <class Load, class Emit>
__global__ void __launch_bounds__(SORT_BLOCK, 8) radix_scatter_kernel(Load load, const int32_t* __restrict__ vals_in, i64 n,
                                     int shift, uint32_t flip, i64 n_tiles,
                                     const int32_t* __restrict__ offsets,
                                     int32_t* __restrict__ keys_out,
                                     int32_t* __restrict__ vals_out, Emit emit) {
  __shared__ int run[RADIX];
  __shared__ int warp_cnt[SORT_WARPS][RADIX];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  run[tid] = offsets[(i64)tid * n_tiles + blockIdx.x];
  const i64 base = (i64)blockIdx.x * SORT_TILE;
  for (int c = 0; c < SORT_CHUNKS; ++c) {
    const i64 chunk = base + (i64)c * SORT_BLOCK;
    if (chunk >= n) break;  // the same for every thread of the block
    const i64 i = chunk + tid;
    const bool active = i < n;
    const uint32_t key = active ? load(i) : 0u;
    const int val = active ? (vals_in != nullptr ? vals_in[i] : (int)i) : 0;
    // inactive lanes share a digit no real row has
    const int d = active ? (int)(((key ^ flip) >> shift) & (RADIX - 1)) : RADIX;
    for (int w = 0; w < SORT_WARPS; ++w) warp_cnt[w][tid] = 0;
    __syncthreads();
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int rank = __popc(peers & lanes_below);
    if (active && rank == 0) warp_cnt[warp][d] = __popc(peers);
    __syncthreads();
    {  // thread tid: digit tid's start for each warp, in warp order
      int s = run[tid];
      for (int w = 0; w < SORT_WARPS; ++w) {
        const int t = warp_cnt[w][tid];
        warp_cnt[w][tid] = s;
        s += t;
      }
      run[tid] = s;
    }
    __syncthreads();
    if (active) {
      const i64 dest = warp_cnt[warp][d] + rank;
      if (keys_out != nullptr) keys_out[dest] = (int32_t)key;
      vals_out[dest] = val;
      emit(dest, val);
    }
    __syncthreads();
  }
}

// Ping-pong keys and row ids, the histogram and the scan's scratch.
struct RadixScratch {
  int32_t *keys_a, *keys_b, *vals_a, *vals_b, *hist;
  void* scan;
  i64* total;
  i64 bytes;
};

inline i64 align256(i64 b) { return (b + 255) / 256 * 256; }

// The layout over `base` for n rows, its scan sized for at least scan_n
// entries (the histogram's own count when larger); base == nullptr only
// sizes it.
inline RadixScratch radix_carve(char* base, i64 n, i64 scan_n) {
  const i64 hist_n = RADIX * sort_tiles(n);
  if (scan_n < hist_n) scan_n = hist_n;
  RadixScratch s;
  i64 off = 0;
  auto take = [&](i64 bytes) {
    char* p = base == nullptr ? nullptr : base + off;
    off += align256(bytes);
    return p;
  };
  s.keys_a = (int32_t*)take(n * 4);
  s.keys_b = (int32_t*)take(n * 4);
  s.vals_a = (int32_t*)take(n * 4);
  s.vals_b = (int32_t*)take(n * 4);
  s.hist = (int32_t*)take(hist_n * 4);
  s.scan = take(scan_scratch_bytes(scan_n));
  s.total = (i64*)take(8);
  s.bytes = off;
  return s;
}

// One stable pass over n > 0 rows by the digit at `shift` of load(i) ^ flip.
template <class Load, class Emit>
void radix_pass(Load load, const int32_t* vals_in, i64 n, int shift, uint32_t flip,
                const RadixScratch& s, int32_t* keys_out, int32_t* vals_out, Emit emit,
                cudaStream_t st) {
  const i64 n_tiles = sort_tiles(n);
  radix_hist_kernel<<<(unsigned)n_tiles, SORT_BLOCK, 0, st>>>(load, n, shift, flip, n_tiles,
                                                              s.hist);
  exclusive_scan<int32_t, int32_t>(s.hist, RADIX * n_tiles, s.hist, s.total, s.scan, st);
  radix_scatter_kernel<<<(unsigned)n_tiles, SORT_BLOCK, 0, st>>>(
      load, vals_in, n, shift, flip, n_tiles, s.hist, keys_out, vals_out, emit);
}

}  // namespace
}  // namespace dfp
