// K18 dest_pack: each row's destination partition, and per destination the
// first send_cap row ids in row order: the index grid a shuffle gathers
// its send blocks by.
//
// Replaces the JAX package's `route_of` (parallel/shuffle.py:62), the
// stable argsort + searchsorted + clipped take of `_pack_by_dest` (:69-94),
// the membership matrix, [P, cap] cumsum and searchsorted pick of
// `replicating_shuffle` (:150-188), and the salted route of
// `salted_route` (parallel/skew.py:68-78).
//
// A row's destination: P for a row outside the mask (padding, or a
// late-materialized invalid row: never sent); else the rank for a row
// whose hash bucket (the top 8 bits) the heavy table marks (the salted
// probe side); else route_of: ((h >> 16) * P) >> 16. A row in the mask
// belongs to every destination where its replicate flag is set, or, with
// heavy_to_all, where the heavy table marks its bucket (the skewed build
// side's broadcast; such a row does not stay on the rank). grid[d, j] is the row id of the j-th member of
// destination d in row order, for j < min(counts[d], send_cap); the rest
// of the grid is 0. counts[d] is the number of members (past send_cap
// too), dropped the sum of max(counts[d] - send_cap, 0).
//
// Bound on the H100: memory traffic. Each row's hash, mask byte (and
// replicate byte) is read twice and each kept row id written once; the
// grid is zero-filled first. Blocks run in no order, yet the order within
// a destination must be row order, as JAX's stable argsort and cumsum
// pick give it. So it is a counting sort by destination:
//   * counts: each block of TILE rows counts its members per destination
//     (warp ballots, shared-memory sums) into block_counts[d, block];
//   * offsets: the shared device-wide exclusive scan (scan.cuh) over
//     block_counts in destination-major order gives every (destination,
//     block) pair the position of its first member;
//   * scatter: each block walks its rows again in order, 256 at a time;
//     a member's position in its destination is its block's offset, the
//     members of the earlier rounds and warps, and its rank in its warp's
//     ballot. Members below send_cap write their row id.
// Per row and destination one ballot: a row of a replicated table may
// belong to every destination, and P is small (the partitions of a mesh).

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

using dfp::i64;

constexpr int MAX_P = 1024;
constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int ROUNDS = 8;
constexpr int TILE = BLOCK * ROUNDS;

struct Route {
  const int32_t* hash;
  const uint8_t* mask;
  const uint8_t* heavy;      // [256] or null
  const uint8_t* replicate;  // [cap] or null
  int P;
  int rank;
  int heavy_to_all;  // heavy rows go to every destination, not to rank
  i64 cap;

  // the row's destination (P: not sent) and whether it goes to every one
  __device__ __forceinline__ int dest(i64 i, bool* all) const {
    *all = false;
    if (i >= cap || !mask[i]) return P;
    const uint32_t h = (uint32_t)hash[i];
    if (replicate != nullptr && replicate[i]) *all = true;
    if (heavy != nullptr && heavy[h >> 24]) {
      if (!heavy_to_all) return rank;
      *all = true;
    }
    return (int)(((unsigned long long)(h >> 16) * (unsigned long long)P) >> 16);
  }
};

__global__ void dest_count_kernel(Route r, i64 n_blocks, int32_t* __restrict__ block_counts) {
  __shared__ int32_t cnt[MAX_P];
  for (int d = threadIdx.x; d < r.P; d += BLOCK) cnt[d] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const i64 base = (i64)blockIdx.x * TILE;
  for (int k = 0; k < ROUNDS; ++k) {
    bool all;
    const int dst = r.dest(base + (i64)k * BLOCK + threadIdx.x, &all);
    for (int d = 0; d < r.P; ++d) {
      const unsigned b = __ballot_sync(0xffffffffu, dst == d || (all && dst < r.P));
      if (lane == 0 && b) atomicAdd(&cnt[d], __popc(b));
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < r.P; d += BLOCK)
    block_counts[(i64)d * n_blocks + blockIdx.x] = cnt[d];
}

__global__ void dest_scatter_kernel(Route r, i64 n_blocks, const int32_t* __restrict__ offsets,
                                    i64 send_cap, int32_t* __restrict__ grid) {
  __shared__ int32_t base_pos[MAX_P];         // the block's next position per destination
  __shared__ int32_t warp_pos[WARPS][MAX_P];  // a round's members per warp, then positions
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  for (int d = threadIdx.x; d < r.P; d += BLOCK)
    base_pos[d] = offsets[(i64)d * n_blocks + blockIdx.x] - offsets[(i64)d * n_blocks];
  const i64 tile = (i64)blockIdx.x * TILE;
  for (int k = 0; k < ROUNDS; ++k) {
    const i64 i = tile + (i64)k * BLOCK + threadIdx.x;
    bool all;
    const int dst = r.dest(i, &all);
    for (int d = 0; d < r.P; ++d) {
      const unsigned b = __ballot_sync(0xffffffffu, dst == d || (all && dst < r.P));
      if (lane == 0) warp_pos[warp][d] = __popc(b);
    }
    __syncthreads();
    // each warp's first position per destination; the block moves on by
    // the round's members (the thread owning d is the one that set it)
    for (int d = threadIdx.x; d < r.P; d += BLOCK) {
      int run = base_pos[d];
      for (int w = 0; w < WARPS; ++w) {
        const int c = warp_pos[w][d];
        warp_pos[w][d] = run;
        run += c;
      }
      base_pos[d] = run;
    }
    __syncthreads();
    for (int d = 0; d < r.P; ++d) {
      const bool member = dst == d || (all && dst < r.P);
      const unsigned b = __ballot_sync(0xffffffffu, member);
      if (member) {
        const i64 pos = (i64)warp_pos[warp][d] + __popc(b & lt);
        if (pos < send_cap) grid[(i64)d * send_cap + pos] = (int32_t)i;
      }
    }
    __syncthreads();  // the next round writes warp_pos again
  }
}

// counts[d] from the scanned block counts; dropped = sum max(counts - send_cap, 0)
__global__ void dest_counts_kernel(const int32_t* __restrict__ offsets,
                                   const i64* __restrict__ total, int P, i64 n_blocks,
                                   i64 send_cap, int32_t* __restrict__ counts,
                                   int32_t* __restrict__ dropped) {
  __shared__ long long drop;
  if (threadIdx.x == 0) drop = 0;
  __syncthreads();
  for (int d = threadIdx.x; d < P; d += blockDim.x) {
    const i64 lo = n_blocks > 0 ? offsets[(i64)d * n_blocks] : 0;
    const i64 hi = n_blocks == 0 ? 0 : d + 1 < P ? (i64)offsets[(i64)(d + 1) * n_blocks] : *total;
    const i64 c = hi - lo;
    counts[d] = (int32_t)c;
    if (c > send_cap) atomicAdd((unsigned long long*)&drop, (unsigned long long)(c - send_cap));
  }
  __syncthreads();
  if (threadIdx.x == 0) *dropped = (int32_t)drop;
}

struct Scratch {
  int32_t* block_counts;  // [P * n_blocks], scanned in place
  i64* total;
  void* scan;
  i64 bytes;
};

Scratch carve(char* base, i64 cap, int P) {
  const i64 n_blocks = (cap + TILE - 1) / TILE;
  const i64 n = (i64)P * n_blocks;
  Scratch s;
  i64 off = 0;
  auto take = [&](i64 bytes) {
    char* p = base ? base + off : nullptr;
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  s.block_counts = (int32_t*)take(n * 4);
  s.total = (i64*)take(8);
  s.scan = take(dfp::scan_scratch_bytes(n));
  s.bytes = off;
  return s;
}

}  // namespace

extern "C" long long dfp_dest_pack_scratch_bytes(long long cap, int P) {
  return carve(nullptr, cap, P).bytes;
}

// hash [cap] int32 (uint32 bits), mask [cap] bytes; heavy [256] bytes and
// replicate [cap] bytes may be null; heavy_to_all sends the heavy rows to
// every destination instead of to rank. Out: grid [P, send_cap] int32,
// counts [P] int32, dropped (device int32).
extern "C" int dfp_dest_pack(const void* hash, const void* mask, long long cap, int P,
                             const void* heavy, int rank, int heavy_to_all,
                             const void* replicate, long long send_cap, void* grid,
                             void* counts, void* dropped, void* scratch,
                             long long scratch_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (P < 1 || P > MAX_P || cap < 0 || send_cap < 0) return (int)cudaErrorInvalidValue;
  const Scratch s = carve((char*)scratch, cap, P);
  if (scratch_bytes < s.bytes) return (int)cudaErrorInvalidValue;
  const i64 n_blocks = (cap + TILE - 1) / TILE;
  const Route r{(const int32_t*)hash, (const uint8_t*)mask, (const uint8_t*)heavy,
                (const uint8_t*)replicate, P, rank, heavy_to_all, cap};
  if (send_cap > 0) cudaMemsetAsync(grid, 0, (size_t)P * (size_t)send_cap * 4, st);
  if (n_blocks > 0) {
    dest_count_kernel<<<(unsigned)n_blocks, BLOCK, 0, st>>>(r, n_blocks, s.block_counts);
    dfp::exclusive_scan<int32_t, int32_t>(s.block_counts, (i64)P * n_blocks, s.block_counts,
                                          s.total, s.scan, st);
    dest_scatter_kernel<<<(unsigned)n_blocks, BLOCK, 0, st>>>(r, n_blocks, s.block_counts,
                                                              send_cap, (int32_t*)grid);
  }
  dest_counts_kernel<<<1, 1024, 0, st>>>(s.block_counts, s.total, P, n_blocks, send_cap,
                                         (int32_t*)counts, (int32_t*)dropped);
  return (int)cudaGetLastError();
}
