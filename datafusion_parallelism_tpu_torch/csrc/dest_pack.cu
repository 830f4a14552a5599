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
// side's broadcast; such a row does not stay on the rank). grid[d, j] is
// the row id of the j-th member of destination d in row order, for j <
// min(counts[d], send_cap); the rest of the grid is 0. counts[d] is the
// number of members (past send_cap too), dropped the sum of
// max(counts[d] - send_cap, 0).
//
// Bound on the H100: memory traffic, the [P, send_cap] grid most of it
// (268 MB at phase 19's largest call, 8,388,608 rows at P = 8 and send_cap
// = the rows). Each row is routed once and each grid entry written once:
//
//   pass, one launch by decoupled look-back over a vector of P counts
//         (scan.cuh's scheme, one status word a tile and destination): a
//         block takes the next tile of TILE rows, each warp ROUNDS x 32
//         consecutive rows, reads their hashes, mask (and replicate)
//         bytes coalesced and routes each row once, keeping its
//         destination in registers. Within a warp a round's rows are
//         ranked by destination with one __match_any_sync (a round that
//         holds a row of every destination, replicated or heavy_to_all,
//         takes a ballot a destination instead), the warp's running count
//         a destination in shared memory; the warps' counts are scanned
//         per destination, thread d publishes the tile's count of d and
//         takes d's prefix from the tiles before by look-back, and the
//         rows are ranked again from those bases and written below
//         send_cap. The last tile writes counts and dropped;
//   tail, grid-stride: zeros in [min(counts[d], send_cap), send_cap) of
//         each destination's row, 16 bytes a store.
// Within a destination a tile's members are consecutive in the grid, so
// a warp's stores of one destination land in one or two sectors. Measured
// on an H100 80GB HBM3 at 700 W (PERF.md), at the route call above: pass
// 89 µs and tail 93 µs of device time, against 262 µs for the memset,
// count, three-launch scan, scatter and counts launches before; a ballot
// a destination in every round (P = 8) and 16 rounds a warp were slower,
// 4 rounds and reading 8 or 16 status words at once level.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

using dfp::i64;

constexpr int MAX_P = 1024;
constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int ROUNDS = 8;                  // 32-row rounds a warp takes
constexpr int TILE = BLOCK * ROUNDS;       // rows a block takes
constexpr int TAIL_BLOCK = 256;
constexpr unsigned FULL = 0xffffffffu;
static_assert(BLOCK == 256, "a thread a heavy-table byte");

inline i64 pack_tiles(i64 cap) { return (cap + TILE - 1) / TILE; }

// scratch: a status word a tile and destination, then the tile counter,
// zeroed by one memset
inline i64 scratch_need(i64 cap, int P) {
  return dfp::lookback_scratch_bytes(pack_tiles(cap) * P);
}

struct Route {
  const int32_t* hash;
  const uint8_t* mask;
  const uint8_t* heavy;      // [256] or null
  const uint8_t* replicate;  // [cap] or null
  int P;
  int rank;
  int heavy_to_all;  // heavy rows go to every destination, not to rank
  i64 cap;
};

// A round of a warp's 32 rows against the warp's running counts `run[d]`
// (shared memory, the warp's own): each member's position is the count of
// its destination before it; the counts move on by the round's members.
// WRITE: members below send_cap write their row id into the grid.
template <bool WRITE>
__device__ __forceinline__ void rank_round(int dst, bool all, i64 row, int P, int* run,
                                           i64 send_cap, int32_t* __restrict__ grid) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  if (__ballot_sync(FULL, all) == 0u) {
    const unsigned peers = __match_any_sync(FULL, dst);  // the lanes of this destination
    const int leader = __ffs(peers) - 1;
    int before = 0;
    if (lane == leader && dst < P) {
      before = run[dst];
      run[dst] = before + __popc(peers);
    }
    before = __shfl_sync(FULL, before, leader);
    if (WRITE && dst < P) {
      const i64 pos = before + __popc(peers & lt);
      if (pos < send_cap) grid[(i64)dst * send_cap + pos] = (int32_t)row;
    }
  } else {  // a row of every destination in the round: a ballot a destination
    for (int d = 0; d < P; ++d) {
      const bool member = dst == d || all;
      const unsigned b = __ballot_sync(FULL, member);
      if (b == 0u) continue;
      const int before = run[d];
      if (WRITE && member) {
        const i64 pos = before + __popc(b & lt);
        if (pos < send_cap) grid[(i64)d * send_cap + pos] = (int32_t)row;
      }
      __syncwarp();
      if (lane == 0) run[d] = before + __popc(b);
      __syncwarp();
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(BLOCK) dest_pack_kernel(
    Route r, i64 send_cap, uint64_t* status, i64 tiles, int32_t* __restrict__ grid,
    int32_t* __restrict__ counts, int32_t* __restrict__ dropped) {
  extern __shared__ int pack_smem[];
  int* run_all = pack_smem;               // per warp and destination: counts, then positions
  int* tile_cnt = pack_smem + WARPS * r.P;  // per destination: the tile's members
  __shared__ uint8_t heavy_sm[256];
  __shared__ unsigned long long drop;
  __shared__ int tile_sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = r.P;
  const i64 tile = dfp::lookback_tile(status, tiles * P, &tile_sh);
  for (int j = tid; j < WARPS * P; j += BLOCK) run_all[j] = 0;
  if (r.heavy != nullptr) heavy_sm[tid] = r.heavy[tid];  // BLOCK == 256
  if (tid == 0) drop = 0;
  __syncthreads();
  // route the warp's rows once: every load in flight, then the destinations
  const i64 w0 = tile * TILE + (i64)warp * (ROUNDS * 32) + lane;
  int32_t h[ROUNDS];
  uint8_t in_mask[ROUNDS], rep[ROUNDS];
#pragma unroll
  for (int k = 0; k < ROUNDS; ++k) {
    const i64 i = w0 + k * 32;
    in_mask[k] = i < r.cap ? __ldg(r.mask + i) : 0;
    h[k] = i < r.cap ? __ldg(r.hash + i) : 0;
    rep[k] = i < r.cap && r.replicate != nullptr ? __ldg(r.replicate + i) : 0;
  }
  int dst[ROUNDS];
  unsigned all_bits = 0;
#pragma unroll
  for (int k = 0; k < ROUNDS; ++k) {
    const uint32_t hk = (uint32_t)h[k];
    bool all = in_mask[k] && rep[k];
    int d = (int)(((unsigned long long)(hk >> 16) * (unsigned long long)P) >> 16);
    if (in_mask[k] && r.heavy != nullptr && heavy_sm[hk >> 24]) {
      if (r.heavy_to_all) all = true;
      else d = r.rank;
    }
    dst[k] = in_mask[k] ? d : P;
    all_bits |= (unsigned)all << k;
  }
  int* run = run_all + warp * P;
#pragma unroll
  for (int k = 0; k < ROUNDS; ++k)
    rank_round<false>(dst[k], (all_bits >> k) & 1u, w0 + k * 32, P, run, send_cap, grid);
  __syncthreads();
  // per destination: the warps' first positions in the tile and the
  // tile's count, published at once; then d's prefix from the tiles before
  volatile uint64_t* vs = status;
  for (int d = tid; d < P; d += BLOCK) {
    int sum = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int c = run_all[w * P + d];
      run_all[w * P + d] = sum;
      sum += c;
    }
    tile_cnt[d] = sum;
    vs[tile * P + d] = (tile == 0 ? dfp::LB_INCLUSIVE : dfp::LB_AGGREGATE) | (uint64_t)sum;
  }
  for (int d = tid; d < P; d += BLOCK) {
    i64 excl = 0;
    for (i64 t = tile - 1; t >= 0; --t) {
      uint64_t s;
      do {
        s = vs[t * P + d];
      } while ((s & (dfp::LB_INCLUSIVE | dfp::LB_AGGREGATE)) == 0);
      excl += (i64)(s & dfp::LB_VALUE);
      if (s & dfp::LB_INCLUSIVE) break;
    }
    const i64 total = excl + tile_cnt[d];
    if (tile > 0) vs[tile * P + d] = dfp::LB_INCLUSIVE | (uint64_t)total;
    for (int w = 0; w < WARPS; ++w) run_all[w * P + d] += (int)excl;
    if (tile == tiles - 1) {
      counts[d] = (int32_t)total;
      if (total > send_cap) atomicAdd(&drop, (unsigned long long)(total - send_cap));
    }
  }
  __syncthreads();
  if (tile == tiles - 1 && tid == 0) *dropped = (int32_t)drop;
#pragma unroll
  for (int k = 0; k < ROUNDS; ++k)
    rank_round<true>(dst[k], (all_bits >> k) & 1u, w0 + k * 32, P, run, send_cap, grid);
}

// zeros in [min(counts[d], send_cap), send_cap) of row d = blockIdx.y
__global__ void __launch_bounds__(TAIL_BLOCK) dest_tail_kernel(const int32_t* __restrict__ counts,
                                                               i64 send_cap,
                                                               int32_t* __restrict__ grid) {
  const i64 d = blockIdx.y;
  const i64 c = counts[d];
  const i64 lo = d * send_cap + (c < send_cap ? c : send_cap), hi = (d + 1) * send_cap;
  const i64 v0 = (lo + 3) >> 2, v1 = hi >> 2;  // the 16-byte words wholly in [lo, hi)
  const i64 gid = (i64)blockIdx.x * TAIL_BLOCK + threadIdx.x, step = (i64)gridDim.x * TAIL_BLOCK;
  if (v0 > v1) {  // fewer than four entries, inside one word
    if (gid < hi - lo) grid[lo + gid] = 0;
    return;
  }
  if (gid < 4) {
    if (lo + gid < 4 * v0) grid[lo + gid] = 0;
    if (4 * v1 + gid < hi) grid[4 * v1 + gid] = 0;
  }
  for (i64 p = v0 + gid; p < v1; p += step)
    reinterpret_cast<int4*>(grid)[p] = make_int4(0, 0, 0, 0);
}

}  // namespace

// The launch plan this file was built with, which kernels/dest_pack.py
// copies for its scratch sizes and its host replay: entry i of (ROUNDS,
// TILE, MAX_P), -1 past them.
extern "C" long long dfp_dest_pack_plan(int i) {
  const long long plan[] = {ROUNDS, TILE, MAX_P};
  return i >= 0 && i < (int)(sizeof(plan) / sizeof(plan[0])) ? plan[i] : -1;
}

extern "C" long long dfp_dest_pack_scratch_bytes(long long cap, int P) {
  return P >= 1 && P <= MAX_P && cap >= 0 ? scratch_need(cap, P) : -1;
}

// hash [cap] int32 (uint32 bits), mask [cap] bytes; heavy [256] bytes and
// replicate [cap] bytes may be null; heavy_to_all sends the heavy rows to
// every destination instead of to rank. Out: grid [P, send_cap] int32
// (16-byte aligned), counts [P] int32, dropped (device int32). sms: the
// device's SM count.
extern "C" int dfp_dest_pack(const void* hash, const void* mask, long long cap, int P,
                             const void* heavy, int rank, int heavy_to_all,
                             const void* replicate, long long send_cap, void* grid,
                             void* counts, void* dropped, void* scratch,
                             long long scratch_bytes, int sms, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (P < 1 || P > MAX_P || cap < 0 || send_cap < 0 || sms < 1 ||
      scratch_bytes < scratch_need(cap, P) || ((uintptr_t)grid & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const i64 tiles = pack_tiles(cap);
  cudaMemsetAsync(scratch, 0, (size_t)scratch_need(cap, P), st);
  if (tiles > 0) {
    const Route r{(const int32_t*)hash, (const uint8_t*)mask, (const uint8_t*)heavy,
                  (const uint8_t*)replicate, P, rank, heavy_to_all, cap};
    dest_pack_kernel<<<(unsigned)tiles, BLOCK, (WARPS + 1) * P * sizeof(int), st>>>(
        r, send_cap, (uint64_t*)scratch, tiles, (int32_t*)grid, (int32_t*)counts,
        (int32_t*)dropped);
  } else {
    cudaMemsetAsync(counts, 0, (size_t)P * 4, st);
    cudaMemsetAsync(dropped, 0, 4, st);
  }
  if (send_cap > 0) {
    const i64 row_blocks = (send_cap + 4 * TAIL_BLOCK - 1) / (4 * TAIL_BLOCK);
    const i64 share = (8 * (i64)sms + P - 1) / P;  // about 8 blocks an SM over the P rows
    const dim3 blocks((unsigned)(row_blocks < share ? row_blocks : share), (unsigned)P);
    dest_tail_kernel<<<blocks, TAIL_BLOCK, 0, st>>>((const int32_t*)counts, send_cap,
                                                    (int32_t*)grid);
  }
  return (int)cudaGetLastError();
}
