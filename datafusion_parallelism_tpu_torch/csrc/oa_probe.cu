// K16 oa_probe: candidate ranges of the probe rows against the OA
// strategy's open-addressing table.
//
// Replaces the JAX package's `_probe_oa` (ops/hash_table.py:180-222: a
// `while_loop` that walks every probe row one slot a step, in lockstep,
// until each has found its run of equal hashes or an empty slot) and
// `probe_candidates`' cumsum (:283-288).
//
// Bound on the H100: random reads. A walk starts at a random home slot
// and reads consecutive int64 slots; at the table's load (at most one row
// in four home slots; 9% at Q7's 15,000,000 rows in S = 167,772,160) most
// walks end at the home slot or the one after it. One launch, by
// decoupled look-back (scan.cuh): a block takes the next tile of
// PROBE_TILE probe rows from the counter and walks it in PROBE_ROUNDS
// rounds of PROBE_ITEMS rows a thread (256 apart, so every load of
// `hashes` and `ok` is coalesced):
//
//   each ok row's home is slot_of(hash, T) (slot_of.cuh; T = 4S/5, as the
//   JAX walk takes it); every ok row's home slot and the one after it are
//   read at once (one 16-byte load for an even home), then the next two
//   of the rows still walking, up to THREAD_SLOTS slots: seeking, the
//   first slot whose high word is the row's hash sets start and an empty
//   slot (0) ends the walk with count 0; counting, each further equal hash
//   adds one and anything else ends it. A walk past THREAD_SLOTS slots (a
//   crowded home, a long run) goes on with its whole warp, one row at a
//   time, 64 slots a read settled by ballots, so a cluster of thousands
//   of slots costs its warp a read every 64 slots, not its thread a read
//   a slot. A row without `ok` gets start 0 and count 0;
//   the tile's counts are scanned in shared memory, its base taken by
//   look-back, and start, count and base written once; the last tile
//   writes the int64 total (the wrapper raises past 2^31, as JAX's int32
//   cumsum would wrap).
//
// A look-back waits on the tiles before it, whose walks vary in length,
// so a tile of many rounds (8,192 rows) keeps the waits few; the rows a
// thread holds at once stay few enough for four blocks an SM. Measured on
// an H100 80GB HBM3 at 700 W (PERF.md): at Q7's shape 1.02-1.04 ms of
// device time against 1.14 for the walk and three-launch scan before; at
// 1,024 rows a tile 1.22-1.26 (the tiles' waits); with the warps' reads
// from 4 slots on 0.99, but a Size512 probe 0.29 ms against 0.21 from 6 on.
//
// A walk takes at most S steps, its position clamped at S - 1, as the JAX
// loop's `k < S` and `minimum(cur, S - 1)`: a walk that reaches slot S - 1
// reads it again for every step it has left, which the kernel counts in
// one go. For a table the build placed, slot S - 1 is always empty: an
// occupied slot is at most (cap - 1) + (T - 1) <= S - 2, so every walk
// ends before it.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"
#include "slot_of.cuh"

namespace {

using dfp::i64;
typedef unsigned long long u64;

constexpr int PROBE_BLOCK = 256;
constexpr int PROBE_ITEMS = 4;                          // rows a thread walks at once
constexpr int PROBE_ROUND = PROBE_BLOCK * PROBE_ITEMS;  // rows a block walks at once
constexpr int PROBE_ROUNDS = 8;                         // rounds a tile
constexpr int THREAD_SLOTS = 6;  // slots a row walks on its own thread, then its warp walks on
constexpr int PROBE_TILE = PROBE_ROUND * PROBE_ROUNDS;  // probe rows a block takes
constexpr unsigned FULL = 0xffffffffu;

inline i64 probe_tiles(i64 m) { return (m + PROBE_TILE - 1) / PROBE_TILE; }

// A walk's state: start, count, whether it has found its run, whether it
// has ended.
struct Walk {
  int32_t st, cnt;
  bool counting, done;
};

// One step of the JAX walk at slot `cur` holding v. At slot S - 1 the walk
// ends: every step left (S - 1 - (cur - home) = home of them) reads that
// slot again, so a run there counts them all and a seek never ends.
__device__ __forceinline__ void step(Walk& w, u64 v, uint32_t h, i64 cur, i64 home, i64 S) {
  const bool match = v != 0 && (uint32_t)(v >> 32) == h;
  if (w.counting) {
    if (!match) {
      w.done = true;
      return;
    }
    ++w.cnt;
  } else if (match) {
    w.st = (int32_t)cur;
    w.cnt = 1;
    w.counting = true;
  } else if (v == 0) {
    w.done = true;
    return;
  }
  if (cur == S - 1) {
    if (w.counting) w.cnt += (int32_t)home;
    w.done = true;
  }
}

// Slots p and p + 1 (p <= S - 1; 0 past S): one 16-byte load where p is
// even, both are in the table and it is 16-byte aligned.
__device__ __forceinline__ void two_slots(const u64* __restrict__ slots, i64 S, bool pairs, i64 p,
                                          u64* x, u64* y) {
  if (pairs && (p & 1) == 0 && p + 1 < S) {
    const ulonglong2 v = __ldg(reinterpret_cast<const ulonglong2*>(slots) + (p >> 1));
    *x = v.x;
    *y = v.y;
  } else {
    *x = __ldg(slots + p);
    *y = p + 1 < S ? __ldg(slots + p + 1) : 0ull;
  }
}

// The rest of one row's walk from slot `cur`, by the whole warp (every
// lane calls it with the same arguments): 64 slots a read, the first
// slot that stops a seek and the first that ends a run found by ballots.
__device__ __forceinline__ Walk warp_walk(const u64* __restrict__ slots, i64 S, uint32_t h,
                                          i64 cur, i64 home, Walk w) {
  const int lane = threadIdx.x & 31;
  const Walk lost{0, 0, false, true};
  for (;; cur += 64) {
    const i64 p0 = cur + lane, p1 = cur + 32 + lane;
    const u64 v0 = p0 <= S - 1 ? __ldg(slots + p0) : 0ull;
    const u64 v1 = p1 <= S - 1 ? __ldg(slots + p1) : 0ull;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const i64 base = cur + 32 * half;
      const u64 v = half ? v1 : v0;
      const bool in = base + lane <= S - 1;
      const unsigned M = __ballot_sync(FULL, in && v != 0 && (uint32_t)(v >> 32) == h);
      const unsigned E = __ballot_sync(FULL, in && v == 0);
      const unsigned IN = __ballot_sync(FULL, in);  // a prefix of the lanes
      int g0 = 0;
      if (!w.counting) {
        const unsigned stop = M | E;
        if (stop == 0u) {
          if (IN != FULL) return lost;  // seeks through slot S - 1: never found
          continue;
        }
        g0 = __ffs(stop) - 1;
        if (((M >> g0) & 1u) == 0u) return lost;  // an empty slot first
        w.st = (int32_t)(base + g0);
        w.cnt = 0;
        w.counting = true;
      }
      const unsigned ends = ~M & IN & (FULL << g0);  // the slots that end the run
      if (ends != 0u) {
        w.cnt += __ffs(ends) - 1 - g0;
        w.done = true;
        return w;
      }
      if (IN != FULL) {  // the run reaches slot S - 1
        w.cnt += __popc(IN) - g0 + (int32_t)home;
        w.done = true;
        return w;
      }
      w.cnt += 32 - g0;
    }
  }
}

// The walks of one round of a tile, PROBE_ITEMS rows a thread from row
// `first` (tile position `at`): start and count written, the counts into
// `cnt` (padded, tile order).
__device__ __forceinline__ void walk_round(const int32_t* __restrict__ hashes,
                                           const uint8_t* __restrict__ ok, i64 m,
                                           const u64* __restrict__ slots, i64 S, uint64_t T,
                                           bool pairs, i64 first, int at,
                                           int32_t* __restrict__ start,
                                           int32_t* __restrict__ count, int32_t* cnt) {
  const int tid = threadIdx.x, lane = tid & 31;
  uint32_t h[PROBE_ITEMS];
  Walk w[PROBE_ITEMS];
#pragma unroll
  for (int k = 0; k < PROBE_ITEMS; ++k) {
    const i64 i = first + k * PROBE_BLOCK + tid;
    h[k] = i < m ? (uint32_t)__ldg(hashes + i) : 0u;
    w[k] = Walk{0, 0, false, !(i < m && __ldg(ok + i) != 0)};
  }
  // the home slot and the one after it of every ok row in flight at once,
  // then the next two of the rows still walking
  u64 x[PROBE_ITEMS], y[PROBE_ITEMS];
#pragma unroll
  for (int s0 = 0; s0 < THREAD_SLOTS; s0 += 2) {
#pragma unroll
    for (int k = 0; k < PROBE_ITEMS; ++k)
      if (!w[k].done) two_slots(slots, S, pairs, dfp::slot_of(h[k], T) + s0, &x[k], &y[k]);
#pragma unroll
    for (int k = 0; k < PROBE_ITEMS; ++k) {
      const i64 home = dfp::slot_of(h[k], T);
      if (!w[k].done) step(w[k], x[k], h[k], home + s0, home, S);
      if (!w[k].done) step(w[k], y[k], h[k], home + s0 + 1, home, S);
    }
  }
  // a walk past THREAD_SLOTS slots goes on with the whole warp, one row at
  // a time
#pragma unroll
  for (int k = 0; k < PROBE_ITEMS; ++k) {
    for (unsigned left = __ballot_sync(FULL, !w[k].done); left != 0u; left &= left - 1u) {
      const int src = __ffs(left) - 1;
      const uint32_t hs = __shfl_sync(FULL, h[k], src);
      Walk ws;
      ws.st = __shfl_sync(FULL, w[k].st, src);
      ws.cnt = __shfl_sync(FULL, w[k].cnt, src);
      ws.counting = __shfl_sync(FULL, (int)w[k].counting, src) != 0;
      ws.done = false;
      const i64 home = dfp::slot_of(hs, T);
      ws = warp_walk(slots, S, hs, home + THREAD_SLOTS, home, ws);
      if (lane == src) w[k] = ws;
    }
  }
#pragma unroll
  for (int k = 0; k < PROBE_ITEMS; ++k) {
    const i64 i = first + k * PROBE_BLOCK + tid;
    const int32_t c = w[k].counting ? w[k].cnt : 0;
    cnt[dfp::scan_pad(at + k * PROBE_BLOCK + tid)] = c;
    if (i < m) {
      start[i] = w[k].counting ? w[k].st : 0;
      count[i] = c;
    }
  }
}

__global__ void __launch_bounds__(PROBE_BLOCK) oa_probe_kernel(
    const int32_t* __restrict__ hashes, const uint8_t* __restrict__ ok, i64 m,
    const u64* __restrict__ slots, i64 S, uint64_t T, bool pairs, uint64_t* status, i64 tiles,
    int32_t* __restrict__ start, int32_t* __restrict__ count, int32_t* __restrict__ base,
    i64* __restrict__ total) {
  constexpr int ROW_RUN = PROBE_ITEMS * PROBE_ROUNDS;  // the consecutive rows a thread scans
  __shared__ int32_t cnt[PROBE_TILE + PROBE_TILE / 16];  // the tile's counts, then its bases
  __shared__ i64 smem[33];
  __shared__ i64 prefix;
  __shared__ int tile_sh;
  const int tid = threadIdx.x;
  const i64 tile = dfp::lookback_tile(status, tiles, &tile_sh);
  const i64 first = tile * PROBE_TILE;
#pragma unroll 1
  for (int r = 0; r < PROBE_ROUNDS; ++r)
    walk_round(hashes, ok, m, slots, S, T, pairs, first + r * PROBE_ROUND, r * PROBE_ROUND,
               start, count, cnt);
  __syncthreads();
  // thread tid: rows tid * ROW_RUN .. + ROW_RUN of the tile, in order
  i64 sum = 0;
#pragma unroll
  for (int k = 0; k < ROW_RUN; ++k) sum += cnt[dfp::scan_pad(tid * ROW_RUN + k)];
  i64 agg;
  const i64 ex = dfp::block_exclusive_scan(sum, smem, &agg);
  const i64 excl = dfp::lookback_prefix(status, tile, agg, &prefix);
  i64 run = excl + ex;
#pragma unroll
  for (int k = 0; k < ROW_RUN; ++k) {
    const int j = dfp::scan_pad(tid * ROW_RUN + k);
    const int32_t c = cnt[j];
    cnt[j] = (int32_t)run;
    run += c;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < ROW_RUN; ++k) {
    const int j = k * PROBE_BLOCK + tid;
    if (first + j < m) base[first + j] = cnt[dfp::scan_pad(j)];
  }
  if (tile == tiles - 1 && tid == 0) *total = excl + agg;
}

}  // namespace

// The launch plan this file was built with, which kernels/oa_probe.py
// copies for its scratch sizes and its host replay: entry i of
// (PROBE_ITEMS, PROBE_ROUNDS, PROBE_TILE, THREAD_SLOTS), -1 past them; and
// the scratch bytes of a launch over m probe rows (the look-back's status
// words and tile counter, zeroed by the launcher).
extern "C" long long dfp_oa_probe_plan(int i) {
  const long long plan[] = {PROBE_ITEMS, PROBE_ROUNDS, PROBE_TILE, THREAD_SLOTS};
  return i >= 0 && i < (int)(sizeof(plan) / sizeof(plan[0])) ? plan[i] : -1;
}

extern "C" long long dfp_oa_probe_scratch_bytes(long long m) {
  return dfp::lookback_scratch_bytes(probe_tiles(m));
}

// hashes int32[m] (uint32 bits), ok bool[m], slots int64[S] with T = 4S/5
// home slots; start, count, base int32[m]; total64 a device int64.
extern "C" int dfp_oa_probe(const void* hashes, const void* ok, long long m, const void* slots,
                            long long S, long long T, void* start, void* count, void* base,
                            void* total64, void* scratch, long long scratch_bytes,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const i64 tiles = probe_tiles(m);
  if (m < 1 || T < 1 || T >= S || scratch_bytes < dfp::lookback_scratch_bytes(tiles))
    return (int)cudaErrorInvalidValue;
  cudaMemsetAsync(scratch, 0, (size_t)dfp::lookback_scratch_bytes(tiles), st);
  oa_probe_kernel<<<(unsigned)tiles, PROBE_BLOCK, 0, st>>>(
      (const int32_t*)hashes, (const uint8_t*)ok, m, (const u64*)slots, S, (uint64_t)T,
      ((uintptr_t)slots & 15) == 0, (uint64_t*)scratch, tiles, (int32_t*)start,
      (int32_t*)count, (int32_t*)base, (i64*)total64);
  return (int)cudaGetLastError();
}
