// The one-sweep LSD radix sort of K6 radix_sort: one packed key of the
// bits that vary between rows, sorted by 8-bit digit passes that each read
// the keys once and take their offsets by decoupled look-back (after
// Adinets and Merrill, "Onesweep: A Faster Least Significant Digit Radix
// Sort for GPUs", NVIDIA 2022), adapted to K6's stable, multi-word argsort.
//
// 1. pack_hist_kernel reads the key words [k, n] once, coalesced, and
//    writes one packed key a row: the varying bits (a mask the host reads
//    off the words' AND and OR) of word ^ flip, most significant word
//    highest; 32 bits where there are B <= 32 varying bits, 64 where
//    B <= 64, else 32-bit chunks, one launch each (past 64 bits a pass over
//    32-bit keys moves 16 bytes a row against 24, which on the H100
//    outweighed the extra chunks' gathers on capacity-padded grouping keys,
//    tools/bench_k6.py). In the same read it counts the 256-bin histogram
//    of the chunk's first digit (shared-memory atomics, then atomics into
//    that pass's counts).
// 2. Every later digit's histogram is counted by the pass before it, from
//    the keys it holds anyway: counting all of a chunk's digits in the
//    pack kernel cost more than the shared atomics cost spread over the
//    passes (measured on the H100).
// 3. onesweep_pass_kernel, one launch a digit: each block takes the next
//    tile id from an atomic counter (so a tile only ever waits on tiles
//    that are already running), loads ITEMS keys and row ids a thread into
//    registers (warp-striped: each warp load reads 32 neighbouring keys,
//    and a warp's keys stay in input order, which keeps the rank stable),
//    counts the tile's digits (shared atomics per warp) and publishes the
//    counts at once, ranks the keys stably (a warp multisplit by the
//    digit's bits' ballots, which measured faster than __match_any_sync on
//    the H100, and a running start per warp and digit) straight into their
//    place in a digit-ordered copy of the tile in shared memory, takes the
//    tile's exclusive offsets by looking back over the earlier tiles'
//    status words, and writes key and row id together, so consecutive
//    threads write consecutive addresses of each digit's run. A tile
//    whose rows all share the digit (the padding of a capacity-padded
//    table, most tiles of most passes there) skips the ranking and writes
//    its rows in order, read again from the cache. The first
//    pass makes the row ids; the last writes only the permutation; the
//    first pass of a later chunk reads that chunk through the current
//    permutation (the only gather, past 64 varying bits).
//
// K2 csr_build runs the same pass over its 32-bit bucket ids, with the
// row count on the device (OsDeviceRows).
//
// A status word is 64 bits: bit 63 says that it holds the inclusive prefix
// of the tiles up to it (else the tile's own count), bits 40-62 the pass
// (plus one) that wrote it, bits 0-39 the count. Every pass of a sort
// shares one status array, zeroed once up front: a word left by an earlier
// pass carries that pass's tag and reads as not yet written.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace dfp {
namespace {

constexpr int OS_RADIX = 256;
constexpr int OS_BLOCK = 256;  // == OS_RADIX: thread d owns digit d
constexpr int OS_WARPS = OS_BLOCK / 32;
constexpr int OS_MAX_WORDS = 64;
constexpr int PACK_ROWS = 4;        // rows a thread packs per round
constexpr int OS_LOOKBACK = 2;      // status words a look-back step reads

// keys a thread ranks per pass: a tile of 8192 (32-bit) or 6144 (64-bit)
// keys, two blocks an SM (measured faster on the H100 than 12-48 keys a
// thread, one to four blocks an SM and 384- or 512-thread blocks: larger
// tiles mean fewer look-back steps and barriers a key)
template <class K> struct OneSweepItems;
template <> struct OneSweepItems<uint32_t> { static constexpr int value = 32; };
template <> struct OneSweepItems<uint64_t> { static constexpr int value = 24; };

constexpr uint64_t OS_INCLUSIVE = 1ull << 63;
constexpr int OS_TAG_SHIFT = 40;
constexpr uint64_t OS_TAG_MASK = (1ull << 23) - 1;
constexpr uint64_t OS_COUNT_MASK = (1ull << 40) - 1;

// The host's packing plan: word w's varying bits `mask`, its sign flip and
// the bit of the packed key where its lowest varying bit lands.
struct PackWords {
  uint32_t mask[OS_MAX_WORDS];
  uint32_t flip[OS_MAX_WORDS];
  int offset[OS_MAX_WORDS];
  int k;
};

// The bits of x under m, moved down to the low end in order (a parallel
// bit extract), one contiguous run of m at a time. m is the same in every
// thread, so the loop does not diverge.
__device__ __forceinline__ uint32_t os_pext(uint32_t x, uint32_t m) {
  uint32_t r = 0;
  int out = 0;
  while (m != 0u) {
    const int s = __ffs(m) - 1;
    const uint32_t t = m >> s;
    const int len = t == 0xFFFFFFFFu ? 32 : __ffs(~t) - 1;
    const uint32_t run = len == 32 ? 0xFFFFFFFFu : (1u << len) - 1u;
    r |= ((x >> s) & run) << out;
    out += len;
    m &= ~(run << s);
  }
  return r;
}

// keys[i] = chunk `chunk` (its bits from 8 * sizeof(K) * chunk up) of row
// i's packed key;
// hist[d] += the rows whose first digit (the low `width` bits) is d.
template <class K>
__global__ void __launch_bounds__(OS_BLOCK) pack_hist_kernel(const int32_t* __restrict__ words,
                                                             i64 n, PackWords pw, int chunk,
                                                             int width, K* __restrict__ keys,
                                                             int32_t* __restrict__ hist) {
  __shared__ int cnt[OS_RADIX];
  const int tid = threadIdx.x;
  cnt[tid] = 0;
  __syncthreads();
  constexpr int CW = 8 * sizeof(K);  // the chunk's bits
  const int lo = CW * chunk;
  for (i64 base = (i64)blockIdx.x * OS_BLOCK * PACK_ROWS; base < n;
       base += (i64)gridDim.x * OS_BLOCK * PACK_ROWS) {
    uint64_t v[PACK_ROWS];
#pragma unroll
    for (int r = 0; r < PACK_ROWS; ++r) v[r] = 0;
    for (int w = 0; w < pw.k; ++w) {
      const uint32_t m = pw.mask[w];
      const int at = pw.offset[w] - lo;
      if (m == 0u || at >= CW || at + __popc(m) <= 0) continue;  // the same in every thread
      uint32_t x[PACK_ROWS];
#pragma unroll
      for (int r = 0; r < PACK_ROWS; ++r) {
        const i64 i = base + r * OS_BLOCK + tid;
        x[r] = i < n ? (uint32_t)__ldg(words + (i64)w * n + i) : 0u;
      }
#pragma unroll
      for (int r = 0; r < PACK_ROWS; ++r) {
        const uint64_t e = os_pext(x[r] ^ pw.flip[w], m);
        v[r] |= at >= 0 ? e << at : e >> -at;
      }
    }
#pragma unroll
    for (int r = 0; r < PACK_ROWS; ++r) {
      const i64 i = base + r * OS_BLOCK + tid;
      if (i < n) {
        keys[i] = (K)v[r];
        atomicAdd(&cnt[(int)v[r] & ((1 << width) - 1)], 1);
      }
    }
  }
  __syncthreads();
  if (cnt[tid] != 0) atomicAdd(&hist[tid], cnt[tid]);
}

// The rows a pass sorts: a count the host knows (K6: the grid covers them
// exactly), or one on the device (K2: its rows ahead of the padding; the
// grid covers the most there can be, and the blocks past them return).
struct OsHostRows {
  i64 n;
  OsHostRows(i64 rows) : n(rows) {}
  static constexpr bool EXACT = true;
  __device__ __forceinline__ i64 get() const { return n; }
};
struct OsDeviceRows {
  const i64* n;
  static constexpr bool EXACT = false;
  __device__ __forceinline__ i64 get() const { return *n; }
};
// Rows is named, never deduced: K6 passes its count as an i64
template <class T> struct OsNamed { using type = T; };

// One stable pass by the digit (key >> shift) & (2^width - 1). keys_in is
// the carried key of position i, or (GATHER) the chunk indexed by row id,
// read at vals_in[i]; vals_in == nullptr means the row id i;
// keys_out == nullptr when the next pass does not read the carried key.
// `tag` is this pass's number plus one; hist its 256 digit counts over
// all rows. Where the next pass sorts by another digit of these keys
// (next_width > 0, at next_shift), the pass counts it into hist_next. The
// tile's keys and row ids sit in dynamic shared memory (os_pass_smem).
template <class K, bool GATHER, class Rows = OsHostRows>
__global__ void __launch_bounds__(OS_BLOCK, 2) onesweep_pass_kernel(
    const K* __restrict__ keys_in, const int32_t* __restrict__ vals_in,
    typename OsNamed<Rows>::type rows, int shift,
    int width, int next_shift, int next_width, uint64_t tag, const int32_t* __restrict__ hist,
    int32_t* __restrict__ hist_next, int* __restrict__ tile_counter, uint64_t* status,
    K* __restrict__ keys_out, int32_t* __restrict__ vals_out) {
  constexpr int ITEMS = OneSweepItems<K>::value, TILE = OS_BLOCK * ITEMS;
  extern __shared__ __align__(16) unsigned char os_dyn[];
  K* skeys = (K*)os_dyn;
  int32_t* svals = (int32_t*)(skeys + TILE);
  __shared__ int wcnt[OS_WARPS][OS_RADIX];
  __shared__ int dst[OS_RADIX];
  __shared__ int nxt[OS_RADIX];
  __shared__ i64 smem[33];
  __shared__ int tile_sh, uniform;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const i64 n = rows.get();
  const unsigned below = (1u << lane) - 1u;
  const unsigned dmask = (1u << width) - 1u;
  const unsigned nmask = (1u << next_width) - 1u;
#pragma unroll
  for (int w = 0; w < OS_WARPS; ++w) wcnt[w][tid] = 0;
  nxt[tid] = 0;
  if (tid == 0) {
    tile_sh = atomicAdd(tile_counter, 1);
    uniform = -1;
  }
  __syncthreads();
  const i64 tile = tile_sh;
  const i64 first = tile * TILE;
  if (!Rows::EXACT && first >= n) return;  // past the rows on the device
  const i64 valid = n - first;  // rows of the tile: TILE but in the last
  const i64 wbase = first + (i64)warp * (32 * ITEMS);

  // load: item j of lane l is position wbase + 32 j + l; every load of the
  // tile is in flight at once
  K key[ITEMS];
  int32_t val[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const i64 i = wbase + j * 32 + lane;
    val[j] = i < n ? (vals_in != nullptr ? __ldg(vals_in + i) : (int32_t)i) : 0;
  }
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const i64 i = wbase + j * 32 + lane;
    if (GATHER) {
      key[j] = i < n ? keys_in[val[j]] : (K)0;
    } else {
      key[j] = i < n ? keys_in[i] : (K)0;
    }
  }

  // early counts: each warp's rows of each digit; and the tile's rows of
  // each value of the next pass's digit, added to its histogram at once
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (wbase + j * 32 + lane < n) {
      atomicAdd(&wcnt[warp][(int)((key[j] >> shift) & dmask)], 1);
      if (next_width > 0) atomicAdd(&nxt[(int)((key[j] >> next_shift) & nmask)], 1);
    }
  }
  __syncthreads();
  if (nxt[tid] != 0) atomicAdd(&hist_next[tid], nxt[tid]);

  // thread tid = digit d: the tile's count of d, published at once for the
  // tiles after it; where each warp's rows of d start in the tile
  int total = 0;
#pragma unroll
  for (int w = 0; w < OS_WARPS; ++w) {
    const int c = wcnt[w][tid];
    wcnt[w][tid] = total;
    total += c;
  }
  volatile uint64_t* mine = status + tile * OS_RADIX + tid;
  const uint64_t tagged = tag << OS_TAG_SHIFT;
  *mine = (tile == 0 ? OS_INCLUSIVE : 0ull) | tagged | (uint64_t)total;
  i64 unused;
  const int tile_start = (int)block_exclusive_scan(total, smem, &unused);
  const i64 start = block_exclusive_scan((i64)hist[tid], smem, &unused);  // of d in the output
#pragma unroll
  for (int w = 0; w < OS_WARPS; ++w) wcnt[w][tid] += tile_start;
  if (total == (valid < TILE ? valid : TILE)) uniform = tid;  // one digit in every row
  __syncthreads();
  const int one = uniform;

  // stable rank inside the warp, in input order, and the tile in digit
  // order in shared memory: the lanes of an item that share its digit come
  // from its bits' ballots (a warp multisplit); the lowest of them moves
  // the warp's running start of the digit past them
  if (one < 0) {  // a tile of one digit needs no ranking
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const bool active = wbase + j * 32 + lane < n;
      const int d = (int)((key[j] >> shift) & dmask);
      unsigned peers = __ballot_sync(0xffffffffu, active);
      if (!active) peers = ~peers;  // inactive lanes rank among themselves
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        if (b < width) {
          const bool bit = (d >> b) & 1;
          const unsigned v = __ballot_sync(0xffffffffu, bit);
          peers &= bit ? v : ~v;
        }
      }
      const int leader = __ffs(peers) - 1;
      int before = 0;
      if (active && lane == leader) {
        before = wcnt[warp][d];
        wcnt[warp][d] = before + __popc(peers);
      }
      const int pos = __shfl_sync(0xffffffffu, before, leader) + __popc(peers & below);
      if (active) {
        skeys[pos] = key[j];
        svals[pos] = val[j];
      }
      __syncwarp();
    }
  }

  // decoupled look-back: add the earlier tiles' counts of d, two status
  // words a step, until one holds its inclusive prefix
  i64 excl = 0;
  if (tile > 0) {
    bool done = false;
    for (i64 t = tile - 1; !done; t -= OS_LOOKBACK) {
      uint64_t s[OS_LOOKBACK];
#pragma unroll
      for (int q = 0; q < OS_LOOKBACK; ++q)
        s[q] = t - q >= 0 ? *(const volatile uint64_t*)(status + (t - q) * OS_RADIX + tid) : 0ull;
#pragma unroll
      for (int q = 0; q < OS_LOOKBACK; ++q) {
        if (!done) {  // tile 0 is inclusive: the walk ends there at the latest
          while (((s[q] >> OS_TAG_SHIFT) & OS_TAG_MASK) != tag)
            s[q] = *(const volatile uint64_t*)(status + (t - q) * OS_RADIX + tid);
          excl += (i64)(s[q] & OS_COUNT_MASK);
          done = (s[q] & OS_INCLUSIVE) != 0;
        }
      }
    }
    *mine = OS_INCLUSIVE | tagged | (uint64_t)(excl + total);
  }
  dst[tid] = (int)(start + excl) - tile_start;
  __syncthreads();

  // out in runs: consecutive threads, consecutive addresses of a digit (a
  // tile whose rows all share the digit keeps its order: read again, from
  // the cache, without the ranking and the copy in shared memory)
  if (one >= 0) {
#pragma unroll 4
    for (int j = 0; j < ITEMS; ++j) {
      const i64 i = first + j * OS_BLOCK + tid;
      if (i < n) {
        const int32_t v = vals_in != nullptr ? __ldg(vals_in + i) : (int32_t)i;
        const i64 dest = (i64)dst[one] + (i - first);
        if (keys_out != nullptr) keys_out[dest] = keys_in[GATHER ? v : i];
        vals_out[dest] = v;
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = j * OS_BLOCK + tid;
    if (i < valid) {
      const K k = skeys[i];
      const i64 dest = (i64)dst[(int)((k >> shift) & dmask)] + i;
      if (keys_out != nullptr) keys_out[dest] = k;
      vals_out[dest] = svals[i];
    }
  }
}

// Dynamic shared memory of a pass over keys of type K: the tile's keys and
// row ids.
template <class K>
constexpr int os_pass_smem() {
  return OS_BLOCK * OneSweepItems<K>::value * (int)(sizeof(K) + sizeof(int32_t));
}

// The sort's scratch: the zeroed part first (digit counts, tile counters,
// look-back status), then ping-pong keys and row ids and the chunks past
// the first.
struct OneSweepScratch {
  int32_t* hist;
  int* counters;
  uint64_t* status;
  void *keys_a, *keys_b;
  int32_t *vals_a, *vals_b;
  void* chunks;
  i64 zero_bytes, bytes;
};

inline i64 os_align(i64 b) { return (b + 255) / 256 * 256; }

inline int os_tile_rows(int key_bytes) {
  return OS_BLOCK * (key_bytes == 4 ? OneSweepItems<uint32_t>::value
                                    : OneSweepItems<uint64_t>::value);
}

// The layout over `base` (nullptr: sizes only) for n rows, `bits` varying
// bits and `passes` digit passes.
inline int os_key_bytes(int bits) { return bits > 32 && bits <= 64 ? 8 : 4; }

inline OneSweepScratch onesweep_carve(char* base, i64 n, int bits, int passes) {
  const int key_bytes = os_key_bytes(bits);
  const i64 chunks = (bits + 8 * key_bytes - 1) / (8 * key_bytes);
  const i64 tiles = (n + os_tile_rows(key_bytes) - 1) / os_tile_rows(key_bytes);
  OneSweepScratch s;
  i64 off = 0;
  auto take = [&](i64 bytes) {
    char* p = base == nullptr ? nullptr : base + off;
    off += os_align(bytes);
    return p;
  };
  s.hist = (int32_t*)take((i64)passes * OS_RADIX * 4);
  s.counters = (int*)take((i64)passes * 4);
  s.status = (uint64_t*)take(tiles * OS_RADIX * 8);
  s.zero_bytes = off;
  s.keys_a = take(n * key_bytes);
  s.keys_b = take(n * key_bytes);
  s.vals_a = (int32_t*)take(n * 4);
  s.vals_b = (int32_t*)take(n * 4);
  s.chunks = take((chunks > 1 ? chunks - 1 : 0) * n * key_bytes);
  s.bytes = off;
  return s;
}

}  // namespace
}  // namespace dfp
