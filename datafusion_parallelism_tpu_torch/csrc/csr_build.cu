// K2 csr_build: the CSR hash table of the build side, and its narrow key
// rows in bucket order.
//
// Replaces the JAX package's `build_csr` (ops/hash_table.py:110-126: bucket
// counts by scatter-add, offsets by cumsum, perm = stable argsort by slot,
// start_count = [offsets[:-1]; counts]) and the deferred join's narrow
// permute (ops/join.py:301-306: key words + validity word + row id gathered
// into perm order).
//
// Bound on the H100: memory traffic and, under skew, atomic contention. A
// scatter with atomic cursors would be cheap but not stable, and the perm
// must equal a stable argsort bit for bit. Bucket T holds every null and
// padding row (half the table when it is padded to twice its rows) and a
// hot key puts a large share of the rows into one bucket, so sorting each
// bucket after an atomic scatter would be quadratic exactly there. The
// design is therefore:
//   * counts: one atomic per run of equal slots in a warp (__match_any_sync
//     aggregates them), so a hot bucket costs n/32 atomics, not n;
//   * offsets: the shared device-wide exclusive scan (scan.cuh);
//   * perm: a stable LSD radix sort over the slot bits, 8 bits a pass,
//     ceil(bits(T)/8) passes. Each pass counts digits per 4096-row tile,
//     scans the counts digit-major across tiles, and scatters stably: the
//     rank inside a warp comes from __match_any_sync + __popc, and a
//     shared-memory prefix over the 8 warps orders the warps. Linear in
//     the rows whatever the key distribution;
//   * the last pass writes perm and scatters the narrow rows (plus the row
//     id) straight to their bucket-order position.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

using dfp::i64;

constexpr int RADIX = 256;
constexpr int SORT_BLOCK = 256;  // == RADIX: thread d owns digit d in the warp prefix
constexpr int SORT_WARPS = SORT_BLOCK / 32;
constexpr int SORT_CHUNKS = 16;
constexpr int SORT_TILE = SORT_BLOCK * SORT_CHUNKS;

__global__ void bucket_count_kernel(const int32_t* __restrict__ slot, i64 n,
                                    int32_t* __restrict__ counts) {
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n;
  const int s = active ? slot[i] : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, s);
  if (active && (int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&counts[s], __popc(peers));
}

// hist[d * n_tiles + tile] = rows of the tile whose digit is d
__global__ void radix_hist_kernel(const int32_t* __restrict__ keys, i64 n, int shift,
                                  i64 n_tiles, int32_t* __restrict__ hist) {
  __shared__ int cnt[RADIX];
  cnt[threadIdx.x] = 0;
  __syncthreads();
  const i64 base = (i64)blockIdx.x * SORT_TILE;
  for (int c = 0; c < SORT_CHUNKS; ++c) {
    const i64 i = base + (i64)c * SORT_BLOCK + threadIdx.x;
    const bool active = i < n;
    const int d = active ? (keys[i] >> shift) & (RADIX - 1) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (active && (int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&cnt[d], __popc(peers));
  }
  __syncthreads();
  hist[(i64)threadIdx.x * n_tiles + blockIdx.x] = cnt[threadIdx.x];
}

// Stable scatter of one tile by digit. `offsets` is the exclusive scan of
// the digit-major histogram. vals_in == nullptr means the row id. On the
// last pass rows_out receives rows[:, val] and the row id at each slot.
__global__ void radix_scatter_kernel(const int32_t* __restrict__ keys_in,
                                     const int32_t* __restrict__ vals_in, i64 n, int shift,
                                     i64 n_tiles, const int32_t* __restrict__ offsets,
                                     int32_t* __restrict__ keys_out,
                                     int32_t* __restrict__ vals_out,
                                     const int32_t* __restrict__ rows, int n_rows,
                                     int32_t* __restrict__ rows_out) {
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
    const int key = active ? keys_in[i] : 0;
    const int val = active ? (vals_in != nullptr ? vals_in[i] : (int)i) : 0;
    // inactive lanes share a digit no real row has
    const int d = active ? (key >> shift) & (RADIX - 1) : RADIX;
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
      if (keys_out != nullptr) keys_out[dest] = key;
      vals_out[dest] = val;
      if (rows_out != nullptr) {
        for (int r = 0; r < n_rows; ++r) rows_out[(i64)r * n + dest] = rows[(i64)r * n + val];
        rows_out[(i64)n_rows * n + dest] = val;
      }
    }
    __syncthreads();
  }
}

struct Scratch {
  int32_t *keys_a, *keys_b, *vals_a, *vals_b, *hist;
  void* scan;
  i64* total;
  i64 bytes;
};

i64 align256(i64 b) { return (b + 255) / 256 * 256; }

Scratch carve(char* base, i64 n, i64 T) {
  const i64 n_tiles = (n + SORT_TILE - 1) / SORT_TILE;
  const i64 hist_n = RADIX * n_tiles;
  const i64 scan_n = hist_n > T + 2 ? hist_n : T + 2;
  Scratch s;
  i64 off = 0;
  // base == nullptr only sizes the layout
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
  s.scan = take(dfp::scan_scratch_bytes(scan_n));
  s.total = (i64*)take(8);
  s.bytes = off;
  return s;
}

}  // namespace

extern "C" long long dfp_csr_build_scratch_bytes(long long n, long long T) {
  return carve(nullptr, n, T).bytes;
}

// slot [n] in [0, T] (T = nulls and padding); rows [n_rows, n] narrow words.
// Out: counts [T+2] (the last entry stays 0), offsets [T+2], perm [n],
// start_count [2, T+1], rows_out [n_rows + 1, n] in perm order, the last
// row the row id.
extern "C" int dfp_csr_build(const void* slot, long long n, long long T, const void* rows,
                             int n_rows, void* counts, void* offsets, void* perm,
                             void* start_count, void* rows_out, void* scratch,
                             long long scratch_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Scratch s = carve((char*)scratch, n, T);
  if (scratch_bytes < s.bytes) return (int)cudaErrorInvalidValue;
  int32_t* cnt = (int32_t*)counts;
  int32_t* off = (int32_t*)offsets;
  cudaMemsetAsync(cnt, 0, (size_t)(T + 2) * 4, st);
  if (n > 0) bucket_count_kernel<<<dfp::grid_for(n, 256), 256, 0, st>>>((const int32_t*)slot, n, cnt);
  dfp::exclusive_scan<int32_t, int32_t>(cnt, T + 2, off, s.total, s.scan, st);
  cudaMemcpyAsync(start_count, off, (size_t)(T + 1) * 4, cudaMemcpyDeviceToDevice, st);
  cudaMemcpyAsync((int32_t*)start_count + (T + 1), cnt, (size_t)(T + 1) * 4,
                  cudaMemcpyDeviceToDevice, st);

  int bits = 0;
  while ((1LL << bits) <= T) ++bits;  // the largest key is T
  const int passes = (bits + 7) / 8;
  const i64 n_tiles = (n + SORT_TILE - 1) / SORT_TILE;
  const int32_t* kin = (const int32_t*)slot;
  const int32_t* vin = nullptr;
  for (int p = 0; p < passes && n_tiles > 0; ++p) {
    const bool last = p == passes - 1;
    int32_t* kout = last ? nullptr : (p % 2 == 0 ? s.keys_a : s.keys_b);
    int32_t* vout = last ? (int32_t*)perm : (p % 2 == 0 ? s.vals_a : s.vals_b);
    radix_hist_kernel<<<(unsigned)n_tiles, SORT_BLOCK, 0, st>>>(kin, n, 8 * p, n_tiles, s.hist);
    dfp::exclusive_scan<int32_t, int32_t>(s.hist, RADIX * n_tiles, s.hist, s.total, s.scan, st);
    radix_scatter_kernel<<<(unsigned)n_tiles, SORT_BLOCK, 0, st>>>(
        kin, vin, n, 8 * p, n_tiles, s.hist, kout, vout, (const int32_t*)rows, n_rows,
        last ? (int32_t*)rows_out : nullptr);
    kin = kout;
    vin = vout;
  }
  return (int)cudaGetLastError();
}
