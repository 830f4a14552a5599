// K3 probe_expand: candidate ranges of the probe rows, and the candidates
// themselves with the key recheck.
//
// Replaces the JAX package's `probe_ranges` / `probe_candidates` (CSR
// branch, ops/hash_table.py:247-288), `replicate_rows_exact`
// (utils/columnar.py:650-680) and the deferred join body's candidate fetch
// and key recheck (ops/join.py:277-320).
//
// Bound on the H100: random access. Pass 1 reads each probe row's bucket
// descriptor from a table of T+2 offsets (537 MB at T = 2^27, past the
// 50 MB L2); pass 2 reads the build's narrow words at one random position
// per candidate. The JAX package replicates probe rows with a scatter-max
// and a cummax over the output; here no replicated matrix is written:
//
//   pass 1, one launch: a block takes the next tile of RANGE_TILE probe
//           rows, reads start = offsets[s] and the next offset (one 8-byte
//           neighbourhood: count = offsets[s+1] - offsets[s], 0 for a row
//           out of range or with a null key), scans the counts in shared
//           memory and takes the tile's offset by decoupled look-back
//           (scan.cuh): start, count, base = the exclusive sum of count,
//           and the total in int64 (the JAX int32 cumsum would wrap past
//           2^31; the wrapper raises);
//   pass 2, one thread per output slot j < min(total, out_cap): probe row
//           i = the last row with base[i] <= j, found by a binary search
//           over the bases (a search a run of slots, with the run's rows
//           marked in shared memory and a block max-scan, measured slower
//           on the H100: the slot's build-word reads bound the pass, and
//           the run's serial phases cost more than the searches, PERF.md);
//           pos = start[i] + j - base[i]; match = key words equal and both
//           validity bits set. Slots past min(total, out_cap) read match =
//           0, probe_idx = build_id = 0.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

using dfp::i64;

constexpr int MAX_EQ = 8;     // key words compared (4 keys x 2 words)
constexpr int MAX_KEYS = 4;
constexpr int RANGE_BLOCK = 256;
constexpr int RANGE_ITEMS = 16;
constexpr int RANGE_TILE = RANGE_BLOCK * RANGE_ITEMS;   // probe rows a pass-1 block takes

inline i64 range_tiles(i64 m) { return (m + RANGE_TILE - 1) / RANGE_TILE; }

// The key-recheck plan (ops/join.py `_defer_key_plan`): word rows to compare
// and, per key column, the validity word row and bit on each side.
struct KeySpec {
  int n_eq;
  int eq_b[MAX_EQ];
  int eq_p[MAX_EQ];
  int n_keys;
  int vb_row[MAX_KEYS];
  int vb_bit[MAX_KEYS];
  int vp_row[MAX_KEYS];
  int vp_bit[MAX_KEYS];
};

__global__ void __launch_bounds__(RANGE_BLOCK) probe_ranges_kernel(
    const int32_t* __restrict__ slot, const uint8_t* __restrict__ ok, i64 m,
    const int32_t* __restrict__ offsets, uint64_t* status, i64 tiles,
    int32_t* __restrict__ start, int32_t* __restrict__ count, int32_t* __restrict__ base,
    i64* __restrict__ total) {
  __shared__ int32_t cnt[RANGE_TILE + RANGE_TILE / 16];
  __shared__ i64 smem[33];
  __shared__ i64 prefix;
  __shared__ int tile_sh;
  const int tid = threadIdx.x;
  const i64 tile = dfp::lookback_tile(status, tiles, &tile_sh);
  const i64 first = tile * RANGE_TILE;
  // every descriptor read of the tile in flight at once, rows striped
  int32_t s[RANGE_ITEMS];
  bool valid[RANGE_ITEMS];
#pragma unroll
  for (int k = 0; k < RANGE_ITEMS; ++k) {
    const i64 i = first + k * RANGE_BLOCK + tid;
    s[k] = i < m ? __ldg(slot + i) : 0;
    valid[k] = i < m && __ldg(ok + i) != 0;
  }
  int32_t lo[RANGE_ITEMS], hi[RANGE_ITEMS];
#pragma unroll
  for (int k = 0; k < RANGE_ITEMS; ++k) {
    const i64 i = first + k * RANGE_BLOCK + tid;
    lo[k] = i < m ? __ldg(offsets + s[k]) : 0;
    hi[k] = valid[k] ? __ldg(offsets + s[k] + 1) : lo[k];
  }
#pragma unroll
  for (int k = 0; k < RANGE_ITEMS; ++k) {
    const int j = k * RANGE_BLOCK + tid;
    const int32_t c = hi[k] - lo[k];
    cnt[dfp::scan_pad(j)] = c;
    if (first + j < m) {
      start[first + j] = lo[k];
      count[first + j] = c;
    }
  }
  __syncthreads();
  // thread tid: rows tid * 16 .. +16 of the tile, in order
  i64 sum = 0;
#pragma unroll
  for (int k = 0; k < RANGE_ITEMS; ++k) sum += cnt[dfp::scan_pad(tid * RANGE_ITEMS + k)];
  i64 agg;
  const i64 ex = dfp::block_exclusive_scan(sum, smem, &agg);
  const i64 excl = dfp::lookback_prefix(status, tile, agg, &prefix);
  i64 run = excl + ex;
#pragma unroll
  for (int k = 0; k < RANGE_ITEMS; ++k) {
    const int j = dfp::scan_pad(tid * RANGE_ITEMS + k);
    const int32_t c = cnt[j];
    cnt[j] = (int32_t)run;
    run += c;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < RANGE_ITEMS; ++k) {
    const int j = k * RANGE_BLOCK + tid;
    if (first + j < m) base[first + j] = cnt[dfp::scan_pad(j)];
  }
  if (tile == tiles - 1 && tid == 0) *total = excl + agg;
}

__global__ void probe_expand_kernel(const int32_t* __restrict__ start,
                                    const int32_t* __restrict__ base,
                                    const i64* __restrict__ total, i64 m,
                                    const int32_t* __restrict__ pwords, i64 p_stride,
                                    const int32_t* __restrict__ bwords, i64 b_stride,
                                    int n_bwords, KeySpec spec, i64 out_cap,
                                    bool and_match, uint8_t* __restrict__ match,
                                    int32_t* __restrict__ probe_idx,
                                    int32_t* __restrict__ build_id) {
  const i64 j = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= out_cap) return;
  const i64 t = *total;
  if (j >= t) {  // j < out_cap already
    match[j] = 0;
    probe_idx[j] = 0;
    build_id[j] = 0;
    return;
  }
  // the last probe row whose base is <= j owns slot j (base[0] == 0)
  i64 lo = 0, hi = m;
  while (hi - lo > 1) {
    const i64 mid = (lo + hi) >> 1;
    if ((i64)base[mid] <= j) lo = mid; else hi = mid;
  }
  const i64 i = lo;
  const i64 pos = (i64)start[i] + (j - (i64)base[i]);
  bool eq = true;
  for (int k = 0; k < spec.n_eq; ++k)
    eq = eq && bwords[(i64)spec.eq_b[k] * b_stride + pos] == pwords[(i64)spec.eq_p[k] * p_stride + i];
  for (int k = 0; k < spec.n_keys; ++k) {
    const uint32_t bw = (uint32_t)bwords[(i64)spec.vb_row[k] * b_stride + pos];
    const uint32_t pw = (uint32_t)pwords[(i64)spec.vp_row[k] * p_stride + i];
    eq = eq && ((bw >> spec.vb_bit[k]) & 1u) && ((pw >> spec.vp_bit[k]) & 1u);
  }
  if (and_match) {  // a later group of the key's columns: probe_idx, build_id are set
    match[j] = (match[j] && eq) ? 1 : 0;
    return;
  }
  match[j] = eq ? 1 : 0;
  probe_idx[j] = (int32_t)i;
  build_id[j] = bwords[(i64)(n_bwords - 1) * b_stride + pos];
}

}  // namespace

// Pass 1 with its scan: slot [m] in [0, T], offsets [T+2] (the table's),
// ok [m] as bytes; start, count, base [m] int32, total64 a device int64;
// scratch: the look-back's status words and tile counter, 8 bytes a tile
// of RANGE_TILE rows and 8 more (kernels/probe_expand.py `range_tiles`).
extern "C" int dfp_probe_ranges(const void* slot, const void* ok, long long m,
                                const void* offsets, void* start, void* count, void* base,
                                void* total64, void* scratch, long long scratch_bytes,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const i64 tiles = range_tiles(m);
  if (m <= 0 || scratch_bytes < dfp::lookback_scratch_bytes(tiles))
    return (int)cudaErrorInvalidValue;
  cudaMemsetAsync(scratch, 0, (size_t)dfp::lookback_scratch_bytes(tiles), st);
  probe_ranges_kernel<<<(unsigned)tiles, RANGE_BLOCK, 0, st>>>(
      (const int32_t*)slot, (const uint8_t*)ok, m, (const int32_t*)offsets, (uint64_t*)scratch,
      tiles, (int32_t*)start, (int32_t*)count, (int32_t*)base, (i64*)total64);
  return (int)cudaGetLastError();
}

// Pass 2. pwords [*, p_stride] are the probe's narrow words; bwords
// [n_bwords, b_stride] the build's narrow words in perm order, the last row
// the build row id. spec is a host array laid out as KeySpec. A key past
// the spec's 4 columns or 8 words runs as several launches, the later ones
// with and_match set: they AND their recheck into match and leave
// probe_idx and build_id as the first launch wrote them.
extern "C" int dfp_probe_expand(const void* start, const void* base, const void* total64,
                                long long m, const void* pwords, long long p_stride,
                                const void* bwords, long long b_stride, int n_bwords,
                                const int* spec, long long out_cap, int and_match, void* match,
                                void* probe_idx, void* build_id, void* stream) {
  KeySpec ks = *(const KeySpec*)spec;
  if (ks.n_eq > MAX_EQ || ks.n_keys > MAX_KEYS || m <= 0) return (int)cudaErrorInvalidValue;
  if (out_cap > 0) {
    probe_expand_kernel<<<dfp::grid_for(out_cap, 256), 256, 0, (cudaStream_t)stream>>>(
        (const int32_t*)start, (const int32_t*)base, (const i64*)total64, m,
        (const int32_t*)pwords, p_stride, (const int32_t*)bwords, b_stride, n_bwords, ks,
        out_cap, and_match != 0, (uint8_t*)match, (int32_t*)probe_idx, (int32_t*)build_id);
  }
  return (int)cudaGetLastError();
}
