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
//   pass 2, a block a tile of EX_TILE output slots: slot j's probe row i
//           is the last row with base[i] <= j. A launch before it finds the
//           row owning each tile's first slot (a binary search a tile, all
//           tiles at once); a block loads the bases of its rows into shared
//           memory, each non-empty row marks the slot it starts and a block
//           max-scan carries the marks on, so no slot searches (past
//           EX_WINDOW rows, a tile of mostly empty rows, each slot
//           binary-searches its rows in place). pos = start[i] + j -
//           base[i]; the candidate's build row is read in one go: the
//           deferred join's K2 writes its key words and row id row-major,
//           padded to 4 or 8 words (one or two 16-byte loads in one
//           32-byte sector; word-major rows, as SORT's, OA's and a
//           prepared build's, cost a sector a word), four slots a thread
//           with all their rows in flight; match = key words equal and the
//           plan's validity bits set (a key may name no build validity
//           row: every table holds only rows whose keys are valid, K1
//           sends the rest to slot T). Slots past min(total, out_cap),
//           read on the card, are match = 0, probe_idx = build_id = 0: a
//           block past them writes its slots' zeros four a thread and
//           leaves. Measured on an H100 80GB HBM3 at 700 W (PERF.md): at a
//           Q7-shaped call 1.548 ms (PR 10's pass: a binary search over
//           every base a slot, then three word-major reads) -> 0.92; a
//           search a slot over the tile's bases 1.03; the tile's ends
//           searched inside each block 0.97.

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
// and, per key column, the validity word row and bit on each side (a build
// row below 0: no build-side test).
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

constexpr int EX_BLOCK = 256;
constexpr int EX_ITEMS = 4;                    // slots a thread, 256 apart
constexpr int EX_TILE = EX_BLOCK * EX_ITEMS;   // slots a second-pass block takes
constexpr int EX_WINDOW = 4 * EX_TILE;         // bases a block holds in shared memory

inline i64 ex_tiles(i64 out_cap) { return (out_cap + EX_TILE - 1) / EX_TILE; }

// Word `k` of a candidate's row held in registers: a select over the
// row's words, so that a runtime index does not put the row in local memory
template <int RW>
__device__ __forceinline__ int32_t word_of(const int32_t (&w)[RW], int k) {
  int32_t r = w[0];
#pragma unroll
  for (int q = 1; q < RW; ++q) r = k == q ? w[q] : r;
  return r;
}

// rows[q] = the row owning slot q * EX_TILE (the last row whose base is <=
// it; base[0] == 0) for the tiles below min(total, out_cap), and
// rows[tiles] = the row owning their last slot: a binary search a thread,
// all of them in one launch
__global__ void tile_rows_kernel(const int32_t* __restrict__ base, i64 m,
                                 const i64* __restrict__ total, i64 out_cap,
                                 int32_t* __restrict__ rows) {
  const i64 t0 = *total;
  const i64 k = t0 < out_cap ? t0 : out_cap;
  const i64 tiles = (k + EX_TILE - 1) / EX_TILE;
  const i64 q = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (q > tiles || k == 0) return;
  const i64 target = q < tiles ? q * EX_TILE : k - 1;
  i64 lo = 0, hi = m;
  while (hi - lo > 1) {
    const i64 mid = (lo + hi) >> 1;
    if ((i64)__ldg(base + mid) <= target) lo = mid; else hi = mid;
  }
  rows[q] = (int32_t)lo;
}

// Second pass, one block a tile of EX_TILE slots (slot j of thread t:
// j0 + 256 u + t). RW: the build rows' layout, 4 or 8 for row-major rows
// of that many words (one or two 16-byte loads a candidate), 0 for any
// other stride (a load a word).
template <int RW>
__global__ void __launch_bounds__(EX_BLOCK) probe_expand_kernel(
    const int32_t* __restrict__ start, const int32_t* __restrict__ base,
    const i64* __restrict__ total, i64 m, const int32_t* __restrict__ tile_rows,
    const int32_t* __restrict__ pwords, i64 p_stride, const int32_t* __restrict__ bwords,
    i64 b_wstride, i64 b_rstride, int n_bwords, KeySpec spec, i64 out_cap,
    bool and_match, uint8_t* __restrict__ match, int32_t* __restrict__ probe_idx,
    int32_t* __restrict__ build_id) {
  constexpr int NW = RW > 0 ? RW : 1, IT = EX_ITEMS, TILE = EX_TILE;
  __shared__ int32_t wbase[EX_WINDOW];
  __shared__ int32_t owner[TILE];  // each slot's row, from i0
  __shared__ i64 scan_sm[33];
  __shared__ i64 ends[2];
  const int tid = threadIdx.x;
  const i64 t0 = *total;
  const i64 t = t0 < out_cap ? t0 : out_cap;
  const i64 j0 = (i64)blockIdx.x * TILE;
  if (j0 >= t) {  // the zero tail: IT slots a thread, whole sectors a warp
    if (and_match) return;
#pragma unroll
    for (int v = 0; v < IT / 4; ++v) {
      const i64 e = j0 + 4 * (v * EX_BLOCK + tid);
      if (e + 4 <= out_cap) {
        *(uint32_t*)(match + e) = 0u;
        *(int4*)(probe_idx + e) = make_int4(0, 0, 0, 0);
        *(int4*)(build_id + e) = make_int4(0, 0, 0, 0);
      } else {
        for (i64 j = e; j < e + 4 && j < out_cap; ++j) {
          match[j] = 0;
          probe_idx[j] = 0;
          build_id[j] = 0;
        }
      }
    }
    return;
  }
  const i64 j1 = (j0 + TILE < t ? j0 + TILE : t) - 1;  // the tile's last candidate
  // the rows owning j0 and the next tile's first slot (or j1, the last
  // tile's), from tile_rows_kernel: every slot of the tile belongs to a row
  // between them
  if (tid < 2) ends[tid] = tile_rows[blockIdx.x + tid];
  __syncthreads();
  const i64 i0 = ends[0];
  const i64 nw = ends[1] - i0 + 1;
  // the tile's bases in shared memory, else (past EX_WINDOW rows, many
  // of them without candidates) read in place by a search a slot
  const bool held = nw <= EX_WINDOW;
  if (held)
    for (i64 k = tid; k < nw; k += EX_BLOCK) wbase[k] = __ldg(base + i0 + k);
  __syncthreads();
  auto base_at = [&](i64 k) -> i64 { return held ? wbase[k] : (i64)__ldg(base + i0 + k); };
  if (held) {
    // a row after i0 has its base past j0: each non-empty one inside the
    // tile marks the slot it starts, a max-scan carries the marks on
    for (int q = tid; q < TILE; q += EX_BLOCK) owner[q] = 0;
    __syncthreads();
    for (i64 k = 1 + tid; k < nw; k += EX_BLOCK) {
      const i64 b = base_at(k);
      if ((k + 1 == nw || base_at(k + 1) > b) && b - j0 < TILE) owner[b - j0] = (int32_t)k;
    }
    __syncthreads();
    int32_t run = owner[IT * tid];
#pragma unroll
    for (int q = 1; q < IT; ++q) run = owner[IT * tid + q] > run ? owner[IT * tid + q] : run;
    i64 unused;
    i64 carry = dfp::block_exclusive_max(run, scan_sm, &unused);
#pragma unroll
    for (int q = 0; q < IT; ++q) {
      carry = owner[IT * tid + q] > carry ? owner[IT * tid + q] : carry;
      owner[IT * tid + q] = (int32_t)carry;
    }
    __syncthreads();
  }

  i64 row[IT], pos[IT];
  bool live[IT];
#pragma unroll
  for (int u = 0; u < IT; ++u) {
    const i64 j = j0 + u * EX_BLOCK + tid;
    live[u] = j <= j1;
    row[u] = pos[u] = 0;
    if (!live[u]) continue;
    i64 lo = 0, hi = nw;
    if (held) lo = owner[j - j0], hi = lo + 1;
    while (hi - lo > 1) {
      const i64 mid = (lo + hi) >> 1;
      if (base_at(mid) <= j) lo = mid; else hi = mid;
    }
    row[u] = i0 + lo;
    pos[u] = (i64)__ldg(start + row[u]) + (j - base_at(lo));
  }
  // every candidate's row in flight before any is compared
  int32_t w[IT][NW];
#pragma unroll
  for (int u = 0; u < IT; ++u) {
    if (RW == 0 || !live[u]) continue;
    const int4* src = (const int4*)(bwords + pos[u] * RW);
#pragma unroll
    for (int q = 0; q < NW / 4; ++q) {
      const int4 v = __ldg(src + q);
      w[u][4 * q] = v.x, w[u][4 * q + 1] = v.y, w[u][4 * q + 2] = v.z, w[u][4 * q + 3] = v.w;
    }
  }
#pragma unroll
  for (int u = 0; u < IT; ++u) {
    const i64 j = j0 + u * EX_BLOCK + tid;
    if (j >= out_cap) continue;
    if (!live[u]) {  // past the candidates inside the last tile
      if (and_match) continue;
      match[j] = 0;
      probe_idx[j] = 0;
      build_id[j] = 0;
      continue;
    }
    const i64 i = row[u];
    auto bw = [&](int k) -> int32_t {
      if constexpr (RW > 0) return word_of<NW>(w[u], k);
      else return __ldg(bwords + (i64)k * b_wstride + pos[u] * b_rstride);
    };
    bool eq = true;
    for (int k = 0; k < spec.n_eq; ++k)
      eq = eq && bw(spec.eq_b[k]) == __ldg(pwords + (i64)spec.eq_p[k] * p_stride + i);
    for (int k = 0; k < spec.n_keys; ++k) {
      const uint32_t p = (uint32_t)__ldg(pwords + (i64)spec.vp_row[k] * p_stride + i);
      eq = eq && ((p >> spec.vp_bit[k]) & 1u);
      if (spec.vb_row[k] >= 0)
        eq = eq && (((uint32_t)bw(spec.vb_row[k]) >> spec.vb_bit[k]) & 1u);
    }
    if (and_match) {  // a later group of the key's columns: probe_idx, build_id are set
      match[j] = (match[j] && eq) ? 1 : 0;
      continue;
    }
    match[j] = eq ? 1 : 0;
    probe_idx[j] = (int32_t)i;
    build_id[j] = bw(n_bwords - 1);
  }
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

// Pass 2. pwords [*, p_stride] are the probe's narrow words; bwords the
// build's narrow words in table order, n_bwords words a row, the last the
// build row id: word k of row r at bwords[k * b_wstride + r * b_rstride]
// (word-major: b_wstride = the row count, b_rstride = 1; row-major:
// b_wstride = 1, b_rstride = 4 or 8, 16-byte aligned, one or two vector
// loads a row). spec is a host array laid out as KeySpec. A key past the
// spec's 4 columns or 8 words runs as several launches, the later ones
// with and_match set: they AND their recheck into match and leave
// probe_idx and build_id as the first launch wrote them.
// the rows owning the tiles' first slots, and the last tile's last
extern "C" long long dfp_probe_expand_scratch_bytes(long long out_cap) {
  return (ex_tiles(out_cap) + 1) * 4;
}

extern "C" int dfp_probe_expand(const void* start, const void* base, const void* total64,
                                long long m, const void* pwords, long long p_stride,
                                const void* bwords, long long b_wstride, long long b_rstride,
                                int n_bwords, const int* spec, long long out_cap,
                                int and_match, void* match, void* probe_idx,
                                void* build_id, void* scratch, long long scratch_bytes,
                                void* stream) {
  KeySpec ks = *(const KeySpec*)spec;
  if (ks.n_eq > MAX_EQ || ks.n_keys > MAX_KEYS || m <= 0 || n_bwords < 1 ||
      scratch_bytes < dfp_probe_expand_scratch_bytes(out_cap))
    return (int)cudaErrorInvalidValue;
  const int rw = b_wstride == 1 && (b_rstride == 4 || b_rstride == 8) &&
                         ((uintptr_t)bwords & 15) == 0 && n_bwords <= b_rstride
                     ? (int)b_rstride
                     : 0;
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* rows = (int32_t*)scratch;
  if (out_cap > 0) {
    tile_rows_kernel<<<dfp::grid_for(ex_tiles(out_cap) + 1, 256), 256, 0, st>>>(
        (const int32_t*)base, m, (const i64*)total64, out_cap, rows);
#define PE_LAUNCH(RW)                                                                      \
  probe_expand_kernel<RW><<<(unsigned)ex_tiles(out_cap), EX_BLOCK, 0, st>>>(               \
      (const int32_t*)start, (const int32_t*)base, (const i64*)total64, m, rows,           \
      (const int32_t*)pwords, p_stride, (const int32_t*)bwords, b_wstride, b_rstride,      \
      n_bwords, ks, out_cap, and_match != 0, (uint8_t*)match, (int32_t*)probe_idx,         \
      (int32_t*)build_id)
    if (rw == 4)
      PE_LAUNCH(4);
    else if (rw == 8)
      PE_LAUNCH(8);
    else
      PE_LAUNCH(0);
#undef PE_LAUNCH
  }
  return (int)cudaGetLastError();
}
