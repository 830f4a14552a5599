// K2 csr_build: the CSR hash table of the build side, and its narrow key
// rows in bucket order.
//
// Replaces the JAX package's `build_csr` (ops/hash_table.py:110-126: bucket
// counts by scatter-add, offsets by cumsum, perm = stable argsort by slot,
// start_count = [offsets[:-1]; counts]) and the deferred join's narrow
// permute (ops/join.py:301-306: key words + validity word + row id gathered
// into perm order).
//
// Bound on the H100: memory traffic. The table has T + 1 = 4 x capacity + 1
// buckets (ops/hash_table.py `table_size_for`), so its three T-sized
// outputs (offsets, start_count's two rows) are 12 bytes a bucket, 48 a
// build row, against 8 bytes a row for the sort's keys and row ids per
// pass. The perm must equal a stable argsort bit for bit, and bucket T
// holds every null and padding row (half a table padded to twice its rows)
// while a hot key puts a large share of the rows into one bucket, so the
// sort is a stable LSD radix sort, linear whatever the keys. The design:
//   * the padding first: bucket T's rows (nulls and a capacity-padded
//     table's padding, 90% of the rows of Q9's first build) need no sort:
//     a stable partition (one read of the slots, the offsets by decoupled
//     look-back) puts the other rows' (slot, row id) ahead and writes
//     bucket T's row ids straight to the end of the perm, in order; their
//     count stays on the device;
//   * the sort: the one-sweep pass of K6 (onesweep.cuh) over the 32-bit
//     bucket ids of those rows only, bits(T) bits in digits of at most 8
//     (kernels/csr_build.py `digit_passes`): one read of the keys a pass,
//     the digit offsets by decoupled look-back, each pass counting the
//     next digit; the first digit's counts and the row count come from
//     one read of the slots before it; the grid covers n rows and the
//     blocks past the count return;
//   * the last pass writes the row ids (perm, the last row of rows_out);
//     a gather then reads the narrow rows through perm, four output rows a
//     thread (K5's WORD4 layout): one random read a row and word,
//     coalesced writes. (Scattering them from inside the last pass, as
//     the pass writes each row id, measured slower on the H100: its reads
//     wait on the pass's writes, tools/bench_csr_join.py --explore);
//   * on request the gather writes the rows row-major instead, each row's
//     words and its row id padded to 4 or 8 words (16 or 32 bytes, one
//     aligned unit), perm then a buffer of its own: the deferred join's
//     recheck (K3's second pass) reads a candidate's words in one load,
//     where a word-major row costs a 32-byte sector a word;
//   * the T side: the last pass also writes its sorted
//     keys (the padding's, T, implied past the count); a fill writes every
//     bucket's offset, start and count once and reads nothing T-sized: a
//     block a tile of FILL_TILE buckets (so a long gap between two
//     neighbouring keys, e.g. a sparse build, is split across the tiles
//     it spans), the tile's first key position from one binary search a
//     tile, then its buckets' counts from the run boundaries of its keys
//     (or, past FILL_SCAN_KEYS keys, a hot bucket's tile, each bucket's
//     end by a search: a binary search a thread, then a gallop a bucket).
//     Counting into the counts by atomics, then one look-back scan over
//     them, measured slower at every shape (tools/bench_csr_join.py,
//     PERF.md).
// counts is start_count's second row and perm (word-major) rows_out's
// last: the wrapper returns views, so nothing is written twice.

#include <cstdint>
#include <cuda_runtime.h>

#include "onesweep.cuh"
#include "scan.cuh"

namespace {

using dfp::i64;

constexpr int FILL_BLOCK = 256;
constexpr int FILL_ITEMS = 16;
constexpr int FILL_TILE = FILL_BLOCK * FILL_ITEMS;  // buckets a fill block writes
constexpr int FILL_SCAN_KEYS = 4 * FILL_TILE;       // past this, a tile searches
constexpr int PART_TILE = 256 * 16;                 // rows a partition block takes

inline i64 fill_tiles(i64 T) { return (T + 2 + FILL_TILE - 1) / FILL_TILE; }
inline i64 part_tiles(i64 n) { return (n + PART_TILE - 1) / PART_TILE; }

// Over the rows outside bucket T: hist[d] = those whose slot's first digit
// (slot & (2^width - 1)) is d, *valid = how many
__global__ void __launch_bounds__(256) slot_hist_kernel(const int32_t* __restrict__ slot, i64 n,
                                                        i64 T, int width,
                                                        int32_t* __restrict__ hist,
                                                        i64* __restrict__ valid) {
  __shared__ int cnt[256];
  __shared__ int rows;
  cnt[threadIdx.x] = 0;
  if (threadIdx.x == 0) rows = 0;
  __syncthreads();
  const int mask = (1 << width) - 1;
  int mine = 0;
  for (i64 i = (i64)blockIdx.x * 256 + threadIdx.x; i < n; i += (i64)gridDim.x * 256) {
    const int s = __ldg(slot + i);
    if (s != T) {
      atomicAdd(&cnt[s & mask], 1);
      ++mine;
    }
  }
  atomicAdd(&rows, mine);
  __syncthreads();
  if (cnt[threadIdx.x] != 0) atomicAdd(&hist[threadIdx.x], cnt[threadIdx.x]);
  if (threadIdx.x == 0 && rows != 0) atomicAdd((unsigned long long*)valid, (unsigned long long)rows);
}

// The stable partition, tiles of PART_TILE rows by look-back over their
// counts of rows outside bucket T: such a row's (slot, row id) goes to
// keys[v], ids[v] (v: the rows outside bucket T before it), a row of
// bucket T's id to perm[*valid + p] (p: the rows of bucket T before it).
// Both runs of a tile go out through shared memory, coalesced.
__global__ void __launch_bounds__(256) partition_kernel(const int32_t* __restrict__ slot, i64 n,
                                                        i64 T, const i64* __restrict__ valid,
                                                        uint64_t* status, i64 tiles,
                                                        uint32_t* __restrict__ keys,
                                                        int32_t* __restrict__ ids,
                                                        int32_t* __restrict__ perm) {
  __shared__ int32_t sk[PART_TILE + PART_TILE / 16], sv[PART_TILE + PART_TILE / 16];
  __shared__ i64 smem[33];
  __shared__ i64 prefix;
  __shared__ int tile_sh;
  const int tid = threadIdx.x;
  const i64 tile = dfp::lookback_tile(status, tiles, &tile_sh);
  const i64 first = tile * PART_TILE;
  const int rows = (int)(n - first < PART_TILE ? n - first : PART_TILE);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int j = k * 256 + tid;
    sk[dfp::scan_pad(j)] = j < rows ? __ldg(slot + first + j) : (int32_t)T;
  }
  __syncthreads();
  int32_t v[16];  // thread tid: rows tid * 16 .. +16 of the tile, in order
  int own = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    v[k] = sk[dfp::scan_pad(tid * 16 + k)];
    own += v[k] != T;
  }
  i64 agg;
  const i64 ex = dfp::block_exclusive_scan(own, smem, &agg);
  const i64 before = dfp::lookback_prefix(status, tile, agg, &prefix);
  // in shared memory: the tile's rows outside bucket T first, then its
  // rows of bucket T, each run in row order
  int a = (int)ex, b = (int)agg + (tid * 16 - (int)ex);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int at = v[k] != T ? a++ : b++;
    sk[dfp::scan_pad(at)] = v[k];
    sv[dfp::scan_pad(at)] = (int32_t)(first + tid * 16 + k);
  }
  __syncthreads();
  const i64 pad_at = *valid + (first - before) - agg;  // where the tile's bucket-T rows go
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int j = k * 256 + tid;
    if (j < agg) {
      keys[before + j] = (uint32_t)sk[dfp::scan_pad(j)];
      ids[before + j] = sv[dfp::scan_pad(j)];
    } else if (j < rows) {
      perm[pad_at + j] = sv[dfp::scan_pad(j)];
    }
  }
}

// The sorted bucket ids: the first *valid sorted keys, then bucket T's
// rows, whose keys are implied
struct SortedKeys {
  const uint32_t* keys;
  i64 valid;
  i64 T;
  __device__ __forceinline__ i64 operator[](i64 i) const {
    return i < valid ? (i64)__ldg(keys + i) : T;
  }
};

// first[t] = the first position of the n sorted keys that is >=
// t * FILL_TILE, for t in [0, tiles]
__global__ void __launch_bounds__(256) tile_bounds_kernel(const uint32_t* __restrict__ keys,
                                                          const i64* __restrict__ valid, i64 n,
                                                          i64 T, i64 tiles,
                                                          int32_t* __restrict__ first) {
  const i64 t = (i64)blockIdx.x * 256 + threadIdx.x;
  if (t > tiles) return;
  const i64 b = t * FILL_TILE;
  i64 lo = 0, hi = *valid;  // every sorted key there is below T
  if (b > T) {
    lo = n;
  } else {
    while (lo < hi) {
      const i64 mid = (lo + hi) >> 1;
      if ((i64)__ldg(keys + mid) < b) lo = mid + 1; else hi = mid;
    }
  }
  first[t] = (int32_t)lo;
}

// Block t writes buckets [t * FILL_TILE, +FILL_TILE) of offsets (T + 2
// of them) and of start and counts (T + 1): the keys of those buckets are
// keys[first[t], first[t+1]). A bucket's count is its run's end minus its
// start (each found where the key changes) or, for a tile of more than
// FILL_SCAN_KEYS keys, the difference of two searches for the ends; the
// offsets are the tile's first position plus the exclusive scan of the
// counts.
__global__ void __launch_bounds__(FILL_BLOCK) fill_kernel(const uint32_t* __restrict__ sorted,
                                                          const i64* __restrict__ valid, i64 T,
                                                          const int32_t* __restrict__ first,
                                                          int32_t* __restrict__ offsets,
                                                          int32_t* __restrict__ start,
                                                          int32_t* __restrict__ counts) {
  __shared__ int32_t cnt[FILL_TILE + FILL_TILE / 16];
  __shared__ i64 smem[33];
  const int tid = threadIdx.x;
  const i64 b0 = (i64)blockIdx.x * FILL_TILE;
  const i64 lo = first[blockIdx.x], hi = first[blockIdx.x + 1];
  const SortedKeys keys{sorted, *valid, T};
  if (hi - lo <= FILL_SCAN_KEYS) {
#pragma unroll
    for (int k = 0; k < FILL_ITEMS; ++k) cnt[dfp::scan_pad(k * FILL_BLOCK + tid)] = 0;
    __syncthreads();
    // a run [s, e) of key k: its first position subtracts s, its last adds e
    for (i64 i = lo + tid; i < hi; i += FILL_BLOCK) {
      const i64 k = keys[i];
      const int at = dfp::scan_pad((int)(k - b0));
      int c = 0;
      if (i == lo || keys[i - 1] != k) c -= (int)(i - lo);
      if (i + 1 == hi || keys[i + 1] != k) c += (int)(i + 1 - lo);
      if (c != 0) atomicAdd(&cnt[at], c);
    }
  } else {  // a hot bucket's tile: a thread's 16 buckets in order, each one's end
            // by a binary search (the first) or a gallop from the one before
    int32_t ends[FILL_ITEMS];
    i64 e = lo;
#pragma unroll
    for (int k = 0; k < FILL_ITEMS; ++k) {
      const i64 bound = b0 + tid * FILL_ITEMS + k;
      i64 l = e, h = hi;
      if (k > 0) {  // every position before e holds a key <= bound
        h = e;
        for (i64 step = 1; h < hi && keys[h] <= bound; step <<= 1) {
          l = h + 1;
          h += step;
        }
        h = h < hi ? h : hi;
      }
      while (l < h) {  // the first position in [l, h) past the bucket, else h
        const i64 mid = (l + h) >> 1;
        if (keys[mid] <= bound) l = mid + 1; else h = mid;
      }
      e = l;
      ends[k] = (int32_t)(e - lo);
    }
    cnt[dfp::scan_pad(tid * FILL_ITEMS + FILL_ITEMS - 1)] = ends[FILL_ITEMS - 1];
    __syncthreads();
    const int32_t before = tid == 0 ? 0 : cnt[dfp::scan_pad(tid * FILL_ITEMS - 1)];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FILL_ITEMS; ++k)
      cnt[dfp::scan_pad(tid * FILL_ITEMS + k)] = ends[k] - (k == 0 ? before : ends[k - 1]);
  }
  __syncthreads();
  // thread tid: buckets tid * 16 .. +16 of the tile, in order
  i64 sum = 0;
#pragma unroll
  for (int k = 0; k < FILL_ITEMS; ++k) sum += cnt[dfp::scan_pad(tid * FILL_ITEMS + k)];
  i64 unused;
  i64 run = lo + dfp::block_exclusive_scan(sum, smem, &unused);
  int32_t own[FILL_ITEMS];
#pragma unroll
  for (int k = 0; k < FILL_ITEMS; ++k) own[k] = cnt[dfp::scan_pad(tid * FILL_ITEMS + k)];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < FILL_ITEMS; ++k) {  // the counts' places take the offsets
    cnt[dfp::scan_pad(tid * FILL_ITEMS + k)] = (int32_t)run;
    run += own[k];
  }
  __syncthreads();
  // out striped, coalesced: a bucket's count is the next offset minus its own
#pragma unroll
  for (int k = 0; k < FILL_ITEMS; ++k) {
    const int j = k * FILL_BLOCK + tid;
    const i64 b = b0 + j;
    if (b <= T + 1) {
      const int32_t o = cnt[dfp::scan_pad(j)];
      offsets[b] = o;
      if (b <= T) {
        start[b] = o;
        const int32_t next = j + 1 < FILL_TILE ? cnt[dfp::scan_pad(j + 1)] : (int32_t)hi;
        counts[b] = next - o;
      }
    }
  }
}

// rows_out[w][j] = rows[w][perm[j]] for w < R: a block 1024 output rows of
// one word row, four a thread 256 apart (their perm entries and reads in
// flight together; K5's WORD4 gather, filter_compact.cu)
__global__ void __launch_bounds__(256) rows_gather_kernel(const int32_t* __restrict__ rows,
                                                          i64 n, const int32_t* __restrict__ perm,
                                                          int32_t* __restrict__ rows_out) {
  const i64 j0 = (i64)blockIdx.x * 1024 + threadIdx.x;
  const i64 w = blockIdx.y;
  int32_t p[4], v[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) p[u] = j0 + 256 * u < n ? __ldg(perm + j0 + 256 * u) : 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) v[u] = j0 + 256 * u < n ? __ldg(rows + w * n + p[u]) : 0;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (j0 + 256 * u < n) rows_out[w * n + j0 + 256 * u] = v[u];
}

// Row-major rows: out[j * RW + w] = rows[w][perm[j]] for w < R, perm[j]
// at w = R, zeros up to RW; a thread four output rows 256 apart, every
// word read issued before the rows are stored, one 16-byte store a 4-word
// unit
template <int RW>
__global__ void __launch_bounds__(256) rows_gather_rm_kernel(const int32_t* __restrict__ rows,
                                                             int R, i64 n,
                                                             const int32_t* __restrict__ perm,
                                                             int32_t* __restrict__ out) {
  const i64 j0 = (i64)blockIdx.x * 1024 + threadIdx.x;
  int32_t p[4], v[4][RW];
#pragma unroll
  for (int u = 0; u < 4; ++u) p[u] = j0 + 256 * u < n ? __ldg(perm + j0 + 256 * u) : 0;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int w = 0; w < RW; ++w)
      v[u][w] = w < R && j0 + 256 * u < n ? __ldg(rows + w * n + p[u]) : w == R ? p[u] : 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (j0 + 256 * u >= n) continue;
    int4* dst = (int4*)(out + (j0 + 256 * u) * RW);
#pragma unroll
    for (int q = 0; q < RW / 4; ++q)
      dst[q] = make_int4(v[u][4 * q], v[u][4 * q + 1], v[u][4 * q + 2], v[u][4 * q + 3]);
  }
}

struct CsrScratch {
  dfp::OneSweepScratch os;
  int32_t* first;      // the fill's tile bounds
  i64* valid;          // zeroed with part: the rows outside bucket T
  uint64_t* part;      // the partition's look-back status words and counter
  i64 zero_bytes, bytes;
};

inline CsrScratch csr_carve(char* base, i64 n, i64 T, int passes) {
  CsrScratch s;
  s.os = dfp::onesweep_carve(base, n, 32, passes);
  i64 off = s.os.bytes;
  auto take = [&](i64 bytes) {
    char* p = base == nullptr ? nullptr : base + off;
    off += dfp::os_align(bytes);
    return p;
  };
  s.first = (int32_t*)take((fill_tiles(T) + 1) * 4);
  const i64 zero_at = off;
  s.valid = (i64*)take(8);
  s.part = (uint64_t*)take(dfp::lookback_scratch_bytes(part_tiles(n)));
  s.zero_bytes = off - zero_at;
  s.bytes = off;
  return s;
}

// One digit pass over the *valid rows ahead of the padding (the grid covers n).
void sort_pass(const uint32_t* kin, const int32_t* vin, i64 n, int shift, int width,
               int next_width, int p, const CsrScratch& s, uint32_t* kout, int32_t* vout,
               cudaStream_t st) {
  const unsigned tiles = (unsigned)((n + dfp::os_tile_rows(4) - 1) / dfp::os_tile_rows(4));
  int32_t* hist = s.os.hist + (i64)p * dfp::OS_RADIX;
  dfp::onesweep_pass_kernel<uint32_t, false, dfp::OsDeviceRows>
      <<<tiles, dfp::OS_BLOCK, dfp::os_pass_smem<uint32_t>(), st>>>(
          kin, vin, dfp::OsDeviceRows{s.valid}, shift, width, shift + width, next_width,
          (uint64_t)p + 1, hist, hist + dfp::OS_RADIX, s.os.counters + p, s.os.status, kout,
          vout);
}

}  // namespace

extern "C" long long dfp_csr_build_scratch_bytes(long long n, long long T, int n_passes) {
  return csr_carve(nullptr, n, T, n_passes).bytes;
}

// slot [n] in [0, T] (T = nulls and padding); rows [n_rows, n] narrow words;
// pass_width[n_passes] the digits of the sort, least significant first,
// covering the bits of T (kernels/csr_build.py `digit_passes`). Out:
// offsets [T+2], start_count [2, T+1] (the second row the counts), perm
// [n], and the narrow rows in perm order with the row id after them:
// row_words 0, rows_out [n_rows + 1, n] word-major, perm its last row;
// row_words 4 or 8 (at least n_rows + 1), rows_out [n, row_words]
// row-major, 16-byte aligned, the words past the row id zeros.
extern "C" int dfp_csr_build(const void* slot, long long n, long long T, const void* rows,
                             int n_rows, const int* pass_width, int n_passes,
                             void* offsets, void* start_count, void* perm_out, void* rows_out,
                             int row_words, void* scratch, long long scratch_bytes,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int bits = 0;
  while ((1LL << bits) <= T) ++bits;  // the largest key is T
  int covered = 0;
  for (int p = 0; p < n_passes; ++p) {
    if (pass_width[p] < 1 || pass_width[p] > 8) return (int)cudaErrorInvalidValue;
    covered += pass_width[p];
  }
  if (T < 1 || covered != bits || n_rows < 0) return (int)cudaErrorInvalidValue;
  if (row_words != 0 && ((row_words != 4 && row_words != 8) || n_rows + 1 > row_words ||
                         ((uintptr_t)rows_out & 15) != 0))
    return (int)cudaErrorInvalidValue;
  const CsrScratch s = csr_carve((char*)scratch, n, T, n_passes);
  if (scratch_bytes < s.bytes) return (int)cudaErrorInvalidValue;
  const int32_t* sl = (const int32_t*)slot;
  int32_t* off = (int32_t*)offsets;
  int32_t* start = (int32_t*)start_count;
  int32_t* counts = start + (T + 1);
  int32_t* perm = (int32_t*)perm_out;
  uint32_t* keys_a = (uint32_t*)s.os.keys_a;
  uint32_t* keys_b = (uint32_t*)s.os.keys_b;
  cudaMemsetAsync(scratch, 0, (size_t)s.os.zero_bytes, st);
  cudaMemsetAsync(s.valid, 0, (size_t)s.zero_bytes, st);
  if (n > 0) {
    unsigned gx = dfp::grid_for(n, 256 * 8);
    gx = gx > 1024 ? 1024 : gx;
    slot_hist_kernel<<<gx, 256, 0, st>>>(sl, n, T, pass_width[0], s.os.hist, s.valid);
    const i64 tiles = part_tiles(n);
    partition_kernel<<<(unsigned)tiles, 256, 0, st>>>(sl, n, T, s.valid, s.part, tiles, keys_a,
                                                      s.os.vals_a, perm);
  }
  const uint32_t* kin = keys_a;
  const int32_t* vin = s.os.vals_a;
  cudaFuncSetAttribute(dfp::onesweep_pass_kernel<uint32_t, false, dfp::OsDeviceRows>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, dfp::os_pass_smem<uint32_t>());
  for (int p = 0, shift = 0; p < n_passes && n > 0; shift += pass_width[p], ++p) {
    const bool last = p == n_passes - 1;
    uint32_t* kout = kin == keys_a ? keys_b : keys_a;
    int32_t* vout = last ? perm : vin == s.os.vals_a ? s.os.vals_b : s.os.vals_a;
    const int next_width = last ? 0 : pass_width[p + 1];
    sort_pass(kin, vin, n, shift, pass_width[p], next_width, p, s, kout, vout, st);
    kin = kout;
    vin = vout;
  }
  if (n > 0 && row_words == 4)
    rows_gather_rm_kernel<4><<<dfp::grid_for(n, 1024), 256, 0, st>>>(
        (const int32_t*)rows, n_rows, n, perm, (int32_t*)rows_out);
  else if (n > 0 && row_words == 8)
    rows_gather_rm_kernel<8><<<dfp::grid_for(n, 1024), 256, 0, st>>>(
        (const int32_t*)rows, n_rows, n, perm, (int32_t*)rows_out);
  else if (n > 0 && n_rows > 0)
    rows_gather_kernel<<<dim3(dfp::grid_for(n, 1024), (unsigned)n_rows), 256, 0, st>>>(
        (const int32_t*)rows, n, perm, (int32_t*)rows_out);
  // the sorted keys: kin's first *valid, then T (n == 0: none is read)
  const i64 tiles = fill_tiles(T);
  tile_bounds_kernel<<<dfp::grid_for(tiles + 1, 256), 256, 0, st>>>(kin, s.valid, n, T, tiles,
                                                                    s.first);
  fill_kernel<<<(unsigned)tiles, FILL_BLOCK, 0, st>>>(kin, s.valid, T, s.first, off, start,
                                                      counts);
  return (int)cudaGetLastError();
}
