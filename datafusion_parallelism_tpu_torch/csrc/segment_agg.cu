// K7 segment_agg: group boundaries and per-group reductions over rows that
// are already in group order.
//
// Replaces the sorted path of the JAX package's `hash_aggregate_counted`
// (ops/aggregate.py:338-432): the value-compare boundary flags (NULL ==
// NULL), `compaction_indices` of the boundaries, SUM/COUNT/AVG as
// prefix-sum differences and MIN/MAX as a sorted scatter.
//
// Bound on the H100: memory traffic. The rows below n_valid must be read
// once (the key's word rows, each request's values and validity) and the
// outputs written once; the rows at or past n_valid need no work, and the
// capacity may be thousands of times n_valid (a grouping of a few
// thousand rows in a table seeded at 2^25). The work must not depend on
// group sizes either: one group may hold every row (a constant or hot
// key). So one pass by decoupled look-back (scan.cuh), whose blocks take
// tiles of SA_TILE rows in order from a counter; a block whose tile starts
// at or past n_valid (read on the card) leaves at once. A tile:
//   * flags: each thread takes SA_ITEMS consecutive rows and finds, in
//     registers, which open a group: row 0, or a key column differs from
//     the row before (valid in both and unequal, or valid in one); floats
//     compare as floats (-0.0 == 0.0, NaN != NaN), as jnp's == does. A key
//     of more than 16 columns comes as several specs of 16, folded here;
//   * ranks: a block scan of the threads' flag counts, then the tiles
//     before it (lookback_prefix) give every row its group; the tile that
//     holds row n_valid - 1 writes the true group count;
//   * reductions: each request in turn, every thread of the block on it
//     (so the op and type switch is uniform): a thread folds its rows in
//     order, writing each group that opens and closes among them; a block
//     scan of (has a boundary, value after the last one) gives the groups
//     that began in an earlier thread of the tile. The one group a request
//     has that entered the tile from an earlier one waits for the carry;
//   * carries: the tile publishes its (has a boundary, value after the
//     last one) of every request (the values, a fence, then a state word).
//     Float64 sums must come out the same bits on every run, so a carry is
//     never taken from whichever earlier tile happens to be done: tiles
//     form windows of SA_WINDOW, a tile folds the published values of the
//     tiles before it in its window in a fixed order (a warp scan), and
//     only where no boundary breaks that chain does it also take the
//     inclusive value of the window before, which the window's last tile
//     publishes. One serial step per window, only across tiles with no
//     boundary (one group over many tiles);
//   * sizes ride along as one more request, the first row of each segment.
// A second kernel writes zeros at and past min(n_groups, out_cap). With
// the memset of the status words, three launches. No flag or rank array
// goes through device memory, and values are read once.
// When groups drop (n_groups > out_cap), the last kept group's size,
// counts and sums run to row n_valid, as the JAX package's prefix-sum
// differences do (ops/aggregate.py:378-379): for those requests a dropped
// group's first row opens no segment. Its min and max cover its own rows.
// No atomics but the tile counter: float64 sums come out the same bits on
// every run. Their order differs from a sequential sum, so they are
// compared with a tolerance; integer sums, counts, min and max are exact.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md): Q18's lineitem
// grouping at SF10 (59,997,411 rows, 15,000,000 groups) 1.976 ms, the
// pass 1.56 of it, against a bound of 0.585; its outer grouping (4,473
// rows in 2^25) 0.519 ms, 0.288 of it the zero tail's 0.94 GB at 3.3
// TB/s. The requests' passes hold the pass back, not its look-backs.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "agg.cuh"
#include "scan.cuh"

namespace {

using dfp::AggSpec;
using dfp::i64;

constexpr int MAX_COLS = 16;     // as K1's spec (kernels/hash_slot.py)
constexpr int MAX_SPECS = 8;     // key specs a launch takes (128 columns)
constexpr int SA_WINDOW = 32;    // tiles that fold each other's values (one warp)
// 512 threads of 16 rows: against 8 rows a thread, 256-thread blocks, two
// blocks an SM and a pass that loads a request ahead, the fastest at Q18's
// lineitem grouping and over one group (PERF.md)
constexpr int SA_THREADS = 512;
constexpr int SA_ITEMS = 16;     // consecutive rows a thread takes
constexpr int SA_TILE = SA_THREADS * SA_ITEMS;
constexpr int SA_SLOTS = dfp::MAX_AGGS + 1;   // the requests and the segment starts

// the segment starts: the first row of a segment (a != NONE keeps a)
constexpr int OP_FIRST = 6;
constexpr long long FIRST_NONE = -1;

// a tile's value state word
constexpr uint32_t VS_AGG = 1u;       // its (flag, value) pairs are published
constexpr uint32_t VS_INC = 2u;       // so are its inclusive values (a window's last tile)
constexpr uint32_t VS_FLAG = 4u;      // it opens a group
constexpr uint32_t VS_FLAG_S = 8u;    // it opens a kept group (the sum-type segments)

// The key columns as K1 reads them (kernels/hash_slot.py's spec): kind 0
// int32 word, 1 int64 (lo, hi), 2 float32, 3 float64 (lo, hi).
struct KeySpec {
  int n_cols;
  int kind[MAX_COLS];
  int lo[MAX_COLS];
  int hi[MAX_COLS];
  int vrow[MAX_COLS];
  int vbit[MAX_COLS];
};

struct KeySpecs {
  int n;
  KeySpec s[MAX_SPECS];
};

// Everything the pass reads and writes but the specs.
struct Pass {
  const int32_t* words;
  i64 n, out_cap, tiles, windows;
  const int32_t* n_valid;
  int32_t* starts;
  long long* sizes;
  long long* out;
  i64* n_groups;
  uint64_t* cstatus;   // the group counts' look-back status words, then the tile counter
  uint32_t* vstate;    // a value state word a tile
  long long* vagg;     // [slot][tile] (flag, value after the last boundary) values
  long long* vinc;     // [slot][window] the inclusive values of each window's last tile
};

__host__ __device__ constexpr bool sum_like(int op) {
  return op == dfp::OP_ISUM || op == dfp::OP_DSUM || op == OP_FIRST;
}

template <int OP>
__device__ __forceinline__ long long ident() {
  if constexpr (OP == OP_FIRST) return FIRST_NONE;
  else return dfp::agg_identity(OP);
}

template <int OP>
__device__ __forceinline__ long long comb(long long a, long long b) {
  if constexpr (OP == OP_FIRST) return a != FIRST_NONE ? a : b;
  else return dfp::agg_combine(OP, a, b);
}

__device__ __forceinline__ long long comb_any(int op, long long a, long long b) {
  return op == OP_FIRST ? (a != FIRST_NONE ? a : b) : dfp::agg_combine(op, a, b);
}

__device__ __forceinline__ int slot_op(const AggSpec& s, int a) {
  return a == s.n ? OP_FIRST : dfp::agg_op(s.func[a], s.in_type[a]);
}

// x[k] = p[i0 + k] for k < cnt (0 past it): 16-byte loads (8-byte for a
// run of 8 bytes) where the run is whole and aligned.
template <int ITEMS, typename T>
__device__ __forceinline__ void load_run(const T* __restrict__ p, i64 i0, int cnt,
                                         T (&x)[ITEMS]) {
  constexpr int BYTES = ITEMS * (int)sizeof(T);
  if constexpr (BYTES % 16 == 0) {
    if (cnt == ITEMS && ((uintptr_t)(p + i0) & 15) == 0) {
      const uint4* q = reinterpret_cast<const uint4*>(p + i0);
#pragma unroll
      for (int c = 0; c < BYTES / 16; ++c) {
        const uint4 u = __ldg(q + c);
        memcpy(&x[c * (16 / (int)sizeof(T))], &u, 16);
      }
      return;
    }
  } else if constexpr (BYTES % 8 == 0) {
    if (cnt == ITEMS && ((uintptr_t)(p + i0) & 7) == 0) {
      const uint2* q = reinterpret_cast<const uint2*>(p + i0);
#pragma unroll
      for (int c = 0; c < BYTES / 8; ++c) {
        const uint2 u = __ldg(q + c);
        memcpy(&x[c * (8 / (int)sizeof(T))], &u, 8);
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) x[k] = k < cnt ? p[i0 + k] : T(0);
}

// x[j] = row[i0 - 1 + j], j = 0..ITEMS + 1 (0 outside [0, n)).
template <int ITEMS>
__device__ __forceinline__ void load_neighbourhood(const int32_t* __restrict__ row, i64 i0, i64 n,
                                                   int32_t (&x)[ITEMS + 2]) {
  int32_t mid[ITEMS];
  const i64 left = n - i0;
  load_run<ITEMS>(row, i0, (int)(left < ITEMS ? left : ITEMS), mid);
  x[0] = i0 > 0 ? row[i0 - 1] : 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) x[k + 1] = mid[k];
  x[ITEMS + 1] = i0 + ITEMS < n ? row[i0 + ITEMS] : 0;
}

// Bit j (j = 0..ITEMS): row i0 + j differs from row i0 + j - 1 in a key
// column of `ks`.
template <int ITEMS>
__device__ __forceinline__ uint32_t key_diff(const int32_t* __restrict__ words, i64 n,
                                             const KeySpec& ks, i64 i0) {
  uint32_t diff = 0;
  for (int c = 0; c < ks.n_cols; ++c) {
    int32_t v[ITEMS + 2], lo[ITEMS + 2], hi[ITEMS + 2];
    load_neighbourhood<ITEMS>(words + (i64)ks.vrow[c] * n, i0, n, v);
    load_neighbourhood<ITEMS>(words + (i64)ks.lo[c] * n, i0, n, lo);
    const int kind = ks.kind[c], vbit = ks.vbit[c];
    if (kind == 1 || kind == 3) load_neighbourhood<ITEMS>(words + (i64)ks.hi[c] * n, i0, n, hi);
#pragma unroll
    for (int j = 0; j <= ITEMS; ++j) {
      const bool cv = ((uint32_t)v[j + 1] >> vbit) & 1u, pv = ((uint32_t)v[j] >> vbit) & 1u;
      bool eq;
      if (kind == 0) {
        eq = lo[j + 1] == lo[j];
      } else if (kind == 2) {
        eq = __int_as_float(lo[j + 1]) == __int_as_float(lo[j]);
      } else if (kind == 1) {
        eq = lo[j + 1] == lo[j] && hi[j + 1] == hi[j];
      } else {
        eq = __longlong_as_double(((long long)hi[j + 1] << 32) | (uint32_t)lo[j + 1]) ==
             __longlong_as_double(((long long)hi[j] << 32) | (uint32_t)lo[j]);
      }
      // NULL == NULL
      if (cv != pv || (cv && !eq)) diff |= 1u << j;
    }
  }
  return diff;
}

// Request a's value of each of the thread's rows (the identity where NULL
// or past n_valid; the row index for the segment starts).
template <int OP, int ITEMS>
__device__ __forceinline__ void load_values(const AggSpec& s, int a, i64 i0, int cnt,
                                            long long (&v)[ITEMS]) {
  if constexpr (OP == OP_FIRST) {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) v[k] = k < cnt ? i0 + k : FIRST_NONE;
    return;
  } else {
    uint8_t ok[ITEMS];
    if (s.valid[a] != nullptr) {
      load_run<ITEMS>((const uint8_t*)s.valid[a], i0, cnt, ok);
    } else {
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) ok[k] = k < cnt;
    }
    if (s.func[a] == 0) {  // count: an int64 sum of 0/1
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) v[k] = ok[k] ? 1 : 0;
      return;
    }
    const void* p = s.vals[a];
    switch (s.in_type[a]) {
      case 0: {
        int32_t x[ITEMS];
        load_run<ITEMS>((const int32_t*)p, i0, cnt, x);
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) v[k] = (long long)x[k];
        break;
      }
      case 2: {
        float x[ITEMS];
        load_run<ITEMS>((const float*)p, i0, cnt, x);
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) v[k] = dfp::dbits((double)x[k]);
        break;
      }
      case 4: {
        uint8_t x[ITEMS];
        load_run<ITEMS>((const uint8_t*)p, i0, cnt, x);
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) v[k] = (long long)x[k];
        break;
      }
      default: {  // int64, and float64 bits as they are
        long long x[ITEMS];
        load_run<ITEMS>((const long long*)p, i0, cnt, x);
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) v[k] = x[k];
        break;
      }
    }
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      if (!ok[k] || k >= cnt) v[k] = ident<OP>();
  }
}

// A segment of request a closed at row `last`: its group g (sum-type
// requests fold the dropped groups into group out_cap - 1) gets `val`.
template <int OP>
__device__ __forceinline__ void emit(const Pass& p, int a, i64 g, long long val, i64 last) {
  if constexpr (sum_like(OP)) {
    if (g >= p.out_cap) g = p.out_cap - 1;
    if (g < 0) return;
    if constexpr (OP == OP_FIRST) p.sizes[g] = last + 1 - val;
    else p.out[(i64)a * p.out_cap + g] = val;
  } else {
    if (g < 0 || g >= p.out_cap) return;
    p.out[(i64)a * p.out_cap + g] = val;
  }
}

__device__ __forceinline__ void emit_any(const Pass& p, int op, int a, i64 g, long long val,
                                         i64 last) {
  if (sum_like(op)) {
    if (g >= p.out_cap) g = p.out_cap - 1;
    if (g < 0) return;
    if (op == OP_FIRST) p.sizes[g] = last + 1 - val;
    else p.out[(i64)a * p.out_cap + g] = val;
  } else if (g >= 0 && g < p.out_cap) {
    p.out[(i64)a * p.out_cap + g] = val;
  }
}

// Segmented inclusive scan over a warp's lanes: (f1, v1) then (f2, v2)
// gives (f1 | f2, f2 ? v2 : v1 op v2).
template <int OP>
__device__ __forceinline__ void warp_seg_scan(int& f, long long& v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int of = __shfl_up_sync(0xffffffffu, f, d);
    const long long ov = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) {
      if (!f) v = comb<OP>(ov, v);
      f |= of;
    }
  }
}

struct ScanSmem {
  long long v[33];
  int f[33];
};

// The block's segmented exclusive scan of one (f, v) a thread, in a fixed
// order: (ef, ev) of the threads before this one, (tf, tv) of the block.
template <int OP, int THREADS>
__device__ __forceinline__ void block_seg_scan(int f, long long v, ScanSmem& sm, int& ef,
                                               long long& ev, int& tf, long long& tv) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int NW = THREADS / 32;
  warp_seg_scan<OP>(f, v);
  int lf = __shfl_up_sync(0xffffffffu, f, 1);
  long long lv = __shfl_up_sync(0xffffffffu, v, 1);
  if (lane == 0) {
    lf = 0;
    lv = ident<OP>();
  }
  if (lane == 31) {
    sm.f[warp] = f;
    sm.v[warp] = v;
  }
  __syncthreads();
  if (warp == 0) {
    int wf = lane < NW ? sm.f[lane] : 0;
    long long wv = lane < NW ? sm.v[lane] : ident<OP>();
    warp_seg_scan<OP>(wf, wv);
    int xf = __shfl_up_sync(0xffffffffu, wf, 1);
    long long xv = __shfl_up_sync(0xffffffffu, wv, 1);
    if (lane == 0) {
      xf = 0;
      xv = ident<OP>();
    }
    if (lane < NW) {
      sm.f[lane] = xf;
      sm.v[lane] = xv;
    }
    if (lane == NW - 1) {
      sm.f[32] = wf;
      sm.v[32] = wv;
    }
  }
  __syncthreads();
  const int pf = sm.f[warp];
  const long long pv = sm.v[warp];
  tf = sm.f[32];
  tv = sm.v[32];
  ef = lf | pf;
  ev = lf ? lv : comb<OP>(pv, lv);
  __syncthreads();  // sm is reused by the next scan
}

struct TileSmem {
  ScanSmem scan;
  long long tile_v[SA_SLOTS];    // the tile's value after its last boundary, a slot
  int tile_f[SA_SLOTS];          // ... and whether it has a boundary
  long long head_v[SA_SLOTS];    // the group that entered the tile: its value in the tile,
  i64 head_g[SA_SLOTS];          // its group, the row it ends at, whether it ends here
  i64 head_last[SA_SLOTS];
  int head_has[SA_SLOTS];
  long long carry[SA_SLOTS];     // the value of the group that entered the tile, before it
};

// One slot (a request, or the segment starts) over the thread's rows:
// `rel` are the boundaries that open its segments (bit ITEMS: the row
// after the thread's), `fl` every group boundary, gbase the groups opened
// before the thread's rows.
template <int OP>
__device__ __forceinline__ void slot_pass(const Pass& p, const AggSpec& s, TileSmem& sm, int a,
                                          i64 i0, i64 nv, uint32_t fl, uint32_t fs, i64 gbase) {
  const uint32_t rel = sum_like(OP) ? fs : fl;
  constexpr int ITEMS = SA_ITEMS;
  const int cnt = (int)(nv - i0 < 0 ? 0 : (nv - i0 < ITEMS ? nv - i0 : ITEMS));
  long long run = ident<OP>(), head = ident<OP>();
  bool seen = false, head_ends = false;
  i64 head_last = 0, head_g = 0;
  if (cnt > 0) {
    long long v[ITEMS];
    load_values<OP, ITEMS>(s, a, i0, cnt, v);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if ((rel >> k) & 1u) {
        if (k > 0) {  // the segment before row i0 + k closes
          const i64 g = gbase + __popc(fl & ((1u << k) - 1u)) - 1;
          if (!seen) {
            head = run;
            head_ends = true;
            head_last = i0 + k - 1;
            head_g = g;
          } else {
            emit<OP>(p, a, g, run, i0 + k - 1);
          }
        }
        seen = true;
        run = ident<OP>();
      }
      run = comb<OP>(run, v[k]);
    }
    if (!seen) head = run;
    if (((rel >> ITEMS) & 1u) || i0 + ITEMS >= nv) {  // the open segment ends here
      const i64 g = gbase + __popc(fl & ((1u << ITEMS) - 1u)) - 1;
      const i64 last = (i0 + ITEMS < nv ? i0 + ITEMS : nv) - 1;
      if (seen) {
        emit<OP>(p, a, g, run, last);
      } else {
        head_ends = true;
        head_last = last;
        head_g = g;
      }
    }
  }
  int ef, tf;
  long long ev, tv;
  block_seg_scan<OP, SA_THREADS>(seen ? 1 : 0, seen ? run : head, sm.scan, ef, ev, tf, tv);
  if (head_ends) {
    const long long val = comb<OP>(ev, head);
    if (ef) {
      emit<OP>(p, a, head_g, val, head_last);
    } else {  // the group that entered the tile: one thread a slot
      sm.head_v[a] = val;
      sm.head_g[a] = head_g;
      sm.head_last[a] = head_last;
      sm.head_has[a] = 1;
    }
  }
  if (threadIdx.x == 0) {
    sm.tile_f[a] = tf;
    sm.tile_v[a] = tv;
  }
}

// Warp 0: the value that enters the tile of slot a, from the published
// values of the m tiles before it in its window (lanes 0..m-1) and, where
// none of them has a boundary, the window before's inclusive value.
template <int OP>
__device__ __forceinline__ void slot_carry(const Pass& p, TileSmem& sm, int a, i64 base, int m,
                                           unsigned fm, unsigned sm_mask) {
  const int lane = threadIdx.x & 31;
  const unsigned relm = sum_like(OP) ? sm_mask : fm;
  int f = (relm >> lane) & 1u;
  long long v = lane < m ? __ldcg(p.vagg + (i64)a * p.tiles + base + lane) : ident<OP>();
  warp_seg_scan<OP>(f, v);
  long long c = __shfl_sync(0xffffffffu, v, m > 0 ? m - 1 : 0);
  if (m == 0) c = ident<OP>();
  if (relm == 0u && base > 0)
    c = comb<OP>(__ldcg(p.vinc + (i64)a * p.windows + base / SA_WINDOW - 1), c);
  if (lane == 0) sm.carry[a] = c;
}

#define SA_FOR_OP(op, CALL)                                   \
  switch (op) {                                                \
    case dfp::OP_ISUM: CALL(dfp::OP_ISUM); break;              \
    case dfp::OP_DSUM: CALL(dfp::OP_DSUM); break;              \
    case dfp::OP_IMIN: CALL(dfp::OP_IMIN); break;              \
    case dfp::OP_IMAX: CALL(dfp::OP_IMAX); break;              \
    case dfp::OP_DMIN: CALL(dfp::OP_DMIN); break;              \
    case dfp::OP_DMAX: CALL(dfp::OP_DMAX); break;              \
    default: CALL(OP_FIRST); break;                            \
  }

__global__ void __launch_bounds__(SA_THREADS) seg_pass_kernel(KeySpecs keys, AggSpec spec,
                                                              Pass p) {
  constexpr int THREADS = SA_THREADS, ITEMS = SA_ITEMS;
  __shared__ KeySpec sk[MAX_SPECS];
  __shared__ AggSpec sa;
  __shared__ TileSmem sm;
  __shared__ i64 cscan[33];
  __shared__ i64 prefix_sh;
  __shared__ int tile_sh;
  const int tid = threadIdx.x;
  const i64 tile = dfp::lookback_tile(p.cstatus, p.tiles, &tile_sh);
  i64 nv = *p.n_valid;
  nv = nv < 0 ? 0 : (nv > p.n ? p.n : nv);
  const i64 first = tile * SA_TILE;
  if (first >= nv) {  // no later valid tile looks back at this one
    if (tile == 0 && tid == 0) *p.n_groups = 0;
    return;
  }
  {
    const int* src = (const int*)keys.s;
    int* dst = (int*)sk;
    for (int k = tid; k < keys.n * (int)(sizeof(KeySpec) / sizeof(int)); k += THREADS)
      dst[k] = src[k];
    const int* asrc = (const int*)&spec;
    int* adst = (int*)&sa;
    for (int k = tid; k < (int)(sizeof(AggSpec) / sizeof(int)); k += THREADS) adst[k] = asrc[k];
    if (tid < SA_SLOTS) sm.head_has[tid] = 0;
  }
  __syncthreads();
  const int A = sa.n;

  // flags: bit j, row i0 + j opens a group (j = ITEMS: the next thread's first row)
  const i64 i0 = first + (i64)tid * ITEMS;
  uint32_t fl = 0;
  if (i0 < nv) {
    for (int k = 0; k < keys.n; ++k) fl |= key_diff<ITEMS>(p.words, p.n, sk[k], i0);
    if (i0 == 0) fl |= 1u;
    const i64 in = nv - i0;  // rows of bits 0..ITEMS below n_valid
    if (in <= ITEMS) fl &= (1u << in) - 1u;
  }
  const int cnt = __popc(fl & ((1u << ITEMS) - 1u));
  i64 tile_cnt;
  const i64 excl = dfp::block_exclusive_scan(cnt, cscan, &tile_cnt);
  const i64 prefix = dfp::lookback_prefix(p.cstatus, tile, tile_cnt, &prefix_sh);
  if (tid == 0 && nv <= first + SA_TILE) *p.n_groups = prefix + tile_cnt;
  const i64 gbase = prefix + excl;
  // the kept boundaries (group < out_cap): those that open sum-type segments
  uint32_t fs = 0;
  {
    i64 g = gbase;
#pragma unroll
    for (int j = 0; j <= ITEMS; ++j) {
      if ((fl >> j) & 1u) {
        if (g < p.out_cap) {
          fs |= 1u << j;
          if (j < ITEMS) p.starts[g] = (int32_t)(i0 + j);
        }
        ++g;
      }
    }
  }

  for (int a = 0; a <= A; ++a) {
#define SA_PASS(OPC) slot_pass<OPC>(p, sa, sm, a, i0, nv, fl, fs, gbase)
    SA_FOR_OP(slot_op(sa, a), SA_PASS)
#undef SA_PASS
  }
  __syncthreads();

  // warp 0: publish the tile's pairs (the values, a fence, then the state
  // word), fold the carries from the tiles before it in its window, and a
  // window's last tile publishes its inclusive values the same way
  if (tid < 32) {
    const uint32_t flags = (tile_cnt > 0 ? VS_FLAG : 0u) |
                           (tile_cnt > 0 && prefix < p.out_cap ? VS_FLAG_S : 0u);
    volatile uint32_t* vs = p.vstate;
    for (int a = tid; a <= A; a += 32) __stcg(p.vagg + (i64)a * p.tiles + tile, sm.tile_v[a]);
    __threadfence();
    __syncwarp();
    if (tid == 0) vs[tile] = VS_AGG | flags;
    const i64 base = tile / SA_WINDOW * SA_WINDOW;
    const int m = (int)(tile - base);
    uint32_t st = 0;
    if (tid < m) {
      do {
        st = vs[base + tid];
      } while ((st & VS_AGG) == 0u);
    }
    const unsigned fm = __ballot_sync(0xffffffffu, (st & VS_FLAG) != 0u);
    const unsigned sm_mask = __ballot_sync(0xffffffffu, (st & VS_FLAG_S) != 0u);
    if (base > 0 && sm_mask == 0u) {  // the window before's inclusive values are needed
      if (tid == 0) {
        while ((vs[base - 1] & VS_INC) == 0u) {
        }
      }
      __syncwarp();
    }
    __threadfence();
    for (int a = 0; a <= A; ++a) {
#define SA_CARRY(OPC) slot_carry<OPC>(p, sm, a, base, m, fm, sm_mask)
      SA_FOR_OP(slot_op(sa, a), SA_CARRY)
#undef SA_CARRY
    }
    __syncwarp();
    if (m == SA_WINDOW - 1) {
      for (int a = tid; a <= A; a += 32) {
        const int op = slot_op(sa, a);
        const long long inc =
            sm.tile_f[a] ? sm.tile_v[a] : comb_any(op, sm.carry[a], sm.tile_v[a]);
        __stcg(p.vinc + (i64)a * p.windows + tile / SA_WINDOW, inc);
      }
      __threadfence();
      __syncwarp();
      if (tid == 0) vs[tile] = VS_AGG | VS_INC | flags;
    }
  }
  __syncthreads();

  // the group that entered the tile, where it ends in the tile
  for (int a = tid; a <= A; a += THREADS) {
    if (sm.head_has[a]) {
      const int op = slot_op(sa, a);
      emit_any(p, op, a, sm.head_g[a], comb_any(op, sm.carry[a], sm.head_v[a]),
               sm.head_last[a]);
    }
  }
}

// Outputs at and past kept = min(*n_groups, out_cap) become zeros: a warp
// takes 128 groups, and each of its 16-byte stores covers 512 contiguous
// bytes (whole sectors) where the groups are all past kept and aligned;
// element by element where not.
__global__ void seg_zero_tail_kernel(const i64* __restrict__ n_groups, i64 out_cap, int A,
                                     int32_t* __restrict__ starts, long long* __restrict__ sizes,
                                     long long* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const i64 c0 = ((i64)blockIdx.x * blockDim.x + threadIdx.x) / 32 * 128;
  const i64 ng = *n_groups;
  const i64 lo = ng < out_cap ? ng : out_cap;
  if (c0 >= out_cap || c0 + 128 <= lo) return;
  const bool vec = c0 >= lo && c0 + 128 <= out_cap && (out_cap & 1) == 0 &&
                   (((uintptr_t)starts | (uintptr_t)sizes | (uintptr_t)out) & 15) == 0;
  const uint4 z = make_uint4(0, 0, 0, 0);
  if (vec) {
    *(uint4*)(starts + c0 + 4 * lane) = z;
    *(uint4*)(sizes + c0 + 2 * lane) = z;
    *(uint4*)(sizes + c0 + 64 + 2 * lane) = z;
    for (int a = 0; a < A; ++a) {
      *(uint4*)(out + (i64)a * out_cap + c0 + 2 * lane) = z;
      *(uint4*)(out + (i64)a * out_cap + c0 + 64 + 2 * lane) = z;
    }
    return;
  }
  for (i64 g = c0 + lane; g < c0 + 128 && g < out_cap; g += 32) {
    if (g < lo) continue;
    starts[g] = 0;
    sizes[g] = 0;
    for (int a = 0; a < A; ++a) out[(i64)a * out_cap + g] = 0;
  }
}

i64 align256(i64 b) { return (b + 255) / 256 * 256; }

struct Layout {
  i64 tiles, windows, memset_bytes, vstate, vagg, vinc, bytes;
};

// The scratch: the group counts' status words and the tile counter, then a
// value state word a tile (both zeroed by one memset), then the tiles'
// published values and the windows' inclusive values, A + 1 slots each.
Layout layout(i64 n, int n_aggs) {
  Layout l;
  l.tiles = (n + SA_TILE - 1) / SA_TILE;
  l.windows = (l.tiles + SA_WINDOW - 1) / SA_WINDOW;
  l.vstate = dfp::lookback_scratch_bytes(l.tiles);
  l.memset_bytes = l.vstate + l.tiles * 4;
  l.vagg = align256(l.memset_bytes);
  l.vinc = l.vagg + align256((i64)(n_aggs + 1) * l.tiles * 8);
  l.bytes = l.vinc + align256((i64)(n_aggs + 1) * l.windows * 8);
  return l;
}

}  // namespace

extern "C" long long dfp_segment_agg_scratch_bytes(long long n, int n_aggs) {
  return layout(n, n_aggs).bytes;
}

// words [R, n] sorted key words (keys: a host array of n_specs KeySpecs,
// the key's columns 16 at a time), n_valid (device int32): the rows in
// groups. Out: starts int32[out_cap], sizes int64[out_cap], out [A,
// out_cap] accumulator bits, n_groups (device int64, the true count); zeros
// at and past min(n_groups, out_cap).
extern "C" int dfp_segment_agg(const void* words, long long n, const int* keys, int n_specs,
                               const void* n_valid, const void* spec_ptr, long long out_cap,
                               void* starts, void* sizes, void* out, void* n_groups,
                               void* scratch, long long scratch_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const KeySpec* kss = (const KeySpec*)keys;
  const AggSpec* spec = (const AggSpec*)spec_ptr;
  if (n_specs < 1 || n_specs > MAX_SPECS || spec->n < 0 || spec->n > dfp::MAX_AGGS || n < 0 ||
      out_cap < 0)
    return (int)cudaErrorInvalidValue;
  KeySpecs ks;
  memset(&ks, 0, sizeof(ks));
  ks.n = n_specs;
  for (int k = 0; k < n_specs; ++k) {
    if (kss[k].n_cols < 1 || kss[k].n_cols > MAX_COLS) return (int)cudaErrorInvalidValue;
    ks.s[k] = kss[k];
  }
  const Layout l = layout(n, spec->n);
  if (scratch_bytes < l.bytes) return (int)cudaErrorInvalidValue;
  char* base = (char*)scratch;
  if (l.tiles == 0) {
    cudaMemsetAsync(n_groups, 0, sizeof(i64), st);
  } else {
    cudaMemsetAsync(scratch, 0, l.memset_bytes, st);
    Pass p;
    p.words = (const int32_t*)words;
    p.n = n;
    p.out_cap = out_cap;
    p.tiles = l.tiles;
    p.windows = l.windows;
    p.n_valid = (const int32_t*)n_valid;
    p.starts = (int32_t*)starts;
    p.sizes = (long long*)sizes;
    p.out = (long long*)out;
    p.n_groups = (i64*)n_groups;
    p.cstatus = (uint64_t*)base;
    p.vstate = (uint32_t*)(base + l.vstate);
    p.vagg = (long long*)(base + l.vagg);
    p.vinc = (long long*)(base + l.vinc);
    seg_pass_kernel<<<(unsigned)l.tiles, SA_THREADS, 0, st>>>(ks, *spec, p);
  }
  if (out_cap > 0) {
    seg_zero_tail_kernel<<<dfp::grid_for(out_cap, 4 * 256), 256, 0, st>>>(
        (const i64*)n_groups, out_cap, spec->n, (int32_t*)starts, (long long*)sizes,
        (long long*)out);
  }
  return (int)cudaGetLastError();
}
