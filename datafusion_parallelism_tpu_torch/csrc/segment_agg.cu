// K7 segment_agg: group boundaries and per-group reductions over rows that
// are already in group order.
//
// Replaces the sorted path of the JAX package's `hash_aggregate_counted`
// (ops/aggregate.py:338-432): the value-compare boundary flags (NULL ==
// NULL), `compaction_indices` of the boundaries, SUM/COUNT/AVG as
// prefix-sum differences and MIN/MAX as a sorted scatter.
//
// Bound on the H100: memory traffic. Per row it reads the key words once
// (the flags), the flags and group ranks, and each aggregate's input
// twice. The work must not depend on group sizes: one group may hold every
// row (a constant or hot key), where a thread per group would run alone.
// So every aggregate is a segmented scan, one thread per row:
//   * flags: row i < n_valid opens a group when i == 0 or a key column
//     differs from row i-1 (valid in both and unequal, or valid in one);
//     floats compare as floats (-0.0 == 0.0, NaN != NaN), as jnp's == does.
//     A key of more than 16 columns comes as several specs of 16: one
//     launch per spec, each ORing its flags into the first one's;
//   * ranks: the exclusive scan of the flags (scan.cuh) gives each row its
//     group and the true group count;
//   * tiles: each block scans its 512 rows segmentedly per aggregate
//     (warp shuffles, then the warps' totals) and leaves the tile's
//     (has a boundary, value after its last boundary);
//   * carries: one block scans the tiles' pairs segmentedly, which gives
//     each tile the running value of the group that enters it;
//   * the tiles again: the last row of each group writes its value, the
//     carry combined in where the group began in an earlier tile.
// When groups drop (n_groups > out_cap), the last kept group's size,
// counts and sums run to row n_valid, as the JAX package's prefix-sum
// differences do (ops/aggregate.py:378-379): for those requests a dropped
// group's first row opens no segment. Its min and max cover its own rows.
// No atomics anywhere: float64 sums come out the same bits on every run.
// Their order differs from a sequential sum, so they are compared with a
// tolerance; integer sums, counts, min and max are exact.

#include <cstdint>
#include <cuda_runtime.h>

#include "agg.cuh"
#include "scan.cuh"

namespace {

using dfp::AggSpec;
using dfp::i64;

constexpr int MAX_COLS = 16;  // as K1's spec (kernels/hash_slot.py)
constexpr int SEG_BLOCK = 512;
constexpr int CARRY_BLOCK = 1024;

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

__device__ __forceinline__ bool same_key(const int32_t* __restrict__ words, const KeySpec& ks,
                                         i64 n, i64 i) {
  bool same = true;
#pragma unroll
  for (int c = 0; c < MAX_COLS; ++c) {
    if (c >= ks.n_cols) break;
    const bool cv = (((uint32_t)words[(i64)ks.vrow[c] * n + i] >> ks.vbit[c]) & 1u) != 0;
    const bool pv = (((uint32_t)words[(i64)ks.vrow[c] * n + i - 1] >> ks.vbit[c]) & 1u) != 0;
    if (cv != pv) return false;
    if (!cv) continue;  // NULL == NULL
    const int32_t a = words[(i64)ks.lo[c] * n + i], b = words[(i64)ks.lo[c] * n + i - 1];
    const int kind = ks.kind[c];
    if (kind == 0) {
      same = same && a == b;
    } else if (kind == 2) {
      same = same && __int_as_float(a) == __int_as_float(b);
    } else {
      const int32_t ah = words[(i64)ks.hi[c] * n + i], bh = words[(i64)ks.hi[c] * n + i - 1];
      if (kind == 1) {
        same = same && a == b && ah == bh;
      } else {
        const double x = __longlong_as_double(((long long)ah << 32) | (uint32_t)a);
        const double y = __longlong_as_double(((long long)bh << 32) | (uint32_t)b);
        same = same && x == y;
      }
    }
  }
  return same;
}

__global__ void boundary_kernel(const int32_t* __restrict__ words, KeySpec ks, i64 n,
                                const int32_t* __restrict__ n_valid, bool or_into,
                                uint8_t* __restrict__ flags) {
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint8_t f = 0;
  if (i < (i64)*n_valid) f = (i == 0 || !same_key(words, ks, n, i)) ? 1 : 0;
  flags[i] = or_into ? (uint8_t)(flags[i] | f) : f;
}

// Segmented inclusive scan over the block, one (flag, value) per thread:
// (f1, v1) then (f2, v2) gives (f1 | f2, f2 ? v2 : v1 op v2). `sv`/`sf`
// hold 32 entries each.
__device__ __forceinline__ void seg_scan_block(int op, int& f, long long& v, long long* sv,
                                               int* sf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int of = __shfl_up_sync(0xffffffffu, f, d);
    const long long ov = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) {
      if (!f) v = dfp::agg_combine(op, ov, v);
      f |= of;
    }
  }
  if (lane == 31) {
    sv[warp] = v;
    sf[warp] = f;
  }
  __syncthreads();
  if (warp == 0) {
    int wf = lane < nwarps ? sf[lane] : 0;
    long long wv = lane < nwarps ? sv[lane] : dfp::agg_identity(op);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int of = __shfl_up_sync(0xffffffffu, wf, d);
      const long long ov = __shfl_up_sync(0xffffffffu, wv, d);
      if (lane >= d) {
        if (!wf) wv = dfp::agg_combine(op, ov, wv);
        wf |= of;
      }
    }
    // exclusive: the warps before this one
    const int ef = __shfl_up_sync(0xffffffffu, wf, 1);
    const long long ev = __shfl_up_sync(0xffffffffu, wv, 1);
    if (lane < nwarps) {
      sf[lane] = lane == 0 ? 0 : ef;
      sv[lane] = lane == 0 ? dfp::agg_identity(op) : ev;
    }
  }
  __syncthreads();
  if (warp > 0) {
    if (!f) v = dfp::agg_combine(op, sv[warp], v);
    f |= sf[warp];
  }
  __syncthreads();  // sv/sf are reused by the next scan
}

__device__ __forceinline__ void load_spec(const AggSpec& spec, AggSpec* s) {
  const int* src = (const int*)&spec;
  int* dst = (int*)s;
  for (int k = threadIdx.x; k < (int)(sizeof(AggSpec) / sizeof(int)); k += blockDim.x) dst[k] = src[k];
  __syncthreads();
}

// FINAL == false: each tile leaves (tile_flag[a], tile_val[a]); FINAL: the
// last row of each group writes out[a, g], starts[g] and ends[g] (into
// `ends`, the sizes output, turned into sizes by finalize_kernel). Sum-type
// requests (count, sum) fold the dropped groups into group out_cap - 1.
template <bool FINAL>
__global__ void seg_tile_kernel(AggSpec spec, const uint8_t* __restrict__ flags,
                                const int32_t* __restrict__ rank, i64 n,
                                const int32_t* __restrict__ n_valid, i64 out_cap, i64 n_tiles,
                                uint8_t* __restrict__ tile_flag, long long* __restrict__ tile_val,
                                const long long* __restrict__ carry, int32_t* __restrict__ starts,
                                long long* __restrict__ ends, long long* __restrict__ out) {
  __shared__ AggSpec s;
  __shared__ long long sv[32];
  __shared__ int sf[32];
  load_spec(spec, &s);
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  const i64 nv = *n_valid;
  const bool in = i < nv;
  const int flag = in ? flags[i] : 0;
  const i64 g = in ? (i64)rank[i] + flag - 1 : -1;
  const bool last = in && (i + 1 == nv || flags[i + 1]);
  // the sum-type segmentation: groups past out_cap continue group out_cap - 1
  const i64 gs = g < out_cap ? g : out_cap - 1;
  const int flag_s = flag && g < out_cap;
  const bool last_s = in && (i + 1 == nv || (flags[i + 1] && rank[i + 1] < out_cap));
  if (FINAL && in) {
    if (flag && g < out_cap) starts[g] = (int32_t)i;
    if (last_s && gs >= 0) ends[gs] = i + 1;
  }
  for (int a = 0; a < s.n; ++a) {
    const int op = dfp::agg_op(s.func[a], s.in_type[a]);
    const bool sum = op == dfp::OP_ISUM || op == dfp::OP_DSUM;
    int f = sum ? flag_s : flag;
    long long v = in ? dfp::agg_row_value(s, a, op, i) : dfp::agg_identity(op);
    seg_scan_block(op, f, v, sv, sf);
    const i64 ga = sum ? gs : g;
    if (!FINAL) {
      if (threadIdx.x == blockDim.x - 1) {
        tile_val[(i64)a * n_tiles + blockIdx.x] = v;
        tile_flag[(i64)a * n_tiles + blockIdx.x] = (uint8_t)f;
      }
    } else if ((sum ? last_s : last) && ga >= 0 && ga < out_cap) {
      if (!f) v = dfp::agg_combine(op, carry[(i64)a * n_tiles + blockIdx.x], v);
      out[(i64)a * out_cap + ga] = v;
    }
  }
}

// carry[a, t] = the segmented exclusive scan of the tiles' (flag, value)
// pairs: the running value of the group that enters tile t.
__global__ void seg_carry_kernel(AggSpec spec, const uint8_t* __restrict__ tile_flag,
                                 const long long* __restrict__ tile_val, i64 n_tiles,
                                 long long* __restrict__ carry) {
  __shared__ AggSpec s;
  __shared__ long long sv[32];
  __shared__ int sf[32];
  __shared__ long long inc_v[CARRY_BLOCK];
  __shared__ int inc_f[CARRY_BLOCK];
  load_spec(spec, &s);
  for (int a = 0; a < s.n; ++a) {
    const int op = dfp::agg_op(s.func[a], s.in_type[a]);
    long long run = dfp::agg_identity(op);  // the same in every thread
    for (i64 base = 0; base < n_tiles; base += blockDim.x) {
      const i64 t = base + threadIdx.x;
      int f = t < n_tiles ? tile_flag[(i64)a * n_tiles + t] : 0;
      long long v = t < n_tiles ? tile_val[(i64)a * n_tiles + t] : dfp::agg_identity(op);
      seg_scan_block(op, f, v, sv, sf);  // inclusive over this chunk
      inc_v[threadIdx.x] = v;
      inc_f[threadIdx.x] = f;
      __syncthreads();
      if (t < n_tiles) {  // exclusive: the inclusive value of the tile before
        long long c = run;
        if (threadIdx.x > 0) {
          const long long ev = inc_v[threadIdx.x - 1];
          c = inc_f[threadIdx.x - 1] ? ev : dfp::agg_combine(op, run, ev);
        }
        carry[(i64)a * n_tiles + t] = c;
      }
      const long long lv = inc_v[blockDim.x - 1];
      run = inc_f[blockDim.x - 1] ? lv : dfp::agg_combine(op, run, lv);
      __syncthreads();
    }
  }
}

// kept = min(n_groups, out_cap): sizes = ends - starts below it, zeros at
// and past it.
__global__ void finalize_kernel(const i64* __restrict__ n_groups, i64 out_cap, int n_aggs,
                                int32_t* __restrict__ starts, long long* __restrict__ sizes,
                                long long* __restrict__ out) {
  const i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= out_cap) return;
  const i64 kept = *n_groups < out_cap ? *n_groups : out_cap;
  if (g < kept) {
    sizes[g] -= starts[g];
  } else {
    starts[g] = 0;
    sizes[g] = 0;
    for (int a = 0; a < n_aggs; ++a) out[(i64)a * out_cap + g] = 0;
  }
}

struct Scratch {
  uint8_t* flags;
  int32_t* rank;
  uint8_t* tile_flag;
  long long *tile_val, *carry;
  void* scan;
  i64 bytes;
};

i64 align256(i64 b) { return (b + 255) / 256 * 256; }

Scratch carve(char* base, i64 n, int n_aggs) {
  const i64 n_tiles = (n + SEG_BLOCK - 1) / SEG_BLOCK;
  Scratch s;
  i64 off = 0;
  auto take = [&](i64 bytes) {  // base == nullptr only sizes the layout
    char* p = base == nullptr ? nullptr : base + off;
    off += align256(bytes);
    return p;
  };
  s.flags = (uint8_t*)take(n);
  s.rank = (int32_t*)take(n * 4);
  s.tile_flag = (uint8_t*)take((i64)n_aggs * n_tiles);
  s.tile_val = (long long*)take((i64)n_aggs * n_tiles * 8);
  s.carry = (long long*)take((i64)n_aggs * n_tiles * 8);
  s.scan = take(dfp::scan_scratch_bytes(n));
  s.bytes = off;
  return s;
}

}  // namespace

extern "C" long long dfp_segment_agg_scratch_bytes(long long n, int n_aggs) {
  return carve(nullptr, n, n_aggs).bytes;
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
  if (n_specs < 1 || spec->n < 0 || spec->n > dfp::MAX_AGGS) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < n_specs; ++k)
    if (kss[k].n_cols < 1 || kss[k].n_cols > MAX_COLS) return (int)cudaErrorInvalidValue;
  Scratch s = carve((char*)scratch, n, spec->n);
  if (scratch_bytes < s.bytes) return (int)cudaErrorInvalidValue;
  const i64 n_tiles = (n + SEG_BLOCK - 1) / SEG_BLOCK;
  if (n > 0) {
    for (int k = 0; k < n_specs; ++k)
      boundary_kernel<<<dfp::grid_for(n, 256), 256, 0, st>>>(
          (const int32_t*)words, kss[k], n, (const int32_t*)n_valid, k > 0, s.flags);
  }
  dfp::exclusive_scan<uint8_t, int32_t>(s.flags, n, s.rank, (i64*)n_groups, s.scan, st);
  if (n > 0) {
    if (spec->n > 0) {
      seg_tile_kernel<false><<<(unsigned)n_tiles, SEG_BLOCK, 0, st>>>(
          *spec, s.flags, s.rank, n, (const int32_t*)n_valid, out_cap, n_tiles, s.tile_flag,
          s.tile_val, nullptr, nullptr, nullptr, nullptr);
      seg_carry_kernel<<<1, CARRY_BLOCK, 0, st>>>(*spec, s.tile_flag, s.tile_val, n_tiles,
                                                  s.carry);
    }
    seg_tile_kernel<true><<<(unsigned)n_tiles, SEG_BLOCK, 0, st>>>(
        *spec, s.flags, s.rank, n, (const int32_t*)n_valid, out_cap, n_tiles, nullptr, nullptr,
        s.carry, (int32_t*)starts, (long long*)sizes, (long long*)out);
  }
  if (out_cap > 0) {
    finalize_kernel<<<dfp::grid_for(out_cap, 256), 256, 0, st>>>(
        (const i64*)n_groups, out_cap, spec->n, (int32_t*)starts, (long long*)sizes,
        (long long*)out);
  }
  return (int)cudaGetLastError();
}
