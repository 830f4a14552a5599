// K8 direct_agg: per-group reductions over at most 64 groups whose id is
// arithmetic on dictionary or bool codes.
//
// Replaces the JAX package's `_direct_aggregate` (ops/aggregate.py:108-197:
// gid = sum of codes times the domains' strides with the NULL slot d per
// key, rows outside the table or the row filter in no group, then one-hot
// [G, cap] masked reductions) and `_global_aggregate` (:499, the G = 1
// case). TPC-H Q1 (12 groups, 15 requests) and Q6 (one group) run here.
//
// Bound on the H100: memory traffic, to read each distinct input column of
// the rows below *num_rows once (Q1 at SF10: 3.76 GB, 1.12 ms at
// 3.35 TB/s), under one constraint: every result comes out the same bits on
// every run, float64 sums included, so the fold order must not depend on
// timing (no atomics on float accumulators). Measured on an H100 80GB HBM3
// at 700 W (PERF.md): 2.15 ms at Q1, where the copies alone take 1.3 ms;
// the walks' instructions hold it above the bound. The work per row is
// proportional to the R requests (plus the row count), not to R x G:
//   * rows in: the host lists the distinct input columns ("streams": the
//     row filter, each key's codes and validity, each request's values and
//     validity, a column shared by a count and a sum once). A block takes
//     tiles of T rows in a grid-stride loop; warp 0 issues one bulk copy
//     (the TMA unit, cp.async.bulk) a stream of each tile into shared
//     memory, a tile ahead, each stage's arrival counted by an
//     mbarrier, so the reads of the next tile are in flight while this one
//     is folded and no thread spends instructions on them. T is the
//     largest that leaves four blocks an SM (Q1: 256 rows; Q6: 1,024). The
//     grid is the card's SMs times the blocks that fit one.
//   * group ids: a thread a row of the tile, from the staged filter and
//     keys, into shared memory.
//   * fold: the requests are split over the 8 warps by kind (operation and
//     input type; `sets_of`: Q1's 15 in 8 warps of 2, 2, ..., 1), so a
//     warp's loop is compiled for one kind and its lanes never diverge. A
//     warp's lanes are (sub-run s, request) pairs, S = 32 / b sub-runs for
//     its b requests, each taking every S-th row of the tile: a lane walks
//     its rows in order and folds each row's value (the identity where
//     NULL) into its accumulator of that row's group, a column of the
//     warp's [G][32] slab of shared memory, kept in a register while the
//     group stays the same. No shuffles, no atomics.
//   * the block's partial: pair (r, g) folded over the sub-runs of r's
//     warp in order; then a second kernel folds the blocks' partials in
//     block order, one warp per pair (each lane a stride of blocks, the
//     lanes in lane order). The order depends only on cap, the requests, G
//     and the card.
// What the design runs measured against it (PERF.md): a shuffle tree
// per distinct group a warp step (a ballot loop), and 64-bit shared-memory
// atomics for the order-free integer requests, both 3-5x slower at Q1; each
// warp walking its own rows for every request, its lanes of mixed kinds
// (staged by plain loads, by cp.async, by bulk copies; with branches or
// selects): 4.1-8.8 ms at Q1, the fold's instructions the bound.

#include <cstdint>
#include <cuda_runtime.h>

#include <mutex>

#include "agg.cuh"
#include "scan.cuh"

namespace {

using dfp::AggSpec;
using dfp::i64;

constexpr int MAX_KEYS = 8;
constexpr int MAX_GROUPS = 64;
constexpr int DA_THREADS = 256;
constexpr int DA_WARPS = DA_THREADS / 32;
constexpr int MAX_BLOCKS_PER_SM = 2048 / DA_THREADS;
constexpr int MAX_STREAMS = 1 + 2 * MAX_KEYS + 2 * dfp::MAX_AGGS;
constexpr unsigned FULL = 0xffffffffu;
constexpr int UNROLL = 4;  // rows a walking lane loads before it folds them
// the rows of a tile the plan tries, largest first; two tiles are staged,
// one folded while the next lands
constexpr int N_CHOICES = 4;
constexpr int CHOICES[N_CHOICES] = {1024, 512, 256, 128};
constexpr int STAGES = 2;

// Layout of kernels/direct_agg.py's DirectKeysC: per key its code domain d
// (codes in [0, d), NULL in slot d), whether its codes are bools (one byte)
// or int32, and its codes and validity.
struct DirectKeys {
  int n;
  int dom[MAX_KEYS];
  int is_bool[MAX_KEYS];
  const void* vals[MAX_KEYS];
  const void* valid[MAX_KEYS];
};

// The distinct input columns a tile copies, and which one each key and
// request reads (-1: none; a request without values is a count). Stream s
// takes T * esz[s] bytes of a stage at T * off[s].
struct Streams {
  int n;
  int row_bytes;       // the sum of esz
  int bulk_row_bytes;  // ... over the 16-byte aligned columns
  const char* ptr[MAX_STREAMS];
  int esz[MAX_STREAMS];
  int off[MAX_STREAMS];
  int filter;
  int kvalid[MAX_KEYS], kcode[MAX_KEYS];
  int rvalid[dfp::MAX_AGGS], rval[dfp::MAX_AGGS];
};

// the operation of request r; request n (the last) is the row count
__host__ __device__ __forceinline__ int request_op(const AggSpec& s, int r) {
  return r < s.n ? dfp::agg_op(s.func[r], s.in_type[r]) : dfp::OP_ISUM;
}

// a warp's [G][32] accumulator slabs, STAGES tiles of T rows, T group ids
size_t smem_bytes(int G, int row_bytes, int T) {
  return (size_t)DA_WARPS * G * 32 * 8 + (size_t)STAGES * T * row_bytes + (size_t)T * 4;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// thread 0: the barrier's phase completes when `bytes` more have landed
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// one bulk copy (the TMA unit) of `bytes` (a multiple of 16) into shared memory
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The bytes of stream s's column from row `first` on that one bulk copy
// takes into a tile of T rows: all T rows, or those the column has, cut to
// a multiple of 16; none for a column not 16-byte aligned (a view).
__device__ __forceinline__ unsigned bulk_bytes(const Streams& st, int s, i64 first, int T,
                                               i64 cap) {
  if (((uintptr_t)st.ptr[s] & 15) != 0) return 0;
  const i64 rows = cap - first < T ? cap - first : T;
  return (unsigned)(rows * st.esz[s]) & ~15u;
}

// Every stream's rows [first, first + T) into `stage`: lane 0 of warp 0
// sets the barrier's byte count and warp 0's lanes issue one bulk copy a
// stream; all threads copy the bytes the bulk copies leave (an unaligned
// column, a column's last bytes short of 16) one at a time.
__device__ __forceinline__ void issue_tile(const Streams& st, i64 t, int T, i64 cap, char* stage,
                                           uint64_t* bar) {
  const i64 first = t * T;
  const bool full = first + T <= cap;
  if (threadIdx.x < 32) {
    // the stage's earlier reads (generic proxy) come before the copies' writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (threadIdx.x == 0) {
      unsigned total = full ? (unsigned)(T * st.bulk_row_bytes) : 0;
      for (int s = 0; !full && s < st.n; ++s) total += bulk_bytes(st, s, first, T, cap);
      bar_expect(bar, total);
    }
    __syncwarp();
    for (int s = threadIdx.x; s < st.n; s += 32) {
      const unsigned bytes = bulk_bytes(st, s, first, T, cap);
      if (bytes > 0) bulk_copy(stage + (i64)st.off[s] * T, st.ptr[s] + first * st.esz[s], bytes, bar);
    }
  }
  if (full && st.bulk_row_bytes == st.row_bytes) return;
  for (int s = 0; s < st.n; ++s) {
    const int esz = st.esz[s];
    const i64 rows = cap - first < T ? cap - first : T;
    const i64 done = bulk_bytes(st, s, first, T, cap);
    char* dst = stage + (i64)st.off[s] * T;
    const char* src = st.ptr[s] + first * esz;
    for (i64 b = done + threadIdx.x; b < rows * esz; b += DA_THREADS) dst[b] = src[b];
  }
}

// The kinds of request a walk is specialised for: the accumulator
// operation and the input type (TYPE_NONE: a count, which reads no values)
constexpr int TYPE_NONE = 5;
__host__ __device__ __forceinline__ int kind_of(int op, int in_type) { return op * 6 + in_type; }

// TYPE's value at row j of a staged column, as accumulator bits
template <int TYPE>
__device__ __forceinline__ long long staged_value(const char* col, int j) {
  if (TYPE == 0) return (long long)((const int32_t*)col)[j];
  if (TYPE == 2) return dfp::dbits((double)((const float*)col)[j]);
  if (TYPE == 4) return (long long)((const uint8_t*)col)[j];
  if (TYPE == TYPE_NONE) return 1;
  return ((const long long*)col)[j];  // int64, float64 bits as they are
}

// One lane's fold of rows sr, sr + S, ... of a tile of T rows, UNROLL a
// step (their group ids and values loaded, then folded in row order), the
// running accumulator in a register while the group stays the same;
// `slab` holds the lane's accumulator of group g at slab[g * 32].
template <int OP, int TYPE>
__device__ __forceinline__ void walk(const char* vals, const uint8_t* ok, const int* sgid,
                                     long long* slab, int sr, int S, int T) {
  int cur = -1;
  long long a = 0;
  for (int j = sr; j < T; j += UNROLL * S) {
    int g[UNROLL];
    long long x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int at = j + u * S;
      g[u] = at < T ? sgid[at] : -1;
      x[u] = at < T ? staged_value<TYPE>(vals, at) : 0;
      if (ok != nullptr && at < T && !ok[at]) x[u] = dfp::agg_identity(OP);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (g[u] < 0) continue;
      if (g[u] != cur) {
        if (cur >= 0) slab[cur * 32] = a;
        cur = g[u];
        a = slab[cur * 32];
      }
      a = dfp::agg_combine(OP, a, x[u]);
    }
  }
  if (cur >= 0) slab[cur * 32] = a;
}

// walk<OP, TYPE> for the kind a lane's request is (the same in every lane
// of a warp whose requests are of one kind: no divergence)
__device__ __forceinline__ void walk_kind(int kind, const char* vals, const uint8_t* ok,
                                          const int* sgid, long long* slab, int sr, int S, int T) {
#define DA_WALK(OP, TYPE) \
  case OP * 6 + TYPE: walk<OP, TYPE>(vals, ok, sgid, slab, sr, S, T); break;
  switch (kind) {
    DA_WALK(dfp::OP_ISUM, 0) DA_WALK(dfp::OP_ISUM, 1) DA_WALK(dfp::OP_ISUM, 4)
    DA_WALK(dfp::OP_ISUM, TYPE_NONE) DA_WALK(dfp::OP_DSUM, 2) DA_WALK(dfp::OP_DSUM, 3)
    DA_WALK(dfp::OP_IMIN, 0) DA_WALK(dfp::OP_IMIN, 1) DA_WALK(dfp::OP_IMIN, 4)
    DA_WALK(dfp::OP_IMAX, 0) DA_WALK(dfp::OP_IMAX, 1) DA_WALK(dfp::OP_IMAX, 4)
    DA_WALK(dfp::OP_DMIN, 2) DA_WALK(dfp::OP_DMIN, 3) DA_WALK(dfp::OP_DMAX, 2)
    DA_WALK(dfp::OP_DMAX, 3)
    default: break;
  }
#undef DA_WALK
}

// Which requests each warp folds: warp w the requests order[start[w] ..
// start[w + 1]), all of one kind where the kinds allow (WarpSets below)
struct WarpSets {
  int start[DA_WARPS + 1];
  int order[dfp::MAX_AGGS + 1];
  int kind[dfp::MAX_AGGS + 1];  // of request r
};

__global__ void __launch_bounds__(DA_THREADS)
direct_partial_kernel(DirectKeys keys, AggSpec spec, Streams streams, WarpSets sets, int G,
                      i64 cap, const int32_t* __restrict__ num_rows, int T,
                      long long* __restrict__ partials) {
  extern __shared__ __align__(16) long long dyn[];
  __shared__ AggSpec s;
  __shared__ DirectKeys k;
  __shared__ Streams st;
  __shared__ WarpSets ws;
  __shared__ __align__(8) uint64_t bar[STAGES];
  {
    const int* src = (const int*)&spec;
    int* dst = (int*)&s;
    for (int q = threadIdx.x; q < (int)(sizeof(AggSpec) / sizeof(int)); q += blockDim.x) dst[q] = src[q];
    src = (const int*)&keys;
    dst = (int*)&k;
    for (int q = threadIdx.x; q < (int)(sizeof(DirectKeys) / sizeof(int)); q += blockDim.x) dst[q] = src[q];
    src = (const int*)&streams;
    dst = (int*)&st;
    for (int q = threadIdx.x; q < (int)(sizeof(Streams) / sizeof(int)); q += blockDim.x) dst[q] = src[q];
    src = (const int*)&sets;
    dst = (int*)&ws;
    for (int q = threadIdx.x; q < (int)(sizeof(WarpSets) / sizeof(int)); q += blockDim.x) dst[q] = src[q];
  }
  if (threadIdx.x == 0)
    for (int q = 0; q < STAGES; ++q) bar_init(&bar[q]);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const i64 stage_bytes = (i64)T * st.row_bytes;
  long long* acc = dyn;                                              // [warp][G][32]
  char* stages = (char*)(acc + (i64)DA_WARPS * G * 32);              // [STAGES][stage_bytes]
  int* sgid = (int*)(stages + STAGES * stage_bytes);                 // [T]
  // this warp's requests: b of them, S = 32 / b sub-runs; lane = (sub-run
  // sr, request q) with sr = lane / b while lane < S * b
  const int first = ws.start[warp], b = ws.start[warp + 1] - first;
  const int S = b > 0 ? 32 / b : 0;
  const bool walks = b > 0 && lane < S * b;
  const int sr = walks ? lane / b : 0, r = walks ? ws.order[first + lane % b] : 0;
  const int op = request_op(s, r);
  long long* slab = acc + (i64)warp * G * 32 + lane;
  for (int g = 0; g < G; ++g) slab[g * 32] = dfp::agg_identity(op);
  const int kind = ws.kind[r];
  const int vals_at = r < s.n && st.rval[r] >= 0 ? st.off[st.rval[r]] * T : -1;
  const int ok_at = r < s.n && st.rvalid[r] >= 0 ? st.off[st.rvalid[r]] * T : -1;
  const int filter_at = st.filter >= 0 ? st.off[st.filter] * T : -1;
  const i64 nr = *num_rows;
  const i64 lim = nr < 0 ? 0 : (nr < cap ? nr : cap);
  const i64 n_tiles = (lim + T - 1) / T;
  // the first STAGES - 1 tiles in flight
#pragma unroll
  for (int q = 0; q < STAGES - 1; ++q) {
    const i64 t = blockIdx.x + (i64)q * gridDim.x;
    if (t < n_tiles) issue_tile(st, t, T, cap, stages + q * stage_bytes, &bar[q]);
  }
  int slot = 0;
  unsigned parity = 0;  // bit q: the phase slot q's next tile completes
  for (i64 t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    {  // tile t + STAGES - 1 into the slot the last tile was folded from
      const i64 ahead = t + (i64)(STAGES - 1) * gridDim.x;
      const int into = slot == 0 ? STAGES - 1 : slot - 1;
      if (ahead < n_tiles) issue_tile(st, ahead, T, cap, stages + into * stage_bytes, &bar[into]);
    }
    bar_wait(&bar[slot], (parity >> slot) & 1u);
    parity ^= 1u << slot;
    __syncthreads();  // the bytes other threads copied
    const char* tile = stages + slot * stage_bytes;
    // the tile's group ids (-1: in no group), a thread a row
    for (int j = threadIdx.x; j < T; j += DA_THREADS) {
      const i64 i = t * T + j;
      int gid = -1;
      if (i < lim && (filter_at < 0 || tile[filter_at + j])) {
        gid = 0;
        for (int c = 0; c < k.n; ++c) {
          const bool ok = tile[(i64)st.off[st.kvalid[c]] * T + j];
          const char* codes = tile + (i64)st.off[st.kcode[c]] * T;
          const int code = k.is_bool[c] ? (int)((const uint8_t*)codes)[j]
                                        : ((const int32_t*)codes)[j];
          gid = gid * (k.dom[c] + 1) + (ok ? code : k.dom[c]);
        }
        if (gid >= G) gid = -1;  // a code outside its domain: in no group
      }
      sgid[j] = gid;
    }
    __syncthreads();
    if (walks)
      walk_kind(kind, vals_at >= 0 ? tile + vals_at : nullptr,
                ok_at >= 0 ? (const uint8_t*)tile + ok_at : nullptr, sgid, slab, sr, S, T);
    __syncthreads();  // the slot is refilled next
    slot = slot == STAGES - 1 ? 0 : slot + 1;
  }
  __syncthreads();
  // pair p = (r, g): the sub-runs of the warp that folds r, in order
  const int R = s.n + 1, pairs = R * G;
  for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
    const int rr = p / G, g = p % G;
    int w = 0, q = 0;
    for (int x = 0; x < R; ++x)
      if (ws.order[x] == rr) q = x;
    while (ws.start[w + 1] <= q) ++w;
    const int bw = ws.start[w + 1] - ws.start[w], Sw = 32 / bw, at = q - ws.start[w];
    const int o = request_op(s, rr);
    long long a = dfp::agg_identity(o);
    for (int x = 0; x < Sw; ++x) a = dfp::agg_combine(o, a, acc[((i64)w * G + g) * 32 + x * bw + at]);
    partials[(i64)blockIdx.x * pairs + p] = a;
  }
}

// out[p] = the blocks' partials of pair p folded in a fixed order: one warp
// a pair, lane L folding blocks L, L + 32, ... in order, then the lanes in
// lane order (lane 0's fold of the tree below).
__global__ void direct_final_kernel(AggSpec spec, int G, int n_blocks,
                                    const long long* __restrict__ partials,
                                    long long* __restrict__ out) {
  const int pairs = (spec.n + 1) * G;
  const int p = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (p >= pairs) return;
  const int op = request_op(spec, p / G);
  long long a = dfp::agg_identity(op);
  for (int b = lane; b < n_blocks; b += 32) a = dfp::agg_combine(op, a, partials[(i64)b * pairs + p]);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) a = dfp::agg_combine(op, a, __shfl_down_sync(FULL, a, d));
  if (lane == 0) out[p] = a;
}

int stream_of(Streams* st, const void* ptr, int esz) {
  for (int s = 0; s < st->n; ++s)
    if (st->ptr[s] == ptr && st->esz[s] == esz) return s;
  st->ptr[st->n] = (const char*)ptr;
  st->esz[st->n] = esz;
  st->off[st->n] = st->row_bytes;
  st->row_bytes += esz;
  return st->n++;
}

// the distinct columns of the keys, the requests and the filter
void streams_of(const DirectKeys& keys, const AggSpec& spec, const void* row_filter,
                Streams* st) {
  static const int ESZ[5] = {4, 8, 4, 8, 1};  // int32, int64, float32, float64, bool
  st->n = st->row_bytes = st->bulk_row_bytes = 0;
  st->filter = row_filter != nullptr ? stream_of(st, row_filter, 1) : -1;
  for (int c = 0; c < keys.n; ++c) {
    st->kvalid[c] = stream_of(st, keys.valid[c], 1);
    st->kcode[c] = stream_of(st, keys.vals[c], keys.is_bool[c] ? 1 : 4);
  }
  for (int r = 0; r < spec.n; ++r) {
    st->rvalid[r] = spec.valid[r] != nullptr ? stream_of(st, spec.valid[r], 1) : -1;
    st->rval[r] = spec.func[r] != 0 ? stream_of(st, spec.vals[r], ESZ[spec.in_type[r]]) : -1;
  }
  for (int s = 0; s < st->n; ++s)
    if (((uintptr_t)st->ptr[s] & 15) == 0) st->bulk_row_bytes += st->esz[s];
}

// The requests' warps: sorted by kind (stably), each kind's run cut into
// pieces of at most q requests, q the least that gives at most DA_WARPS
// pieces (sizes within one of each other); where the kinds are more than
// the warps, DA_WARPS pieces of the sorted order, kinds mixed.
void sets_of(const AggSpec& spec, WarpSets* ws) {
  const int R = spec.n + 1;
  for (int r = 0; r < R; ++r) {
    const bool count = r == spec.n || spec.func[r] == 0;
    ws->kind[r] = count ? kind_of(dfp::OP_ISUM, TYPE_NONE)
                        : kind_of(dfp::agg_op(spec.func[r], spec.in_type[r]), spec.in_type[r]);
    ws->order[r] = r;
  }
  for (int i = 1; i < R; ++i)  // insertion sort: stable, R <= 33
    for (int j = i; j > 0 && ws->kind[ws->order[j - 1]] > ws->kind[ws->order[j]]; --j) {
      const int x = ws->order[j];
      ws->order[j] = ws->order[j - 1];
      ws->order[j - 1] = x;
    }
  for (int q = (R + DA_WARPS - 1) / DA_WARPS; q <= R; ++q) {
    int pieces = 0;
    for (int i = 0; i < R;) {
      int j = i;
      while (j < R && ws->kind[ws->order[j]] == ws->kind[ws->order[i]]) ++j;
      pieces += (j - i + q - 1) / q;
      i = j;
    }
    if (pieces > DA_WARPS) continue;
    int w = 0;
    ws->start[0] = 0;
    for (int i = 0; i < R;) {
      int j = i;
      while (j < R && ws->kind[ws->order[j]] == ws->kind[ws->order[i]]) ++j;
      const int m = j - i, n = (m + q - 1) / q;
      for (int c = 0; c < n; ++c) ws->start[w + 1] = ws->start[w] + m / n + (c < m % n), ++w;
      i = j;
    }
    for (; w < DA_WARPS; ++w) ws->start[w + 1] = R;
    return;
  }
  const int q = (R + DA_WARPS - 1) / DA_WARPS;
  for (int w = 0; w <= DA_WARPS; ++w) ws->start[w] = w * q < R ? w * q : R;
}

// The card's limits a plan reads, queried once per device (the first
// time also raising the kernel's dynamic shared memory to the block's
// most), and the blocks an SM holds at each shared size planned so far.
constexpr int MAX_DEVICES = 64;
constexpr int MEMO = 16;
struct DeviceInfo {
  int sms, block_bytes, sm_bytes;
  int memo_n;
  size_t memo_smem[MEMO];
  int memo_per_sm[MEMO];
};
std::mutex info_mu;
DeviceInfo info[MAX_DEVICES];
bool info_known[MAX_DEVICES];

// this device's entry, queried on first use; call with info_mu held
int device_info(DeviceInfo** out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  DeviceInfo* d = &info[dev];
  if (!info_known[dev]) {
    cudaFuncAttributes fa;
    e = cudaDeviceGetAttribute(&d->sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&d->block_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&d->sm_bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, direct_partial_kernel);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(direct_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               d->block_bytes - (int)fa.sharedSizeBytes);
    if (e != cudaSuccess) return (int)e;
    d->memo_n = 0;
    info_known[dev] = true;
  }
  *out = d;
  return 0;
}

// The launch plan: T rows a tile (the first of CHOICES that leaves four
// blocks an SM, else three, two, one), and the grid: the SMs times the
// blocks an SM holds, at most one a tile.
struct Plan {
  int T;
  size_t smem;
  int blocks;
  int per_sm;  // blocks an SM holds
};

int plan_of(i64 cap, int G, int row_bytes, Plan* p) {
  std::lock_guard<std::mutex> lock(info_mu);
  DeviceInfo* d = nullptr;
  int e = device_info(&d);
  if (e != 0) return e;
  const size_t fixed = sizeof(AggSpec) + sizeof(DirectKeys) + sizeof(Streams) + sizeof(WarpSets) +
                       8 * STAGES;  // the kernel's static shared memory
  const size_t most = (size_t)d->block_bytes - fixed;
  int T = 0;
  for (int blocks = 4; T == 0 && blocks >= 1; --blocks) {
    // each block also holds its static shared memory and 1 KB
    const size_t room = blocks == 1 ? most : (size_t)d->sm_bytes / blocks - 1024 - fixed;
    for (int q = 0; q < N_CHOICES && T == 0; ++q)
      if (smem_bytes(G, row_bytes, CHOICES[q]) <= room) T = CHOICES[q];
  }
  p->T = T;
  p->smem = smem_bytes(G, row_bytes, T);
  if (T == 0 || p->smem > most) return (int)cudaErrorInvalidValue;
  p->per_sm = 0;
  for (int q = 0; q < d->memo_n; ++q)
    if (d->memo_smem[q] == p->smem) p->per_sm = d->memo_per_sm[q];
  if (p->per_sm == 0) {
    e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p->per_sm, direct_partial_kernel,
                                                           DA_THREADS, p->smem);
    if (e != 0) return e;
    if (p->per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    if (d->memo_n < MEMO) {
      d->memo_smem[d->memo_n] = p->smem;
      d->memo_per_sm[d->memo_n++] = p->per_sm;
    }
  }
  const i64 tiles = (cap + T - 1) / T;
  const i64 room = (i64)d->sms * p->per_sm;
  p->blocks = (int)(tiles < 1 ? 1 : (tiles < room ? tiles : room));
  return 0;
}

int check_args(const DirectKeys* keys, const AggSpec* spec, int* G) {
  *G = 1;
  if (keys->n < 0 || keys->n > MAX_KEYS || spec->n < 0 || spec->n > dfp::MAX_AGGS)
    return (int)cudaErrorInvalidValue;
  for (int c = 0; c < keys->n; ++c) *G *= keys->dom[c] + 1;
  return *G < 1 || *G > MAX_GROUPS ? (int)cudaErrorInvalidValue : 0;
}

}  // namespace

// The partials of the most blocks a grid can hold (every SM full).
extern "C" long long dfp_direct_agg_scratch_bytes(long long cap, int R, int G) {
  (void)cap;
  if (R < 1 || R > dfp::MAX_AGGS + 1 || G < 1 || G > MAX_GROUPS) return -1;
  std::lock_guard<std::mutex> lock(info_mu);
  DeviceInfo* d = nullptr;
  if (device_info(&d) != 0) return -1;
  return (i64)d->sms * MAX_BLOCKS_PER_SM * R * G * 8;
}

namespace {

// What a launch takes from its host arguments: G, the streams, the warps'
// sets and the plan.
int prepare(const DirectKeys* keys, const AggSpec* spec, long long cap, const void* row_filter,
            int* G, Streams* streams, WarpSets* sets, Plan* p) {
  int err = check_args(keys, spec, G);
  if (err != 0) return err;
  streams_of(*keys, *spec, row_filter, streams);
  sets_of(*spec, sets);
  return plan_of(cap, *G, streams->row_bytes, p);
}

}  // namespace

// The plan dfp_direct_agg launches by for these arguments, without
// launching: out gets T, the shared bytes, the blocks, the blocks an SM
// holds, then the warps' sets (start[0..8], order[0..R)).
extern "C" int dfp_direct_agg_plan(const void* keys_ptr, const void* spec_ptr, long long cap,
                                   const void* row_filter, long long* out) {
  const AggSpec* spec = (const AggSpec*)spec_ptr;
  int G;
  Streams streams;
  WarpSets sets;
  Plan p;
  const int err = prepare((const DirectKeys*)keys_ptr, spec, cap, row_filter, &G, &streams,
                          &sets, &p);
  if (err != 0) return err;
  out[0] = p.T, out[1] = (i64)p.smem, out[2] = p.blocks, out[3] = p.per_sm;
  for (int w = 0; w <= DA_WARPS; ++w) out[4 + w] = sets.start[w];
  for (int x = 0; x <= spec->n; ++x) out[5 + DA_WARPS + x] = sets.order[x];
  return 0;
}

// keys, spec: host structs. out [(A + 1), G] int64: request r's result for
// group g at r * G + g (float64 results as their bits), the row count of
// each group in the last row.
extern "C" int dfp_direct_agg(const void* keys_ptr, const void* spec_ptr, long long cap,
                              const void* num_rows, const void* row_filter, void* out,
                              void* scratch, long long scratch_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const DirectKeys* keys = (const DirectKeys*)keys_ptr;
  const AggSpec* spec = (const AggSpec*)spec_ptr;
  int G;
  Streams streams;
  WarpSets sets;
  Plan p;
  const int err = prepare(keys, spec, cap, row_filter, &G, &streams, &sets, &p);
  if (err != 0) return err;
  const int R = spec->n + 1;
  if (scratch_bytes < (i64)p.blocks * R * G * 8) return (int)cudaErrorInvalidValue;
  direct_partial_kernel<<<p.blocks, DA_THREADS, p.smem, st>>>(
      *keys, *spec, streams, sets, G, cap, (const int32_t*)num_rows, p.T, (long long*)scratch);
  direct_final_kernel<<<dfp::grid_for(R * G, 4), 128, 0, st>>>(
      *spec, G, p.blocks, (const long long*)scratch, (long long*)out);
  return (int)cudaGetLastError();
}
