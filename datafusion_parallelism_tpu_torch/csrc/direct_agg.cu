// K8 direct_agg: per-group reductions over at most 64 groups whose id is
// arithmetic on dictionary or bool codes.
//
// Replaces the JAX package's `_direct_aggregate` (ops/aggregate.py:108-197:
// gid = sum of codes times the domains' strides with the NULL slot d per
// key, rows outside the table or the row filter in no group, then one-hot
// [G, cap] masked reductions) and `_global_aggregate` (:499, the G = 1
// case). TPC-H Q1 (12 groups) and Q6 (one) run here.
//
// Bound on the H100: latency, as measured at Q1's SF10 shape (12 groups,
// 12 requests over a 67 M-row capacity: 11-13 ms, against ~1.4 ms to read
// its inputs), because float64 sums must come out the same bits on every
// run: no atomics, not even in shared memory, whose order changes from run
// to run. So each block stages a tile of 256 rows in shared memory (group
// id and every request's accumulator value, loaded coalesced), and each
// (request, group) pair is owned by one thread, which folds the tile's
// rows of its group in row order into its own accumulator. The block's
// partials go to device memory, and a second kernel folds them, one thread
// per pair, in block order. Work per row is one pass over the R x G pairs
// (R requests plus the row count), as in the JAX package's one-hot form,
// but from shared memory; each pair's fold is a serial chain over its
// block's rows, and the request loads of a tile wait on one another, which
// is where the time goes.

#include <cstdint>
#include <cuda_runtime.h>

#include "agg.cuh"
#include "scan.cuh"

namespace {

using dfp::AggSpec;
using dfp::i64;

constexpr int MAX_KEYS = 8;
constexpr int MAX_GROUPS = 64;
constexpr int DA_TILE = 256;    // rows a block stages at a time, one a thread
constexpr int DA_BLOCKS = 1024;  // the most blocks; fixed for a given cap

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

// the accumulator of pair p folds the tile rows of group g, in row order
template <int OP>
__device__ __forceinline__ long long fold_tile(long long acc, const int* __restrict__ gid,
                                               const long long* __restrict__ x, int g) {
#pragma unroll 8
  for (int j = 0; j < DA_TILE; ++j)
    if (gid[j] == g) acc = dfp::agg_combine(OP, acc, x[j]);
  return acc;
}

__device__ __forceinline__ long long fold_tile_op(int op, long long acc, const int* gid,
                                                  const long long* x, int g) {
  switch (op) {
    case dfp::OP_ISUM: return fold_tile<dfp::OP_ISUM>(acc, gid, x, g);
    case dfp::OP_DSUM: return fold_tile<dfp::OP_DSUM>(acc, gid, x, g);
    case dfp::OP_IMIN: return fold_tile<dfp::OP_IMIN>(acc, gid, x, g);
    case dfp::OP_IMAX: return fold_tile<dfp::OP_IMAX>(acc, gid, x, g);
    case dfp::OP_DMIN: return fold_tile<dfp::OP_DMIN>(acc, gid, x, g);
    default: return fold_tile<dfp::OP_DMAX>(acc, gid, x, g);
  }
}

// the operation of request r; request n (the last) is the row count
__device__ __forceinline__ int request_op(const AggSpec& s, int r) {
  return r < s.n ? dfp::agg_op(s.func[r], s.in_type[r]) : dfp::OP_ISUM;
}

__global__ void direct_partial_kernel(DirectKeys keys, AggSpec spec, int G, i64 cap,
                                      const int32_t* __restrict__ num_rows,
                                      const uint8_t* __restrict__ row_filter,
                                      i64 tiles_per_block, long long* __restrict__ partials) {
  extern __shared__ long long dyn[];
  __shared__ AggSpec s;
  __shared__ DirectKeys k;
  {
    const int* src = (const int*)&spec;
    int* dst = (int*)&s;
    for (int q = threadIdx.x; q < (int)(sizeof(AggSpec) / sizeof(int)); q += blockDim.x) dst[q] = src[q];
    src = (const int*)&keys;
    dst = (int*)&k;
    for (int q = threadIdx.x; q < (int)(sizeof(DirectKeys) / sizeof(int)); q += blockDim.x) dst[q] = src[q];
  }
  __syncthreads();
  const int R = s.n + 1, pairs = R * G;
  long long* acc = dyn;                        // [R * G]
  long long* stage = dyn + pairs;              // [R][DA_TILE]
  int* sgid = (int*)(stage + (i64)R * DA_TILE);  // [DA_TILE]
  for (int p = threadIdx.x; p < pairs; p += blockDim.x) acc[p] = dfp::agg_identity(request_op(s, p / G));
  const i64 nr = *num_rows;
  const i64 n_tiles = (cap + DA_TILE - 1) / DA_TILE;
  const i64 t0 = (i64)blockIdx.x * tiles_per_block;
  const i64 t1 = t0 + tiles_per_block < n_tiles ? t0 + tiles_per_block : n_tiles;
  for (i64 t = t0; t < t1; ++t) {
    const i64 i = t * DA_TILE + threadIdx.x;
    const bool in = i < cap && i < nr && (row_filter == nullptr || row_filter[i]);
    int gid = -1;
    if (in) {
      gid = 0;
      for (int c = 0; c < k.n; ++c) {
        const uint8_t* valid = (const uint8_t*)k.valid[c];
        int code = k.dom[c];
        if (valid[i]) code = k.is_bool[c] ? (int)((const uint8_t*)k.vals[c])[i]
                                          : ((const int32_t*)k.vals[c])[i];
        gid = gid * (k.dom[c] + 1) + code;
      }
    }
    sgid[threadIdx.x] = gid;
    for (int r = 0; r < s.n; ++r) {
      const int op = request_op(s, r);
      stage[(i64)r * DA_TILE + threadIdx.x] = in ? dfp::agg_row_value(s, r, op, i) : dfp::agg_identity(op);
    }
    stage[(i64)s.n * DA_TILE + threadIdx.x] = in ? 1 : 0;
    __syncthreads();
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
      const int r = p / G;
      acc[p] = fold_tile_op(request_op(s, r), acc[p], sgid, stage + (i64)r * DA_TILE, p % G);
    }
    __syncthreads();
  }
  for (int p = threadIdx.x; p < pairs; p += blockDim.x) partials[(i64)blockIdx.x * pairs + p] = acc[p];
}

// out[p] = the blocks' partials of pair p folded in block order
__global__ void direct_final_kernel(AggSpec spec, int G, int n_blocks,
                                    const long long* __restrict__ partials,
                                    long long* __restrict__ out) {
  const int pairs = (spec.n + 1) * G;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pairs) return;
  const int op = request_op(spec, p / G);
  long long a = dfp::agg_identity(op);
  for (int b = 0; b < n_blocks; ++b) a = dfp::agg_combine(op, a, partials[(i64)b * pairs + p]);
  out[p] = a;
}

void grid_of(i64 cap, i64* tiles_per_block, int* n_blocks) {
  const i64 n_tiles = (cap + DA_TILE - 1) / DA_TILE;
  *tiles_per_block = n_tiles == 0 ? 1 : (n_tiles + DA_BLOCKS - 1) / DA_BLOCKS;
  *n_blocks = (int)((n_tiles + *tiles_per_block - 1) / *tiles_per_block);
  if (*n_blocks < 1) *n_blocks = 1;
}

}  // namespace

extern "C" long long dfp_direct_agg_scratch_bytes(long long cap, int R, int G) {
  i64 tpb;
  int nb;
  grid_of(cap, &tpb, &nb);
  return (i64)nb * R * G * 8;
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
  int G = 1;
  if (keys->n < 0 || keys->n > MAX_KEYS || spec->n < 0 || spec->n > dfp::MAX_AGGS)
    return (int)cudaErrorInvalidValue;
  for (int c = 0; c < keys->n; ++c) G *= keys->dom[c] + 1;
  if (G < 1 || G > MAX_GROUPS) return (int)cudaErrorInvalidValue;
  const int R = spec->n + 1;
  if (scratch_bytes < dfp_direct_agg_scratch_bytes(cap, R, G)) return (int)cudaErrorInvalidValue;
  i64 tpb;
  int n_blocks;
  grid_of(cap, &tpb, &n_blocks);
  const size_t smem = (size_t)R * G * 8 + (size_t)R * DA_TILE * 8 + DA_TILE * 4;
  cudaFuncSetAttribute(direct_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  direct_partial_kernel<<<n_blocks, DA_TILE, smem, st>>>(
      *keys, *spec, G, cap, (const int32_t*)num_rows, (const uint8_t*)row_filter, tpb,
      (long long*)scratch);
  direct_final_kernel<<<dfp::grid_for(R * G, 128), 128, 0, st>>>(*spec, G, n_blocks,
                                                                 (const long long*)scratch,
                                                                 (long long*)out);
  return (int)cudaGetLastError();
}
