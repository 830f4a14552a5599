// K19 key_histogram: per shard, a 256-bucket histogram of the top 8 bits of
// the row hash over the shard's rows (below its row count, and in its
// validity mask where it has one), every local shard in one launch.
//
// Replaces the JAX package's `bucket_of` and the local scatter-add of
// `key_histogram` (parallel/skew.py:42-58) with the `row_mask` it is given;
// the psum over the mesh is the exchange's all_reduce after it.
//
// Bound on the H100: a launch. A Size512 probe shard is 524,288 rows, 2 MB
// of hashes (0.6 us at 3.35 TB/s), against ~0.02 ms to launch an empty
// kernel through ctypes and time it; the launch count and the work around
// it are the cost. The design:
//   * one launch a histogram, whatever the shard count: a descriptor a
//     shard (its hashes, its device row count, its validity bytes or null,
//     its capacity), MAX_SHARDS of them by value in the kernel's parameters
//     (as K4's column descriptors); the row mask is made inside from the
//     row count and the validity, so no mask is made around it;
//   * one thread block cluster a shard (CLUSTER blocks, one an SM): each
//     block counts its rows into a 256-bin histogram in shared memory,
//     then the cluster folds its blocks' bins through distributed shared
//     memory, block r summing the bins b = r (mod CLUSTER) over its peers
//     and writing them to the shard's output row. Every output bin is
//     written once, so nothing is zeroed first and nothing persists
//     between launches;
//   * 16 rows a thread in flight: four 16-byte loads of hashes (and four
//     4-byte loads of validity) before any add; a shard whose hashes or
//     validity are off those boundaries is read a row at a time;
//   * a plain shared-memory atomicAdd a row. Measured on the H100, a warp
//     whose rows share one bin (a heavy bucket, all rows in 1 or 4 buckets)
//     adds as fast as one with 32 bins; aggregating a warp's adds by
//     `__match_any_sync` first made every case slower (one shard, uniform
//     hashes: 37.9 us against 7.7).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

typedef long long i64;

constexpr int BINS = 256;
constexpr int THREADS = 512;
constexpr int UNROLL = 4;        // 16-byte loads of hashes in flight a thread
constexpr int CLUSTER = 16;      // blocks a shard: the largest cluster (non-portable past 8)
constexpr int MAX_SHARDS = 64;

// laid out as kernels/key_histogram.py's spec words
struct Shard {
  const int32_t* hash;
  const int32_t* num_rows;
  const uint8_t* valid;  // null: every row below num_rows
  i64 cap;
};

struct Spec {
  int n;
  Shard s[MAX_SHARDS];
};

// spec is __grid_constant__: its descriptors are read in place
__global__ void __launch_bounds__(THREADS) key_histogram_kernel(const __grid_constant__ Spec spec,
                                                                int32_t* __restrict__ hist) {
  __shared__ int bins[BINS];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int shard = blockIdx.x / CLUSTER;
  for (int b = threadIdx.x; b < BINS; b += THREADS) bins[b] = 0;
  __syncthreads();

  const Shard sh = spec.s[shard];
  i64 n = *sh.num_rows;
  n = n < 0 ? 0 : (n < sh.cap ? n : sh.cap);
  const i64 span = (i64)CLUSTER * THREADS;  // the cluster's threads
  const i64 t = (i64)rank * THREADS + threadIdx.x;
  const bool vec = ((uintptr_t)sh.hash & 15) == 0 && ((uintptr_t)sh.valid & 3) == 0;
  i64 scalar_from = 0;                    // the rows read one at a time
  if (vec) {
    const i64 quads = n / 4;
    for (i64 base = t; base < quads; base += span * UNROLL) {
      int4 h[UNROLL];
      uint32_t v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const i64 q = base + u * span;
        const bool in = q < quads;
        h[u] = in ? ((const int4*)sh.hash)[q] : make_int4(0, 0, 0, 0);
        v[u] = !in ? 0u : sh.valid ? ((const uint32_t*)sh.valid)[q] : 0x01010101u;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int32_t hs[4] = {h[u].x, h[u].y, h[u].z, h[u].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if ((v[u] >> (8 * e)) & 0xFFu) atomicAdd(&bins[(uint32_t)hs[e] >> 24], 1);
      }
    }
    scalar_from = quads * 4;
  }
  // the rows past the last whole quad, or every row of an unaligned shard
  for (i64 i = scalar_from + t; i < n; i += span)
    if (sh.valid == nullptr || sh.valid[i]) atomicAdd(&bins[(uint32_t)sh.hash[i] >> 24], 1);

  cluster.sync();
  // block `rank` folds the bins b = rank (mod CLUSTER) over the cluster
  for (int b = rank + CLUSTER * threadIdx.x; b < BINS; b += CLUSTER * THREADS) {
    int sum = 0;
    for (int r = 0; r < CLUSTER; ++r) sum += cluster.map_shared_rank(bins, r)[b];
    hist[(i64)shard * BINS + b] = sum;
  }
  cluster.sync();  // no block leaves while a peer may still read its bins
}

}  // namespace

extern "C" long long dfp_key_histogram_plan(int i) {
  const long long plan[] = {BINS, THREADS, CLUSTER, MAX_SHARDS};
  return i >= 0 && i < (int)(sizeof(plan) / sizeof(plan[0])) ? plan[i] : -1;
}

// spec (a host struct laid out as Spec: n shards) -> hist [n, 256] int32,
// row k the histogram of shard k's rows below min(*num_rows, cap) where
// valid (when given) is set.
extern "C" int dfp_key_histogram(const void* spec, void* hist, void* stream) {
  const Spec* s = (const Spec*)spec;
  if (s->n < 1 || s->n > MAX_SHARDS) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < s->n; ++k)
    if (s->s[k].cap < 0 || s->s[k].hash == nullptr || s->s[k].num_rows == nullptr)
      return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaFuncSetAttribute(
      key_histogram_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (set != cudaSuccess) return (int)set;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(s->n * CLUSTER), 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, key_histogram_kernel, *s, (int32_t*)hist);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
