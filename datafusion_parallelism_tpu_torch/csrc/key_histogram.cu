// K19 key_histogram: a 256-bucket histogram of the top 8 bits of the row
// hash over the rows in the mask.
//
// Replaces the JAX package's `bucket_of` and the local scatter-add of
// `key_histogram` (parallel/skew.py:42-58); the psum over the mesh is the
// exchange's all_reduce after it.
//
// Bound on the H100: memory traffic, 5 bytes read per row against one
// shared-memory atomic. Each block counts its rows into a 256-bin
// shared-memory histogram (a grid-stride loop over a few blocks per SM, so
// that the global atomics stay 256 a block), then adds its nonzero bins to
// the output with global atomics. Integer adds commute: the result does
// not depend on the order in which the blocks run.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

using dfp::i64;

constexpr int BINS = 256;
constexpr int BLOCK = 256;

__global__ void key_histogram_kernel(const int32_t* __restrict__ hash,
                                     const uint8_t* __restrict__ mask, i64 n,
                                     int32_t* __restrict__ hist) {
  __shared__ int32_t bins[BINS];
  for (int b = threadIdx.x; b < BINS; b += BLOCK) bins[b] = 0;
  __syncthreads();
  const i64 stride = (i64)gridDim.x * BLOCK;
  for (i64 i = (i64)blockIdx.x * BLOCK + threadIdx.x; i < n; i += stride)
    if (mask[i]) atomicAdd(&bins[(uint32_t)hash[i] >> 24], 1);
  __syncthreads();
  for (int b = threadIdx.x; b < BINS; b += BLOCK)
    if (bins[b]) atomicAdd(&hist[b], bins[b]);
}

}  // namespace

// hash [n] int32 (uint32 bits), mask [n] bytes -> hist [256] int32.
extern "C" int dfp_key_histogram(const void* hash, const void* mask, long long n, void* hist,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(hist, 0, BINS * sizeof(int32_t), st);
  if (n > 0) {
    const i64 blocks = (n + BLOCK - 1) / BLOCK;
    const unsigned grid = (unsigned)(blocks < 132 * 8 ? blocks : 132 * 8);
    key_histogram_kernel<<<grid, BLOCK, 0, st>>>((const int32_t*)hash, (const uint8_t*)mask, n,
                                                 (int32_t*)hist);
  }
  return (int)cudaGetLastError();
}
