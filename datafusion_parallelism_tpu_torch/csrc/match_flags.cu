// K10 match_flags: which build rows and which probe rows matched.
//
// Replaces the JAX package's `visited` and `probe_matched` scatter-sets
// (ops/join.py:363-368: zeros, then `.at[where(match, id, cap)].set(True,
// mode="drop")`).
//
// Bound on the H100: memory traffic. Per candidate slot it reads the match
// byte and, where it is set, the two row ids, then writes one byte at each
// (random) row. The flags are zero-filled first; then one thread per slot
// sets its two flags. Every writer of a flag writes the same value 1, so
// concurrent writes to one flag (a build row matched by many probe rows)
// are benign and need no atomics, and the result does not depend on the
// order in which the blocks run.
//
// Accumulate mode (`keep_visited`): the visited flags are not zero-filled,
// so the matches OR into the caller's buffer: the streamed visited fold
// across probe chunks and grace's mask merge across partitions.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

using dfp::i64;

__global__ void match_flags_kernel(const uint8_t* __restrict__ match,
                                   const int32_t* __restrict__ build_id,
                                   const int32_t* __restrict__ probe_idx, i64 n,
                                   uint8_t* __restrict__ visited, i64 bcap,
                                   uint8_t* __restrict__ probe_matched, i64 mcap) {
  const i64 j = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n || !match[j]) return;
  const i64 b = build_id[j], p = probe_idx[j];
  if (b >= 0 && b < bcap) visited[b] = 1;
  if (p >= 0 && p < mcap) probe_matched[p] = 1;
}

}  // namespace

// match, build_id, probe_idx [n] -> visited [bcap], probe_matched [mcap]
// (bytes 0/1); with keep_visited the visited flags already set stay set.
extern "C" int dfp_match_flags(const void* match, const void* build_id, const void* probe_idx,
                               long long n, void* visited, long long bcap, int keep_visited,
                               void* probe_matched, long long mcap, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!keep_visited) cudaMemsetAsync(visited, 0, (size_t)bcap, st);
  cudaMemsetAsync(probe_matched, 0, (size_t)mcap, st);
  if (n > 0) {
    match_flags_kernel<<<dfp::grid_for(n, 256), 256, 0, st>>>(
        (const uint8_t*)match, (const int32_t*)build_id, (const int32_t*)probe_idx, n,
        (uint8_t*)visited, bcap, (uint8_t*)probe_matched, mcap);
  }
  return (int)cudaGetLastError();
}
