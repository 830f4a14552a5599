// K4 compact_gather: stable compaction of the matched candidates, then the
// full packed rows of both sides at the surviving pairs.
//
// Replaces the JAX package's `compaction_indices` (utils/columnar.py:418-444),
// the deferred `pairs_table` gathers (ops/join.py:393-416) and
// `_zero_validity_past` (ops/join.py:140-146).
//
// Bound on the H100: random access. Each output row reads W_b + W_p words
// (+ the float64 sidecars) at two random source rows; writes are coalesced,
// one output slot per thread across the warp. The compaction is a flag scan
// (scan.cuh) and a scatter of each match's slot id to its rank, so the
// output order is the candidates' order — the same as the JAX stable
// argsort — and the comparison with it can be exact. Rows at or past
// min(n_match, out_cap) are written as zeros: validity words read 0, as in
// the JAX package, and the values are defined too.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

using dfp::i64;

__global__ void compact_scatter_kernel(const uint8_t* __restrict__ match,
                                       const int32_t* __restrict__ rank, i64 n,
                                       int32_t* __restrict__ cidx) {
  const i64 j = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (j < n && match[j]) cidx[rank[j]] = (int32_t)j;
}

__global__ void pair_gather_kernel(const int32_t* __restrict__ cidx,
                                   const i64* __restrict__ n_match, i64 out_cap,
                                   const int32_t* __restrict__ build_id,
                                   const int32_t* __restrict__ probe_idx,
                                   const int32_t* __restrict__ bwords, int n_bwords, i64 b_stride,
                                   const i64* __restrict__ bf64, int n_bf64,
                                   const int32_t* __restrict__ pwords, int n_pwords, i64 p_stride,
                                   const i64* __restrict__ pf64, int n_pf64,
                                   int32_t* __restrict__ out_b, i64* __restrict__ out_bf64,
                                   int32_t* __restrict__ out_p, i64* __restrict__ out_pf64) {
  const i64 j = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= out_cap) return;
  if (j < *n_match) {  // j < out_cap already
    const i64 c = cidx[j];
    const i64 b = build_id[c];
    const i64 p = probe_idx[c];
    for (int w = 0; w < n_bwords; ++w) out_b[w * out_cap + j] = bwords[w * b_stride + b];
    for (int w = 0; w < n_bf64; ++w) out_bf64[w * out_cap + j] = bf64[w * b_stride + b];
    for (int w = 0; w < n_pwords; ++w) out_p[w * out_cap + j] = pwords[w * p_stride + p];
    for (int w = 0; w < n_pf64; ++w) out_pf64[w * out_cap + j] = pf64[w * p_stride + p];
  } else {
    for (int w = 0; w < n_bwords; ++w) out_b[w * out_cap + j] = 0;
    for (int w = 0; w < n_bf64; ++w) out_bf64[w * out_cap + j] = 0;
    for (int w = 0; w < n_pwords; ++w) out_p[w * out_cap + j] = 0;
    for (int w = 0; w < n_pf64; ++w) out_pf64[w * out_cap + j] = 0;
  }
}

i64 align256(i64 b) { return (b + 255) / 256 * 256; }

}  // namespace

extern "C" long long dfp_compact_gather_scratch_bytes(long long n) {
  return 2 * align256(n * 4) + dfp::scan_scratch_bytes(n);
}

// match [n] (n = out_cap candidate slots) -> n_match64 (device int64) and,
// for j < out_cap, out_b[:, j] = bwords[:, build_id[cidx[j]]] and
// out_p[:, j] = pwords[:, probe_idx[cidx[j]]] (+ the float64 sidecars, moved
// as 64-bit words), zeros past min(n_match, out_cap).
extern "C" int dfp_compact_gather(const void* match, long long n, const void* build_id,
                                  const void* probe_idx, const void* bwords, int n_bwords,
                                  long long b_stride, const void* bf64, int n_bf64,
                                  const void* pwords, int n_pwords, long long p_stride,
                                  const void* pf64, int n_pf64, void* out_b, void* out_bf64,
                                  void* out_p, void* out_pf64, void* n_match64, void* scratch,
                                  long long scratch_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (scratch_bytes < dfp_compact_gather_scratch_bytes(n)) return (int)cudaErrorInvalidValue;
  int32_t* rank = (int32_t*)scratch;
  int32_t* cidx = (int32_t*)((char*)scratch + align256(n * 4));
  void* scan = (char*)scratch + 2 * align256(n * 4);
  dfp::exclusive_scan<uint8_t, int32_t>((const uint8_t*)match, n, rank, (i64*)n_match64, scan, st);
  if (n > 0) {
    compact_scatter_kernel<<<dfp::grid_for(n, 256), 256, 0, st>>>((const uint8_t*)match, rank, n,
                                                                   cidx);
    pair_gather_kernel<<<dfp::grid_for(n, 256), 256, 0, st>>>(
        cidx, (const i64*)n_match64, n, (const int32_t*)build_id, (const int32_t*)probe_idx,
        (const int32_t*)bwords, n_bwords, b_stride, (const i64*)bf64, n_bf64,
        (const int32_t*)pwords, n_pwords, p_stride, (const i64*)pf64, n_pf64, (int32_t*)out_b,
        (i64*)out_bf64, (int32_t*)out_p, (i64*)out_pf64);
  }
  return (int)cudaGetLastError();
}
