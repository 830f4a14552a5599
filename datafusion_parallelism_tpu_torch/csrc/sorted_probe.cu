// K14 sorted_probe: candidate ranges of the probe rows against the SORT
// strategy's table (build rows sorted by hash).
//
// Replaces the JAX package's SORT branch of `probe_ranges`
// (ops/hash_table.py:257-263: two `jnp.searchsorted` of the probe hash in
// the sorted int64 keys) and `probe_candidates`' cumsum (:283-288).
//
// Bound on the H100: dependent random reads. Each probe row runs one
// binary search over the cap sorted int64 keys, log2(cap) + 1 loads, every
// load depending on the one before. The first levels of every search read
// the same few keys, which stay in L1/L2; only the last levels miss. One
// thread a probe row keeps ~m searches in flight, enough to cover the
// latency of the misses; the bytes that must move are the probe's hashes
// and flags in, the three int32 outputs out. The end of a row's run of
// equal keys is found by reading on from its start (a run is one or two
// keys for a key column that is nearly unique, in the same 32-byte
// sector), and by a second binary search only past RUN_SCAN keys, so a
// hot key costs log2(cap) more loads, not its run's length.
//
//   pass 1, one thread per probe row: key = the hash widened as unsigned;
//           start = the first position with sorted[p] >= key, end = the
//           first with sorted[p] > key; count = end - start, or 0 for a
//           row out of range or with a null key (its start is kept, as
//           JAX keeps searchsorted's answer);
//   scan:   base = exclusive cumsum of count (scan.cuh), total in int64.
//
// Invalid build rows carry the key 2^33, above every hash, so no probe
// reaches them.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

using dfp::i64;

constexpr int RUN_SCAN = 8;  // keys read on from the start before a binary search

__global__ void sorted_probe_kernel(const int32_t* __restrict__ hashes,
                                    const uint8_t* __restrict__ ok, i64 m,
                                    const i64* __restrict__ sorted, i64 cap,
                                    int32_t* __restrict__ start, int32_t* __restrict__ count) {
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const i64 key = (i64)(uint32_t)hashes[i];
  i64 lo = 0, hi = cap;
  while (lo < hi) {  // lower bound
    const i64 mid = (lo + hi) >> 1;
    if (sorted[mid] < key) lo = mid + 1; else hi = mid;
  }
  i64 lo2 = lo;  // upper bound: read on from the lower one
  const i64 stop = lo + RUN_SCAN < cap ? lo + RUN_SCAN : cap;
  while (lo2 < stop && sorted[lo2] == key) ++lo2;
  if (lo2 == stop && stop < cap) {  // a long run: binary search the rest
    i64 hi2 = cap;
    while (lo2 < hi2) {
      const i64 mid = (lo2 + hi2) >> 1;
      if (sorted[mid] <= key) lo2 = mid + 1; else hi2 = mid;
    }
  }
  start[i] = (int32_t)lo;
  count[i] = ok[i] ? (int32_t)(lo2 - lo) : 0;
}

}  // namespace

extern "C" long long dfp_sorted_probe_scratch_bytes(long long m) {
  return dfp::scan_scratch_bytes(m);
}

// hashes int32[m] (uint32 bits), ok bool[m], sorted int64[cap]; start,
// count, base int32[m]; total64 a device int64.
extern "C" int dfp_sorted_probe(const void* hashes, const void* ok, long long m,
                                const void* sorted, long long cap, void* start, void* count,
                                void* base, void* total64, void* scratch,
                                long long scratch_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (scratch_bytes < dfp::scan_scratch_bytes(m)) return (int)cudaErrorInvalidValue;
  if (m > 0) {
    sorted_probe_kernel<<<dfp::grid_for(m, 256), 256, 0, st>>>(
        (const int32_t*)hashes, (const uint8_t*)ok, m, (const i64*)sorted, cap,
        (int32_t*)start, (int32_t*)count);
  }
  dfp::exclusive_scan<int32_t, int32_t>((const int32_t*)count, m, (int32_t*)base,
                                        (i64*)total64, scratch, st);
  return (int)cudaGetLastError();
}
