// K16 oa_probe: candidate ranges of the probe rows against the OA
// strategy's open-addressing table.
//
// Replaces the JAX package's `_probe_oa` (ops/hash_table.py:180-222: a
// `while_loop` that walks every probe row one slot a step, in lockstep,
// until each has found its run of equal hashes or an empty slot) and
// `probe_candidates`' cumsum (:283-288).
//
// Bound on the H100: random reads. A walk starts at a random home slot
// and reads consecutive int64 slots; at the table's load (at most one row
// in four slots) most walks end within one or two 32-byte sectors. Here
// each probe row walks on its own thread to its own end, so a long walk
// (a crowded home) costs only that row's thread, where the JAX loop runs
// every row until the longest walk ends.
//
//   pass 1, one thread per probe row: from home, seek the first slot whose
//           high word equals the row's hash, stopping at an empty slot
//           (value 0); then count the run of equal hashes. start = the
//           first match (0 if none), count = the run's length; 0 and 0 for
//           a row out of range or with a null key. A walk takes at most S
//           steps, as the JAX loop's `k < S`; every walk ends before:
//           pos <= (cap - 1) + (T - 1) <= S - 2 for any occupied slot, so
//           slot S - 1 is always empty.
//   scan:   base = exclusive cumsum of count (scan.cuh), total in int64.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

using dfp::i64;

__global__ void oa_probe_kernel(const int32_t* __restrict__ home,
                                const int32_t* __restrict__ hashes,
                                const uint8_t* __restrict__ ok, i64 m,
                                const i64* __restrict__ slots, i64 S,
                                int32_t* __restrict__ start, int32_t* __restrict__ count) {
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  int32_t st = 0, cnt = 0;
  if (ok[i]) {
    const uint32_t h = (uint32_t)hashes[i];
    i64 cur = home[i];
    bool counting = false;
    for (i64 k = 0; k < S; ++k) {
      const i64 v = slots[cur];
      const bool match = v != 0 && (uint32_t)((unsigned long long)v >> 32) == h;
      if (counting) {
        if (!match) break;
        ++cnt;
      } else if (match) {
        st = (int32_t)cur;
        cnt = 1;
        counting = true;
      } else if (v == 0) {
        break;
      }
      cur = cur + 1 < S ? cur + 1 : S - 1;
    }
  }
  start[i] = st;
  count[i] = cnt;
}

}  // namespace

extern "C" long long dfp_oa_probe_scratch_bytes(long long m) {
  return dfp::scan_scratch_bytes(m);
}

// home, hashes int32[m], ok bool[m], slots int64[S]; start, count, base
// int32[m]; total64 a device int64.
extern "C" int dfp_oa_probe(const void* home, const void* hashes, const void* ok, long long m,
                            const void* slots, long long S, void* start, void* count,
                            void* base, void* total64, void* scratch, long long scratch_bytes,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (scratch_bytes < dfp::scan_scratch_bytes(m) || S < 1) return (int)cudaErrorInvalidValue;
  if (m > 0) {
    oa_probe_kernel<<<dfp::grid_for(m, 256), 256, 0, st>>>(
        (const int32_t*)home, (const int32_t*)hashes, (const uint8_t*)ok, m,
        (const i64*)slots, S, (int32_t*)start, (int32_t*)count);
  }
  dfp::exclusive_scan<int32_t, int32_t>((const int32_t*)count, m, (int32_t*)base,
                                        (i64*)total64, scratch, st);
  return (int)cudaGetLastError();
}
