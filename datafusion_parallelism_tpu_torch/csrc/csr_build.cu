// K2 csr_build: the CSR hash table of the build side, and its narrow key
// rows in bucket order.
//
// Replaces the JAX package's `build_csr` (ops/hash_table.py:110-126: bucket
// counts by scatter-add, offsets by cumsum, perm = stable argsort by slot,
// start_count = [offsets[:-1]; counts]) and the deferred join's narrow
// permute (ops/join.py:301-306: key words + validity word + row id gathered
// into perm order).
//
// Bound on the H100: memory traffic and, under skew, atomic contention. A
// scatter with atomic cursors would be cheap but not stable, and the perm
// must equal a stable argsort bit for bit. Bucket T holds every null and
// padding row (half the table when it is padded to twice its rows) and a
// hot key puts a large share of the rows into one bucket, so sorting each
// bucket after an atomic scatter would be quadratic exactly there. The
// design is therefore:
//   * counts: one atomic per run of equal slots in a warp (__match_any_sync
//     aggregates them), so a hot bucket costs n/32 atomics, not n;
//   * offsets: the shared device-wide exclusive scan (scan.cuh);
//   * perm: a stable LSD radix sort over the slot bits, 8 bits a pass,
//     ceil(bits(T)/8) passes (radix.cuh, shared with K6 radix_sort);
//   * the last pass writes perm and scatters the narrow rows (plus the row
//     id) straight to their bucket-order position.

#include <cstdint>
#include <cuda_runtime.h>

#include "radix.cuh"
#include "scan.cuh"

namespace {

using dfp::i64;

__global__ void bucket_count_kernel(const int32_t* __restrict__ slot, i64 n,
                                    int32_t* __restrict__ counts) {
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n;
  const int s = active ? slot[i] : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, s);
  if (active && (int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&counts[s], __popc(peers));
}

// The last pass's extra output: rows_out receives rows[:, val] and the row
// id at each slot.
struct RowsEmit {
  const int32_t* rows;
  int n_rows;
  i64 n;
  int32_t* rows_out;
  __device__ __forceinline__ void operator()(i64 dest, int val) const {
    for (int r = 0; r < n_rows; ++r) rows_out[(i64)r * n + dest] = __ldg(rows + (i64)r * n + val);
    rows_out[(i64)n_rows * n + dest] = val;
  }
};

}  // namespace

extern "C" long long dfp_csr_build_scratch_bytes(long long n, long long T) {
  return dfp::radix_carve(nullptr, n, T + 2).bytes;
}

// slot [n] in [0, T] (T = nulls and padding); rows [n_rows, n] narrow words.
// Out: counts [T+2] (the last entry stays 0), offsets [T+2], perm [n],
// start_count [2, T+1], rows_out [n_rows + 1, n] in perm order, the last
// row the row id.
extern "C" int dfp_csr_build(const void* slot, long long n, long long T, const void* rows,
                             int n_rows, void* counts, void* offsets, void* perm,
                             void* start_count, void* rows_out, void* scratch,
                             long long scratch_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dfp::RadixScratch s = dfp::radix_carve((char*)scratch, n, T + 2);
  if (scratch_bytes < s.bytes) return (int)cudaErrorInvalidValue;
  int32_t* cnt = (int32_t*)counts;
  int32_t* off = (int32_t*)offsets;
  cudaMemsetAsync(cnt, 0, (size_t)(T + 2) * 4, st);
  if (n > 0) bucket_count_kernel<<<dfp::grid_for(n, 256), 256, 0, st>>>((const int32_t*)slot, n, cnt);
  dfp::exclusive_scan<int32_t, int32_t>(cnt, T + 2, off, s.total, s.scan, st);
  cudaMemcpyAsync(start_count, off, (size_t)(T + 1) * 4, cudaMemcpyDeviceToDevice, st);
  cudaMemcpyAsync((int32_t*)start_count + (T + 1), cnt, (size_t)(T + 1) * 4,
                  cudaMemcpyDeviceToDevice, st);

  int bits = 0;
  while ((1LL << bits) <= T) ++bits;  // the largest key is T
  const int passes = (bits + 7) / 8;
  const int32_t* kin = (const int32_t*)slot;
  const int32_t* vin = nullptr;
  for (int p = 0; p < passes && n > 0; ++p) {
    const bool last = p == passes - 1;
    int32_t* kout = last ? nullptr : (p % 2 == 0 ? s.keys_a : s.keys_b);
    int32_t* vout = last ? (int32_t*)perm : (p % 2 == 0 ? s.vals_a : s.vals_b);
    if (last) {
      dfp::radix_pass(dfp::CarriedKey{kin}, vin, n, 8 * p, 0u, s, kout, vout,
                      RowsEmit{(const int32_t*)rows, n_rows, n, (int32_t*)rows_out}, st);
    } else {
      dfp::radix_pass(dfp::CarriedKey{kin}, vin, n, 8 * p, 0u, s, kout, vout, dfp::NoEmit{}, st);
    }
    kin = kout;
    vin = vout;
  }
  return (int)cudaGetLastError();
}
