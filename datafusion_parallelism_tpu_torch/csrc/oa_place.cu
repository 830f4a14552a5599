// K15 oa_place: the open-addressing table's slots from the build rows
// sorted by (home slot, hash).
//
// Replaces the JAX package's placement in `build_oa`
// (ops/hash_table.py:160-175): the parking-function displacement
// `disp = cummax(where(ok, home - i, -cap))`, `pos = i + disp`, and the two
// scatters into zeroed slot and perm arrays of S = T + T/4 entries.
//
// Bound on the H100: memory traffic. Every input is read once (the sorted
// order, and home / hash / ok at each row's order position), the S-entry
// outputs are zeroed and written once; the scan adds one int64 read and
// write per row. Placement needs no sequential insertion: the i-th sorted
// row of a run of rows sharing or crowding a home lands at i + the largest
// (home_j - j) so far, which is a device-wide max-scan (scan.cuh), so every
// pass is one thread a row.
//
//   pass 1, one thread per sorted row i: d[i] = home[o] - i where the row
//           o = order[i] is valid, else -cap;
//   scan:   d = inclusive max-scan of d (the displacement);
//   pass 2: a valid row lands at pos = i + d[i] < S (distinct for distinct
//           rows): slots[pos] = (hash << 32) | (o + 1), perm[pos] = o.
//           Slot 0 stays "empty"; invalid rows drop.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

using dfp::i64;

__global__ void oa_disp_kernel(const int32_t* __restrict__ order,
                               const int32_t* __restrict__ home,
                               const uint8_t* __restrict__ ok, i64 cap,
                               i64* __restrict__ disp) {
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap) return;
  const int32_t o = order[i];
  disp[i] = ok[o] ? (i64)home[o] - i : -cap;
}

__global__ void oa_scatter_kernel(const int32_t* __restrict__ order,
                                  const int32_t* __restrict__ hashes,
                                  const uint8_t* __restrict__ ok,
                                  const i64* __restrict__ disp, i64 cap, i64 S,
                                  i64* __restrict__ slots, int32_t* __restrict__ perm) {
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap) return;
  const int32_t o = order[i];
  if (!ok[o]) return;
  const i64 pos = i + disp[i];
  if (pos < 0 || pos >= S) return;  // JAX's mode="drop"; never taken for a valid row
  const unsigned long long hi = (unsigned long long)(uint32_t)hashes[o] << 32;
  slots[pos] = (i64)(hi | (unsigned long long)(uint32_t)(o + 1));
  perm[pos] = o;
}

}  // namespace

extern "C" long long dfp_oa_place_scratch_bytes(long long cap) {
  return cap * (long long)sizeof(i64) + dfp::max_scan_scratch_bytes(cap);
}

// order int32[cap] (the stable sort by (invalid, home, hash)), home,
// hashes int32[cap], ok bool[cap] in row order; slots int64[S], perm
// int32[S] are written whole.
extern "C" int dfp_oa_place(const void* order, const void* home, const void* hashes,
                            const void* ok, long long cap, long long S, void* slots,
                            void* perm, void* scratch, long long scratch_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (scratch_bytes < dfp_oa_place_scratch_bytes(cap) || S < 1) return (int)cudaErrorInvalidValue;
  cudaMemsetAsync(slots, 0, (size_t)S * sizeof(i64), st);
  cudaMemsetAsync(perm, 0, (size_t)S * sizeof(int32_t), st);
  if (cap > 0) {
    i64* disp = (i64*)scratch;
    void* scan_scratch = (char*)scratch + cap * sizeof(i64);
    oa_disp_kernel<<<dfp::grid_for(cap, 256), 256, 0, st>>>(
        (const int32_t*)order, (const int32_t*)home, (const uint8_t*)ok, cap, disp);
    dfp::inclusive_max_scan(disp, cap, scan_scratch, st);
    oa_scatter_kernel<<<dfp::grid_for(cap, 256), 256, 0, st>>>(
        (const int32_t*)order, (const int32_t*)hashes, (const uint8_t*)ok, disp, cap, S,
        (i64*)slots, (int32_t*)perm);
  }
  return (int)cudaGetLastError();
}
