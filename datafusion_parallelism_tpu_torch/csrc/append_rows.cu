// K13 append_rows: a grace partition's rows appended to the row-union
// accumulator, in place.
//
// Replaces the JAX package's row-union append (runtime/grace.py:544-553):
// row i < num_rows of the partition's output goes to acc_rows + i, dropped
// at or past acc_cap, and the new count is acc_rows + num_rows. The JAX
// package scatters every column and validity into fresh copies of the
// accumulator; here the accumulator is one packed [W, acc_cap] word matrix
// plus its float64 sidecars, written in place.
//
// Bound on the H100: memory traffic, the appended rows' words read once
// and written once. One thread a row; both counts are read on the device,
// so nothing travels to the host and the loop need not wait. Only rows
// past the caller's acc_rows are written, so a partition that must be run
// again (a capacity overflow) rewrites exactly what its first attempt
// wrote over, from the same acc_rows. A union partition moves a few rows,
// so the wrapper's host time is most of a call: the wrapper
// (kernels/append_rows.py) resolves this entry point once and checks its
// six tensors in one pass.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

using dfp::i64;

__global__ void append_rows_kernel(int32_t* __restrict__ acc, double* __restrict__ acc_f64,
                                   i64 acc_cap, const int32_t* __restrict__ acc_rows,
                                   const int32_t* __restrict__ words,
                                   const double* __restrict__ f64, i64 cap, int w, int f,
                                   const int32_t* __restrict__ num_rows,
                                   int32_t* __restrict__ new_rows) {
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap) return;
  const i64 base = *acc_rows, n = *num_rows;
  if (i == 0) *new_rows = (int32_t)(base + n);
  const i64 dst = base + i;
  if (i >= n || dst >= acc_cap) return;
  for (int k = 0; k < w; ++k) acc[k * acc_cap + dst] = words[k * cap + i];
  for (int k = 0; k < f; ++k) acc_f64[k * acc_cap + dst] = f64[k * cap + i];
}

}  // namespace

// acc [w, acc_cap] int32 and acc_f64 [f, acc_cap] float64 (written in
// place), acc_rows (device int32); words [w, cap], f64 [f, cap], num_rows
// (device int32); new_rows (device int32) = acc_rows + num_rows.
extern "C" int dfp_append_rows(void* acc, void* acc_f64, long long acc_cap, const void* acc_rows,
                               const void* words, const void* f64, long long cap, int w, int f,
                               const void* num_rows, void* new_rows, void* stream) {
  if (cap <= 0 || acc_cap <= 0) return (int)cudaErrorInvalidValue;
  append_rows_kernel<<<dfp::grid_for(cap, 256), 256, 0, (cudaStream_t)stream>>>(
      (int32_t*)acc, (double*)acc_f64, acc_cap, (const int32_t*)acc_rows,
      (const int32_t*)words, (const double*)f64, cap, w, f, (const int32_t*)num_rows,
      (int32_t*)new_rows);
  return (int)cudaGetLastError();
}
