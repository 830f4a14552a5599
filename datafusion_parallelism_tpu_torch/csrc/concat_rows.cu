// K11 concat_rows: the valid rows of several packed tables, one after the
// other, in one table.
//
// Replaces the JAX package's `concat_tables` (utils/columnar.py:818-843):
// per part, a scatter of its packed rows to `offset + r` for r < num_rows
// (the rest dropped), the offset advanced by the part's device row count.
//
// Bound on the H100: memory traffic. Every output word is written once and
// every valid input word read once; both streams are coalesced, since a
// run of output slots maps to a run of one part's rows. One launch covers
// every part: one thread per output slot j reads the parts' row counts
// (at most 8 scalars, in L1 after the first warp), finds the part whose
// range [off_p, off_p + n_p) holds j and copies that row's words and
// float64 sidecars; slots past the total are written as zeros, so their
// validity words read NULL. The offsets never travel to the host. The
// wrapper (kernels/concat_rows.py) resolves this entry point once and
// checks the parts in one pass.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

using dfp::i64;

constexpr int MAX_PARTS = 8;

// laid out as kernels/concat_rows.py::check_parts builds it: 1 + 4 * 8 int64
struct ConcatParts {
  int n;
  const int32_t* words[MAX_PARTS];
  const double* f64[MAX_PARTS];
  long long cap[MAX_PARTS];
  const int32_t* num_rows[MAX_PARTS];
};
static_assert(sizeof(ConcatParts) == 8 * (1 + 4 * MAX_PARTS) && offsetof(ConcatParts, words) == 8,
              "ConcatParts must match check_parts' int64 layout");

__global__ void concat_rows_kernel(ConcatParts parts, int w, int f, i64 total_cap,
                                   int32_t* __restrict__ out, double* __restrict__ out_f64,
                                   int32_t* __restrict__ total) {
  const i64 j = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= total_cap) return;
  i64 off = 0;
  int part = -1;
  i64 row = 0;
  for (int p = 0; p < parts.n; ++p) {
    const i64 np = *parts.num_rows[p];
    if (part < 0 && j < off + np) {
      part = p;
      row = j - off;
    }
    off += np;
  }
  if (j == 0) *total = (int32_t)off;
  if (part < 0) {
    for (int k = 0; k < w; ++k) out[k * total_cap + j] = 0;
    for (int k = 0; k < f; ++k) out_f64[k * total_cap + j] = 0.0;
    return;
  }
  const i64 cap = parts.cap[part];
  const int32_t* src = parts.words[part];
  const double* src_f64 = parts.f64[part];
  for (int k = 0; k < w; ++k) out[k * total_cap + j] = src[k * cap + row];
  for (int k = 0; k < f; ++k) out_f64[k * total_cap + j] = src_f64[k * cap + row];
}

}  // namespace

// parts: a host struct laid out as ConcatParts; out [w, total_cap] int32,
// out_f64 [f, total_cap] float64, total (device int32) the sum of the
// parts' num_rows.
extern "C" int dfp_concat_rows(const void* parts, int w, int f, long long total_cap, void* out,
                               void* out_f64, void* total, void* stream) {
  const ConcatParts cp = *(const ConcatParts*)parts;
  if (cp.n < 1 || cp.n > MAX_PARTS || total_cap <= 0) return (int)cudaErrorInvalidValue;
  concat_rows_kernel<<<dfp::grid_for(total_cap, 256), 256, 0, (cudaStream_t)stream>>>(
      cp, w, f, total_cap, (int32_t*)out, (double*)out_f64, (int32_t*)total);
  return (int)cudaGetLastError();
}
