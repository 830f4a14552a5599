// K12 pack_rows: a table's columns to and from its packed word matrix.
//
// Replaces the JAX package's `pack_table` (utils/columnar.py:753: each
// column as one or two int32 words, then one validity bit per column in
// 32-bit validity words) and `unpack_table` (:783, the inverse), which
// every row-moving operator runs around its kernels and every streamed
// chunk or grace partition runs on arrival.
//
// Bound on the H100: memory traffic. Each column is read once and each
// word written once (pack), or each word read once and each int64, bool
// and validity output written once (unpack). One thread a row loops over
// the fields; a warp's 32 rows are 32 consecutive words of one word row,
// so every load and store is coalesced. The field descriptors (at most
// 128 a launch, 24 bytes each) travel by value in the kernel's parameters,
// so a pack costs no host-to-device copy. A row's validity bits are
// gathered in a register and each validity word is written once.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

using dfp::i64;

constexpr int MAX_FIELDS = 128;
enum : int { V_NONE = 0, V_I32 = 1, V_I64 = 2, V_BOOL = 3 };

// laid out as kernels/pack_rows.py's FieldC and SpecC
struct Field {
  void* values;
  void* valid;
  int op;
  int slot;
};

struct Spec {
  int n;
  int valid_row;
  Field f[MAX_FIELDS];
};

__global__ void pack_rows_kernel(const Spec spec, int32_t* __restrict__ out, i64 cap) {
  const i64 j = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cap) return;
  uint32_t word = 0;
  for (int k = 0; k < spec.n; ++k) {
    const Field f = spec.f[k];
    if (f.op == V_I32) {
      out[f.slot * cap + j] = ((const int32_t*)f.values)[j];
    } else if (f.op == V_I64) {
      const long long v = ((const long long*)f.values)[j];
      out[f.slot * cap + j] = (int32_t)(uint32_t)(unsigned long long)v;
      out[(f.slot + 1) * cap + j] = (int32_t)(v >> 32);
    } else if (f.op == V_BOOL) {
      out[f.slot * cap + j] = ((const uint8_t*)f.values)[j] != 0;
    }
    word |= (uint32_t)(((const uint8_t*)f.valid)[j] != 0) << (k & 31);
    if ((k & 31) == 31 || k == spec.n - 1) {
      out[(spec.valid_row + (k >> 5)) * cap + j] = (int32_t)word;
      word = 0;
    }
  }
}

__global__ void unpack_rows_kernel(const Spec spec, const int32_t* __restrict__ packed,
                                   i64 cap) {
  const i64 j = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cap) return;
  uint32_t word = 0;
  for (int k = 0; k < spec.n; ++k) {
    const Field f = spec.f[k];
    if ((k & 31) == 0) word = (uint32_t)packed[(spec.valid_row + (k >> 5)) * cap + j];
    ((uint8_t*)f.valid)[j] = (word >> (k & 31)) & 1u;
    if (f.op == V_I64) {
      const unsigned long long lo = (uint32_t)packed[f.slot * cap + j];
      const long long hi = packed[(f.slot + 1) * cap + j];
      ((long long*)f.values)[j] = (long long)(((unsigned long long)hi << 32) | lo);
    } else if (f.op == V_BOOL) {
      ((uint8_t*)f.values)[j] = packed[f.slot * cap + j] != 0;
    }
  }
}

}  // namespace

// spec: a host struct laid out as Spec (the fields of one launch, the
// first of them at a multiple of 32 among the table's fields); out
// [W, cap] int32.
extern "C" int dfp_pack_rows(const void* spec, void* out, long long cap, void* stream) {
  const Spec s = *(const Spec*)spec;
  if (s.n < 1 || s.n > MAX_FIELDS || cap <= 0) return (int)cudaErrorInvalidValue;
  pack_rows_kernel<<<dfp::grid_for(cap, 256), 256, 0, (cudaStream_t)stream>>>(
      s, (int32_t*)out, cap);
  return (int)cudaGetLastError();
}

// spec as above, its values pointers the int64 / bool outputs (op V_I64 /
// V_BOOL) and its valid pointers the bool validity outputs; packed
// [W, cap] int32.
extern "C" int dfp_unpack_rows(const void* spec, const void* packed, long long cap,
                               void* stream) {
  const Spec s = *(const Spec*)spec;
  if (s.n < 1 || s.n > MAX_FIELDS || cap <= 0) return (int)cudaErrorInvalidValue;
  unpack_rows_kernel<<<dfp::grid_for(cap, 256), 256, 0, (cudaStream_t)stream>>>(
      s, (const int32_t*)packed, cap);
  return (int)cudaGetLastError();
}
