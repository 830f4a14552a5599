// What K7 segment_agg and K8 direct_agg share: the aggregate requests they
// compute (AggSpec, laid out as kernels/_agg.py's AggSpecC), each request's
// accumulator operation, its identity and the value a row contributes.
//
// A request is (func, input column, validity): func 0 count, 1 sum, 2 min,
// 3 max; input type 0 int32, 1 int64, 2 float32, 3 float64, 4 bool (one
// byte). Counts and integer sums and min/max accumulate in int64 (sums
// wrap, as the JAX package's int64 sums do), float inputs in float64. Every
// accumulator travels as 64 bits (a double as its bits), so one code path
// serves both types.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dfp {
namespace {

constexpr int MAX_AGGS = 32;

struct AggSpec {
  int n;
  int func[MAX_AGGS];
  int in_type[MAX_AGGS];
  const void* vals[MAX_AGGS];
  const void* valid[MAX_AGGS];  // nullptr: every row valid
};

enum AggOp { OP_ISUM = 0, OP_DSUM = 1, OP_IMIN = 2, OP_IMAX = 3, OP_DMIN = 4, OP_DMAX = 5 };

__host__ __device__ __forceinline__ int agg_op(int func, int in_type) {
  const bool dbl = func != 0 && (in_type == 2 || in_type == 3);
  switch (func) {
    case 2: return dbl ? OP_DMIN : OP_IMIN;
    case 3: return dbl ? OP_DMAX : OP_IMAX;
    default: return dbl ? OP_DSUM : OP_ISUM;  // count is an int64 sum of 0/1
  }
}

__device__ __forceinline__ long long dbits(double x) { return __double_as_longlong(x); }
__device__ __forceinline__ double bitsd(long long b) { return __longlong_as_double(b); }

__device__ __forceinline__ long long agg_identity(int op) {
  switch (op) {
    case OP_IMIN: return 0x7FFFFFFFFFFFFFFFLL;
    case OP_IMAX: return (long long)0x8000000000000000ULL;
    case OP_DMIN: return 0x7FF0000000000000LL;                  // +inf
    case OP_DMAX: return (long long)0xFFF0000000000000ULL;      // -inf
    default: return 0;  // +0 and 0.0 have the same bits
  }
}

// a (earlier rows) combined with b (later rows). Float min/max propagate a
// NaN, as torch's amin/amax and jnp.minimum/maximum do; ties keep a.
__device__ __forceinline__ long long agg_combine(int op, long long a, long long b) {
  switch (op) {
    case OP_ISUM: return (long long)((unsigned long long)a + (unsigned long long)b);
    case OP_DSUM: return dbits(bitsd(a) + bitsd(b));
    case OP_IMIN: return b < a ? b : a;
    case OP_IMAX: return b > a ? b : a;
    case OP_DMIN: {
      const double x = bitsd(a), y = bitsd(b);
      if (x != x) return a;
      if (y != y) return b;
      return y < x ? b : a;
    }
    default: {  // OP_DMAX
      const double x = bitsd(a), y = bitsd(b);
      if (x != x) return a;
      if (y != y) return b;
      return y > x ? b : a;
    }
  }
}

// The accumulator bits row i adds to request r (the identity where the
// input is NULL). The value is read whatever the validity, so that the two
// reads are in flight together.
__device__ __forceinline__ long long agg_row_value(const AggSpec& s, int r, int op, long long i) {
  const uint8_t* valid = (const uint8_t*)s.valid[r];
  const bool ok = valid == nullptr || valid[i];
  if (s.func[r] == 0) return ok ? 1 : 0;
  const void* v = s.vals[r];
  long long x;
  switch (s.in_type[r]) {
    case 0: x = (long long)((const int32_t*)v)[i]; break;
    case 1: x = ((const long long*)v)[i]; break;
    case 2: x = dbits((double)((const float*)v)[i]); break;
    case 3: x = ((const long long*)v)[i]; break;  // float64 bits as they are
    default: x = (long long)((const uint8_t*)v)[i]; break;
  }
  return ok ? x : agg_identity(op);
}

}  // namespace
}  // namespace dfp
