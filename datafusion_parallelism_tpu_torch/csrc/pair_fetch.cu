// K9 pair_fetch: every candidate pair's whole build and probe rows, and the
// key recheck by value.
//
// Replaces the JAX package's full-fetch join body (ops/join.py:322-357):
// `replicate_rows_exact` over whole probe rows, the perm-ordered build rows'
// `take_rows(pos)`, `unpack_table` and the value recheck under
// `jnp.promote_types`.
//
// Bound on the H100: memory traffic, most of it random. Each output slot
// writes Wb + Wp words and Fb + Fp float64s, coalesced across the warp,
// and reads the same amount: the build row at a random perm position and
// the probe row of its candidate range (neighbouring slots mostly share
// it). As in K3, one thread owns one output slot and finds its probe row
// by a binary search over the candidate bases, so a probe row with
// millions of candidates (a hot key) costs no more per slot than one with
// a single candidate, and no replicated probe matrix is written first.
//
//   slot j < min(total, out_cap): probe row i = the last row with
//     base[i] <= j, build perm position pos = start[i] + j - base[i];
//     out_b[:, j] = build words at pos (float64 sidecars from their word
//     pairs), out_p[:, j] = probe words and sidecars at i; match = every
//     key equal in its promoted type (float64 if either side is, else
//     float32 if either is, else int64) and valid on both sides;
//   slots past it: zeros, match 0, probe_idx = build_id = 0.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

using dfp::i64;

constexpr int MAX_KEYS = 4;
enum { KEY_I32 = 0, KEY_I64 = 1, KEY_F32 = 2, KEY_F64 = 3 };

// Per key: kinds and word rows of both sides (a probe float64 key's row is
// its sidecar row), and each side's validity word row and bit.
struct FetchSpec {
  int n;
  int bkind[MAX_KEYS];
  int brow[MAX_KEYS];
  int pkind[MAX_KEYS];
  int prow[MAX_KEYS];
  int bvrow[MAX_KEYS];
  int bvbit[MAX_KEYS];
  int pvrow[MAX_KEYS];
  int pvbit[MAX_KEYS];
};

__device__ __forceinline__ long long pair64(int32_t lo, int32_t hi) {
  return ((long long)hi << 32) | (long long)(uint32_t)lo;
}

// One key value in each compare type: int64, float32 and float64 (the
// caller reads the one its promoted type names).
struct KeyVal {
  long long i;
  float f;
  double d;
};

__device__ __forceinline__ KeyVal key_value(int kind, int32_t w0, int32_t w1, double f64) {
  KeyVal k;
  long long iv = 0;
  float fv = 0.0f;
  double dv = 0.0;
  switch (kind) {
    case KEY_I32: iv = (long long)w0; fv = __ll2float_rn(iv); dv = __ll2double_rn(iv); break;
    case KEY_I64: iv = pair64(w0, w1); fv = __ll2float_rn(iv); dv = __ll2double_rn(iv); break;
    case KEY_F32: fv = __int_as_float(w0); dv = (double)fv; break;
    default: dv = f64; break;
  }
  k.i = iv;
  k.f = fv;
  k.d = dv;
  return k;
}

__global__ void pair_fetch_kernel(const int32_t* __restrict__ start,
                                  const int32_t* __restrict__ base,
                                  const i64* __restrict__ total, i64 m,
                                  const int32_t* __restrict__ pwords, int wp,
                                  const double* __restrict__ pf64, int fp,
                                  const int32_t* __restrict__ bwords, int wb, int fb,
                                  i64 b_stride, FetchSpec spec, i64 out_cap, bool and_match,
                                  int32_t* __restrict__ out_b, double* __restrict__ out_bf,
                                  int32_t* __restrict__ out_p, double* __restrict__ out_pf,
                                  int32_t* __restrict__ probe_idx,
                                  int32_t* __restrict__ build_id,
                                  uint8_t* __restrict__ match) {
  const i64 j = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= out_cap) return;
  if (j >= *total) {
    if (and_match) return;  // the first launch zeroed this slot
    for (int w = 0; w < wb; ++w) out_b[w * out_cap + j] = 0;
    for (int f = 0; f < fb; ++f) out_bf[f * out_cap + j] = 0.0;
    for (int w = 0; w < wp; ++w) out_p[w * out_cap + j] = 0;
    for (int f = 0; f < fp; ++f) out_pf[f * out_cap + j] = 0.0;
    probe_idx[j] = 0;
    build_id[j] = 0;
    match[j] = 0;
    return;
  }
  // the last probe row whose base is <= j owns slot j (base[0] == 0)
  i64 lo = 0, hi = m;
  while (hi - lo > 1) {
    const i64 mid = (lo + hi) >> 1;
    if ((i64)base[mid] <= j) lo = mid; else hi = mid;
  }
  const i64 i = lo;
  const i64 pos = (i64)start[i] + (j - (i64)base[i]);
  if (!and_match) {
    for (int w = 0; w < wb; ++w) out_b[w * out_cap + j] = bwords[w * b_stride + pos];
    for (int f = 0; f < fb; ++f) {
      const long long bits = pair64(bwords[(wb + 2 * f) * b_stride + pos],
                                    bwords[(wb + 2 * f + 1) * b_stride + pos]);
      out_bf[f * out_cap + j] = __longlong_as_double(bits);
    }
    for (int w = 0; w < wp; ++w) out_p[w * out_cap + j] = pwords[w * m + i];
    for (int f = 0; f < fp; ++f) out_pf[f * out_cap + j] = pf64[f * m + i];
  }

  bool eq = true;
  for (int k = 0; k < spec.n; ++k) {
    const int bk = spec.bkind[k], pk = spec.pkind[k];
    const int cls = (bk == KEY_F64 || pk == KEY_F64) ? 2 : (bk == KEY_F32 || pk == KEY_F32) ? 1 : 0;
    const i64 br = spec.brow[k];
    const int32_t b0 = bwords[br * b_stride + pos];
    const int32_t b1 = (bk == KEY_I64 || bk == KEY_F64) ? bwords[(br + 1) * b_stride + pos] : 0;
    const KeyVal bv = key_value(bk, b0, b1,
                                bk == KEY_F64 ? __longlong_as_double(pair64(b0, b1)) : 0.0);
    const i64 pr = spec.prow[k];
    const int32_t p0 = pk == KEY_F64 ? 0 : pwords[pr * m + i];
    const int32_t p1 = pk == KEY_I64 ? pwords[(pr + 1) * m + i] : 0;
    const KeyVal pv = key_value(pk, p0, p1, pk == KEY_F64 ? pf64[pr * m + i] : 0.0);
    const bool same = cls == 2 ? bv.d == pv.d : cls == 1 ? bv.f == pv.f : bv.i == pv.i;
    const uint32_t bvw = (uint32_t)bwords[(i64)spec.bvrow[k] * b_stride + pos];
    const uint32_t pvw = (uint32_t)pwords[(i64)spec.pvrow[k] * m + i];
    eq = eq && same && ((bvw >> spec.bvbit[k]) & 1u) && ((pvw >> spec.pvbit[k]) & 1u);
  }
  if (and_match) {  // a later group of the keys: only the match changes
    match[j] = (match[j] && eq) ? 1 : 0;
    return;
  }
  match[j] = eq ? 1 : 0;
  probe_idx[j] = (int32_t)i;
  build_id[j] = bwords[(i64)(wb + 2 * fb) * b_stride + pos];
}

}  // namespace

// start/base [m] int32 and total64 (device int64) from K3's probe_ranges;
// pwords [wp, m] int32, pf64 [fp, m] float64; bwords [wb + 2 fb + 1,
// b_stride] int32 in perm order (packed words, float64 (lo, hi) pairs, row
// id); spec a host array laid out as FetchSpec. Out: out_b [wb, out_cap],
// out_bf [fb, out_cap], out_p [wp, out_cap], out_pf [fp, out_cap],
// probe_idx, build_id and match [out_cap]. More than 4 keys run as several
// launches, the later ones with and_match set: they AND their recheck into
// match and write nothing else.
extern "C" int dfp_pair_fetch(const void* start, const void* base, const void* total64,
                              long long m, const void* pwords, int wp, const void* pf64, int fp,
                              const void* bwords, int wb, int fb, long long b_stride,
                              const int* spec, long long out_cap, int and_match, void* out_b,
                              void* out_bf,
                              void* out_p, void* out_pf, void* probe_idx, void* build_id,
                              void* match, void* stream) {
  const FetchSpec fs = *(const FetchSpec*)spec;
  if (fs.n < 1 || fs.n > MAX_KEYS || m <= 0) return (int)cudaErrorInvalidValue;
  if (out_cap > 0) {
    pair_fetch_kernel<<<dfp::grid_for(out_cap, 256), 256, 0, (cudaStream_t)stream>>>(
        (const int32_t*)start, (const int32_t*)base, (const i64*)total64, m,
        (const int32_t*)pwords, wp, (const double*)pf64, fp, (const int32_t*)bwords, wb, fb,
        b_stride, fs, out_cap, and_match != 0, (int32_t*)out_b, (double*)out_bf, (int32_t*)out_p,
        (double*)out_pf, (int32_t*)probe_idx, (int32_t*)build_id, (uint8_t*)match);
  }
  return (int)cudaGetLastError();
}
