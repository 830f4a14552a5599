// K3 probe_expand: candidate ranges of the probe rows, and the candidates
// themselves with the key recheck.
//
// Replaces the JAX package's `probe_ranges` / `probe_candidates` (CSR
// branch, ops/hash_table.py:247-288), `replicate_rows_exact`
// (utils/columnar.py:650-680) and the deferred join body's candidate fetch
// and key recheck (ops/join.py:277-320).
//
// Bound on the H100: random access. Pass 1 reads one 8-byte bucket
// descriptor per probe row from a table of T+1 buckets (64 MB at T = 2^24,
// larger than the 50 MB L2); pass 2 reads the build's narrow words at one
// random position per candidate. The JAX package replicates probe rows
// with a scatter-max and a cummax over the output; here each output slot
// finds its probe row itself by a binary search over the candidate bases,
// so the work per thread is the same whether a probe row owns one
// candidate or millions (a hot key), and no replicated matrix is written.
//
//   pass 1, one thread per probe row: start, count = start_count[:, slot];
//           count = 0 for a row out of range or with a null key;
//   scan:   base = exclusive cumsum of count (scan.cuh), total in int64 —
//           the JAX int32 cumsum would wrap past 2^31; the wrapper raises;
//   pass 2, one thread per output slot j < min(total, out_cap): probe row
//           i = the last row with base[i] <= j, pos = start[i] + j - base[i];
//           match = key words equal and both validity bits set. Slots past
//           min(total, out_cap) read match = 0, probe_idx = build_id = 0.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

using dfp::i64;

constexpr int MAX_EQ = 8;     // key words compared (4 keys x 2 words)
constexpr int MAX_KEYS = 4;

// The key-recheck plan (ops/join.py `_defer_key_plan`): word rows to compare
// and, per key column, the validity word row and bit on each side.
struct KeySpec {
  int n_eq;
  int eq_b[MAX_EQ];
  int eq_p[MAX_EQ];
  int n_keys;
  int vb_row[MAX_KEYS];
  int vb_bit[MAX_KEYS];
  int vp_row[MAX_KEYS];
  int vp_bit[MAX_KEYS];
};

__global__ void probe_ranges_kernel(const int32_t* __restrict__ slot,
                                    const uint8_t* __restrict__ ok, i64 m,
                                    const int32_t* __restrict__ start_count, i64 T1,
                                    int32_t* __restrict__ start, int32_t* __restrict__ count) {
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int32_t s = slot[i];
  start[i] = start_count[s];
  count[i] = ok[i] ? start_count[T1 + s] : 0;
}

__global__ void probe_expand_kernel(const int32_t* __restrict__ start,
                                    const int32_t* __restrict__ base,
                                    const i64* __restrict__ total, i64 m,
                                    const int32_t* __restrict__ pwords, i64 p_stride,
                                    const int32_t* __restrict__ bwords, i64 b_stride,
                                    int n_bwords, KeySpec spec, i64 out_cap,
                                    bool and_match, uint8_t* __restrict__ match,
                                    int32_t* __restrict__ probe_idx,
                                    int32_t* __restrict__ build_id) {
  const i64 j = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= out_cap) return;
  const i64 t = *total;
  if (j >= t) {  // j < out_cap already
    match[j] = 0;
    probe_idx[j] = 0;
    build_id[j] = 0;
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
  bool eq = true;
  for (int k = 0; k < spec.n_eq; ++k)
    eq = eq && bwords[(i64)spec.eq_b[k] * b_stride + pos] == pwords[(i64)spec.eq_p[k] * p_stride + i];
  for (int k = 0; k < spec.n_keys; ++k) {
    const uint32_t bw = (uint32_t)bwords[(i64)spec.vb_row[k] * b_stride + pos];
    const uint32_t pw = (uint32_t)pwords[(i64)spec.vp_row[k] * p_stride + i];
    eq = eq && ((bw >> spec.vb_bit[k]) & 1u) && ((pw >> spec.vp_bit[k]) & 1u);
  }
  if (and_match) {  // a later group of the key's columns: probe_idx, build_id are set
    match[j] = (match[j] && eq) ? 1 : 0;
    return;
  }
  match[j] = eq ? 1 : 0;
  probe_idx[j] = (int32_t)i;
  build_id[j] = bwords[(i64)(n_bwords - 1) * b_stride + pos];
}

}  // namespace

extern "C" long long dfp_probe_ranges_scratch_bytes(long long m) {
  return dfp::scan_scratch_bytes(m);
}

// Pass 1 + scan. start_count is [2, T1] (T1 = T + 1); total64 is a device
// int64.
extern "C" int dfp_probe_ranges(const void* slot, const void* ok, long long m,
                                const void* start_count, long long T1, void* start,
                                void* count, void* base, void* total64, void* scratch,
                                long long scratch_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (scratch_bytes < dfp::scan_scratch_bytes(m)) return (int)cudaErrorInvalidValue;
  if (m > 0) {
    probe_ranges_kernel<<<dfp::grid_for(m, 256), 256, 0, st>>>(
        (const int32_t*)slot, (const uint8_t*)ok, m, (const int32_t*)start_count, T1,
        (int32_t*)start, (int32_t*)count);
  }
  dfp::exclusive_scan<int32_t, int32_t>((const int32_t*)count, m, (int32_t*)base,
                                        (i64*)total64, scratch, st);
  return (int)cudaGetLastError();
}

// Pass 2. pwords [*, p_stride] are the probe's narrow words; bwords
// [n_bwords, b_stride] the build's narrow words in perm order, the last row
// the build row id. spec is a host array laid out as KeySpec. A key past
// the spec's 4 columns or 8 words runs as several launches, the later ones
// with and_match set: they AND their recheck into match and leave
// probe_idx and build_id as the first launch wrote them.
extern "C" int dfp_probe_expand(const void* start, const void* base, const void* total64,
                                long long m, const void* pwords, long long p_stride,
                                const void* bwords, long long b_stride, int n_bwords,
                                const int* spec, long long out_cap, int and_match, void* match,
                                void* probe_idx, void* build_id, void* stream) {
  KeySpec ks = *(const KeySpec*)spec;
  if (ks.n_eq > MAX_EQ || ks.n_keys > MAX_KEYS || m <= 0) return (int)cudaErrorInvalidValue;
  if (out_cap > 0) {
    probe_expand_kernel<<<dfp::grid_for(out_cap, 256), 256, 0, (cudaStream_t)stream>>>(
        (const int32_t*)start, (const int32_t*)base, (const i64*)total64, m,
        (const int32_t*)pwords, p_stride, (const int32_t*)bwords, b_stride, n_bwords, ks,
        out_cap, and_match != 0, (uint8_t*)match, (int32_t*)probe_idx, (int32_t*)build_id);
  }
  return (int)cudaGetLastError();
}
