// K6 radix_sort: stable lexicographic argsort over k 32-bit key words.
//
// Replaces the JAX package's multi-operand `jax.lax.sort(..., num_keys=k,
// is_stable=True)` of `sort_table` (ops/sort.py:31-56), of the grouping
// sorts (ops/aggregate.py:288-317) and the argsorts of the SORT and OA
// builds' composite keys (ops/hash_table.py:129 `build_sorted`, :142
// `build_oa`). The caller hands the keys over as int32 word rows [k, n],
// most significant first, each compared as signed or unsigned: an int64
// key is its signed high word then its unsigned low word, a float64 key
// first maps to an order-preserving int64.
//
// Bound on the H100: memory traffic, per digit pass. The host reads each
// word's AND and OR over the rows (dfp_key_span, one synchronisation): a
// bit varies only where they differ, and a bit every row shares cannot
// reorder anything. onesweep.cuh packs the B varying bits of word ^ flip
// (flip = 0x80000000 for a signed word) into one key a row, 32 bits where
// B <= 32, 64 where B <= 64, else 32-bit chunks, then sorts by 8-bit digits
// of the packed key, one launch a digit that reads its keys once, counts
// the next digit's histogram and writes runs: about 2 + passes launches,
// 16 (32-bit keys) or 24 (64-bit) bytes a row moved per pass.

#include <cstdint>
#include <cuda_runtime.h>

#include "onesweep.cuh"
#include "scan.cuh"

namespace {

using dfp::i64;

__global__ void key_span_kernel(const int32_t* __restrict__ words, int k, i64 n,
                                uint32_t* __restrict__ span) {
  const int w = blockIdx.y;
  uint32_t a = 0xFFFFFFFFu, o = 0;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (i64)gridDim.x * blockDim.x) {
    const uint32_t v = (uint32_t)words[(i64)w * n + i];
    a &= v;
    o |= v;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    a &= __shfl_xor_sync(0xffffffffu, a, d);
    o |= __shfl_xor_sync(0xffffffffu, o, d);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAnd(&span[w], a);
    atomicOr(&span[k + w], o);
  }
}

__global__ void iota_kernel(i64 n, int32_t* __restrict__ out) {
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = (int32_t)i;
}

// The planned passes over packed keys of type K: pack each chunk and count
// its first digit, then one one-sweep launch a digit.
template <class K>
void onesweep_sort(const int32_t* words, i64 n, const dfp::PackWords& pw, int bits,
                   const int* pass_chunk, const int* pass_shift, const int* pass_width,
                   int n_passes, int32_t* perm, const dfp::OneSweepScratch& s, cudaStream_t st) {
  const int chunks = (bits + 8 * (int)sizeof(K) - 1) / (8 * (int)sizeof(K));
  unsigned gx = dfp::grid_for(n, dfp::OS_BLOCK * dfp::PACK_ROWS);
  if (gx > 1024) gx = 1024;
  for (int c = 0, p = 0; c < chunks; ++c) {
    while (pass_chunk[p] != c) ++p;  // the chunk's first pass
    K* out = c == 0 ? (K*)s.keys_a : (K*)s.chunks + (i64)(c - 1) * n;
    dfp::pack_hist_kernel<K><<<gx, dfp::OS_BLOCK, 0, st>>>(words, n, pw, c, pass_width[p], out,
                                                           s.hist + (i64)p * dfp::OS_RADIX);
  }
  cudaFuncSetAttribute(dfp::onesweep_pass_kernel<K, false>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, dfp::os_pass_smem<K>());
  cudaFuncSetAttribute(dfp::onesweep_pass_kernel<K, true>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, dfp::os_pass_smem<K>());
  const unsigned tiles = (unsigned)((n + dfp::os_tile_rows(sizeof(K)) - 1) /
                                    dfp::os_tile_rows(sizeof(K)));
  const K* kin = (const K*)s.keys_a;
  const int32_t* vin = nullptr;
  for (int p = 0; p < n_passes; ++p) {
    const bool last = p == n_passes - 1;
    const bool gather = p > 0 && pass_chunk[p] != pass_chunk[p - 1];
    if (gather) kin = (const K*)s.chunks + (i64)(pass_chunk[p] - 1) * n;
    K* kout = nullptr;
    if (!last && pass_chunk[p + 1] == pass_chunk[p])
      kout = kin == (const K*)s.keys_a ? (K*)s.keys_b : (K*)s.keys_a;
    int32_t* vout = last ? perm : (vin == s.vals_a ? s.vals_b : s.vals_a);
    // the next pass's digit, where it is one of these keys'
    const int next_width = kout != nullptr ? pass_width[p + 1] : 0;
    const int next_shift = kout != nullptr ? pass_shift[p + 1] : 0;
    int32_t* hist = s.hist + (i64)p * dfp::OS_RADIX;
    if (gather) {
      dfp::onesweep_pass_kernel<K, true><<<tiles, dfp::OS_BLOCK, dfp::os_pass_smem<K>(), st>>>(
          kin, vin, n, pass_shift[p], pass_width[p], next_shift, next_width, (uint64_t)p + 1,
          hist, hist + dfp::OS_RADIX, s.counters + p, s.status, kout, vout);
    } else {
      dfp::onesweep_pass_kernel<K, false><<<tiles, dfp::OS_BLOCK, dfp::os_pass_smem<K>(), st>>>(
          kin, vin, n, pass_shift[p], pass_width[p], next_shift, next_width, (uint64_t)p + 1,
          hist, hist + dfp::OS_RADIX, s.counters + p, s.status, kout, vout);
    }
    kin = kout;
    vin = vout;
  }
}

}  // namespace

// span[w] = AND and span[k + w] = OR of word row w over the n rows: the
// bits that vary between rows, from which the host plans the sort.
extern "C" int dfp_key_span(const void* words, int k, long long n, void* span, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(span, 0xFF, (size_t)k * 4, st);
  cudaMemsetAsync((uint32_t*)span + k, 0, (size_t)k * 4, st);
  if (n > 0 && k > 0) {
    unsigned gx = dfp::grid_for(n, 256);
    if (gx > 1024) gx = 1024;
    key_span_kernel<<<dim3(gx, (unsigned)k), 256, 0, st>>>((const int32_t*)words, k, n,
                                                          (uint32_t*)span);
  }
  return (int)cudaGetLastError();
}

extern "C" long long dfp_radix_sort_scratch_bytes(long long n, int bits, int n_passes) {
  return dfp::onesweep_carve(nullptr, n, bits, n_passes).bytes;
}

// words [k, n] int32 -> perm [n]. masks[w] are word w's varying bits,
// flips[w] 0x80000000 for a signed word; pass p sorts stably by the digit
// of width pass_width[p] at pass_shift[p] of packed-key chunk
// pass_chunk[p], least significant first (kernels/radix_sort.py plans
// them). No varying bit: the identity.
extern "C" int dfp_radix_sort(const void* words, int k, long long n, const unsigned* masks,
                              const unsigned* flips, const int* pass_chunk, const int* pass_shift,
                              const int* pass_width, int n_passes, void* perm, void* scratch,
                              long long scratch_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  if (k < 1 || k > dfp::OS_MAX_WORDS) return (int)cudaErrorInvalidValue;
  dfp::PackWords pw{};
  pw.k = k;
  int bits = 0;
  for (int w = k - 1; w >= 0; --w) {
    pw.mask[w] = masks[w];
    pw.flip[w] = flips[w];
    pw.offset[w] = bits;
    bits += __builtin_popcount(masks[w]);
  }
  if (bits == 0 || n_passes == 0) {
    iota_kernel<<<dfp::grid_for(n, 256), 256, 0, st>>>(n, (int32_t*)perm);
    return (int)cudaGetLastError();
  }
  // passes in chunk order, digits of 1-8 bits inside a chunk, the first at
  // its lowest bit
  const int cw = 8 * dfp::os_key_bytes(bits);
  for (int p = 0, run = 0; p < n_passes; ++p) {
    run = p > 0 && pass_chunk[p] == pass_chunk[p - 1] ? run + 1 : 1;
    if (pass_chunk[p] < 0 || pass_chunk[p] > (bits - 1) / cw ||
        (p > 0 && pass_chunk[p] < pass_chunk[p - 1]) || run > cw / 8 ||
        pass_width[p] < 1 || pass_width[p] > 8 || pass_shift[p] < 0 ||
        pass_shift[p] + pass_width[p] > cw || (run == 1 && pass_shift[p] != 0))
      return (int)cudaErrorInvalidValue;
  }
  const dfp::OneSweepScratch s = dfp::onesweep_carve((char*)scratch, n, bits, n_passes);
  if (scratch_bytes < s.bytes) return (int)cudaErrorInvalidValue;
  cudaMemsetAsync(scratch, 0, (size_t)s.zero_bytes, st);
  if (dfp::os_key_bytes(bits) == 4) {
    onesweep_sort<uint32_t>((const int32_t*)words, n, pw, bits, pass_chunk, pass_shift,
                            pass_width, n_passes, (int32_t*)perm, s, st);
  } else {
    onesweep_sort<uint64_t>((const int32_t*)words, n, pw, bits, pass_chunk, pass_shift,
                            pass_width, n_passes, (int32_t*)perm, s, st);
  }
  return (int)cudaGetLastError();
}
