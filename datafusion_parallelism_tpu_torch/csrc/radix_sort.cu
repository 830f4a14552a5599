// K6 radix_sort: stable lexicographic argsort over k 32-bit key words.
//
// Replaces the JAX package's multi-operand `jax.lax.sort(..., num_keys=k,
// is_stable=True)` of `sort_table` (ops/sort.py:31-56) and of the grouping
// sorts (ops/aggregate.py:288-317). The caller hands the keys over as int32
// word rows [k, n], most significant first, each compared as signed or
// unsigned: an int64 key is its signed high word then its unsigned low
// word, a float64 key first maps to an order-preserving int64.
//
// Bound on the H100: memory traffic, per digit pass. The sort is a stable
// LSD radix sort, 8 bits a pass, least significant word first: radix.cuh's
// pass, which K2 csr_build shares, linear in the rows whatever the key
// distribution. The signed words have their sign bit flipped as the digit
// is read. The host plans the passes: a digit that every row shares cannot
// reorder anything and is skipped, so a sort on small ints runs a few
// passes, not 4 per word. The first pass of a word reads the word through
// the current permutation (a gather); the passes after it carry the key
// beside the row id, so their reads are coalesced.

#include <cstdint>
#include <cuda_runtime.h>

#include "radix.cuh"
#include "scan.cuh"

namespace {

using dfp::i64;

// the key of row i is word[vals[i]]: a new word read through the current
// permutation (vals == nullptr: the identity)
struct GatheredKey {
  const int32_t* word;
  const int32_t* vals;
  __device__ __forceinline__ uint32_t operator()(i64 i) const {
    return (uint32_t)__ldg(word + (vals != nullptr ? (i64)__ldg(vals + i) : i));
  }
};

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

}  // namespace

// span[w] = AND and span[k + w] = OR of word row w over the n rows: the
// bits that vary between rows, from which the host plans the passes.
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

extern "C" long long dfp_radix_sort_scratch_bytes(long long n) {
  return dfp::radix_carve(nullptr, n, 0).bytes;
}

// words [k, n] int32 -> perm [n]: the passes run in the order given, pass
// p sorting stably by the 8-bit digit at pass_shift[p] of word
// pass_word[p] XOR pass_flip[p] (0x80000000 for a signed word). No pass:
// the identity.
extern "C" int dfp_radix_sort(const void* words, long long n, const int* pass_word,
                              const int* pass_shift, const unsigned* pass_flip, int n_passes,
                              void* perm, void* scratch, long long scratch_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  const dfp::RadixScratch s = dfp::radix_carve((char*)scratch, n, 0);
  if (scratch_bytes < s.bytes) return (int)cudaErrorInvalidValue;
  if (n_passes == 0) {
    iota_kernel<<<dfp::grid_for(n, 256), 256, 0, st>>>(n, (int32_t*)perm);
    return (int)cudaGetLastError();
  }
  const int32_t* kin = nullptr;
  const int32_t* vin = nullptr;
  for (int p = 0; p < n_passes; ++p) {
    const bool last = p == n_passes - 1;
    const int32_t* word = (const int32_t*)words + (i64)pass_word[p] * n;
    if (p > 0 && pass_word[p - 1] != pass_word[p]) kin = nullptr;  // gather the new word
    int32_t* kout = nullptr;
    if (!last && pass_word[p + 1] == pass_word[p]) kout = kin == s.keys_a ? s.keys_b : s.keys_a;
    int32_t* vout = last ? (int32_t*)perm : (vin == s.vals_a ? s.vals_b : s.vals_a);
    if (kin != nullptr) {
      dfp::radix_pass(dfp::CarriedKey{kin}, vin, n, pass_shift[p], pass_flip[p], s, kout, vout,
                      dfp::NoEmit{}, st);
    } else {
      dfp::radix_pass(GatheredKey{word, vin}, vin, n, pass_shift[p], pass_flip[p], s, kout,
                      vout, dfp::NoEmit{}, st);
    }
    kin = kout;
    vin = vout;
  }
  return (int)cudaGetLastError();
}
