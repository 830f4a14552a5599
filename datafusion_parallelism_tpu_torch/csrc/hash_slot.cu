// K1 hash_slot: row hash over 1-16 key columns, and its hash-table bucket.
// A key of more columns runs as several launches of 16: each launch
// continues the `combine` fold from the hash (and the all-keys-valid flag)
// the one before left, so the hash stays bit for bit the JAX package's.
//
// Replaces the JAX package's `hash_rows` (+ `_fmix32`, `_hash_values_u32`,
// `combine`; ops/hashing.py:32-81) and `slot_of` (ops/hash_table.py:95-107),
// with the build side's null/padding mask (hash_table.py:114-116). Bit for
// bit the same hash: murmur3 fmix32 per column, boost-style combine, a
// reserved hash for NULL keys, -0.0 hashed as 0.0, int64 as
// fmix32(lo ^ fmix32(hi) * 0x9E3779B1) with hi the arithmetic high word.
//
// Bound on the H100: memory traffic. Per row it reads each key column's
// one or two words and its validity word and writes 8 bytes, against ~20
// integer ops per column. One thread per row, words in word-major [R, n]
// rows, so every load and store of a warp is one coalesced 128-byte line.
// The join hands over its `key_words` rows (key words plus 0/1 validity
// rows), the rows K2 also puts into table order for K3's recheck, so no
// separate key matrix is built for the hash.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

constexpr uint32_t SEED = 0x9747B28Cu;
constexpr uint32_t NULL_HASH = 0xDEADBEEFu;
constexpr int MAX_COLS = 16;

// Per key column: its kind (0 int32 word, 1 int64 (lo, hi), 2 float32,
// 3 float64 (lo, hi)), the word rows of its lo and hi words (hi unused for
// one-word kinds), and the word row and bit of its validity.
struct HashSpec {
  int n_cols;
  int kind[MAX_COLS];
  int lo[MAX_COLS];
  int hi[MAX_COLS];
  int vrow[MAX_COLS];
  int vbit[MAX_COLS];
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t combine(uint32_t h, uint32_t hv) {
  return h ^ (hv + 0x9E3779B9u + (h << 6) + (h >> 2));
}

// num_rows (device scalar) marks the build side: rows at or past it, and
// rows with any null key, go to bucket T; so do rows whose row_mask byte is
// 0 (a chain-fused build side's build_valid, JAX ops/join.py:221-225).
// hash_in / ok_in (either may be null) carry the fold of an earlier launch
// over the key's first columns; ok_out (may be null) receives the flag for
// the next one.
__global__ void hash_slot_kernel(const int32_t* __restrict__ words, HashSpec spec,
                                 dfp::i64 n, dfp::i64 T,
                                 const int32_t* __restrict__ num_rows,
                                 const uint8_t* __restrict__ row_mask,
                                 const int32_t* __restrict__ hash_in,
                                 const uint8_t* ok_in,  // may alias ok_out
                                 int32_t* __restrict__ hash_out,
                                 int32_t* __restrict__ slot_out,
                                 uint8_t* ok_out) {
  const dfp::i64 i = (dfp::i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t h = hash_in != nullptr ? (uint32_t)hash_in[i] : SEED;
  bool ok = ok_in != nullptr ? ok_in[i] != 0 : true;
  // unrolled over MAX_COLS so that the spec is read at constant indices
  // from the parameter bank, not copied to local memory (a loop bounded by
  // spec.n_cols ran 3-4x slower on the H100)
#pragma unroll
  for (int c = 0; c < MAX_COLS; ++c) {
    if (c >= spec.n_cols) break;
    const int kind = spec.kind[c];
    uint32_t lo = (uint32_t)words[(dfp::i64)spec.lo[c] * n + i];
    uint32_t hv;
    if (kind == 0 || kind == 2) {
      if (kind == 2 && (lo & 0x7FFFFFFFu) == 0) lo = 0;
      hv = fmix32(lo);
    } else {
      uint32_t hi = (uint32_t)words[(dfp::i64)spec.hi[c] * n + i];
      if (kind == 3 && lo == 0 && (hi & 0x7FFFFFFFu) == 0) hi = 0;
      hv = fmix32(lo ^ (fmix32(hi) * 0x9E3779B1u));
    }
    const uint32_t vw = (uint32_t)words[(dfp::i64)spec.vrow[c] * n + i];
    const bool v = ((vw >> spec.vbit[c]) & 1u) != 0;
    ok = ok && v;
    h = combine(h, v ? hv : NULL_HASH);
  }
  hash_out[i] = (int32_t)h;
  if (ok_out != nullptr) ok_out[i] = ok ? 1 : 0;
  if (slot_out != nullptr) {
    dfp::i64 s;
    if ((T & (T - 1)) == 0) {
      s = (dfp::i64)(h & (uint32_t)(T - 1));
    } else {  // Lemire multiply-shift: floor(h * T / 2^32)
      s = (dfp::i64)(((unsigned long long)h * (unsigned long long)T) >> 32);
    }
    if (num_rows != nullptr && (i >= (dfp::i64)*num_rows || !ok)) s = T;
    if (row_mask != nullptr && !row_mask[i]) s = T;
    slot_out[i] = (int32_t)s;
  }
}

}  // namespace

// words [R, n] int32; spec is a host array laid out as HashSpec.
extern "C" int dfp_hash_slot(const void* words, const int* spec, long long n, long long T,
                             const void* num_rows, const void* row_mask, const void* hash_in,
                             const void* ok_in, void* hash_out, void* slot_out, void* ok_out,
                             void* stream) {
  HashSpec hs = *(const HashSpec*)spec;
  if (hs.n_cols < 1 || hs.n_cols > MAX_COLS) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    hash_slot_kernel<<<dfp::grid_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
        (const int32_t*)words, hs, n, T, (const int32_t*)num_rows, (const uint8_t*)row_mask,
        (const int32_t*)hash_in, (const uint8_t*)ok_in, (int32_t*)hash_out, (int32_t*)slot_out,
        (uint8_t*)ok_out);
  }
  return (int)cudaGetLastError();
}
