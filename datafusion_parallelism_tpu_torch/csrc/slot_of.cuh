// A hash's bucket or home slot in [0, T): the JAX package's `slot_of`
// (ops/hash_table.py:95-107), shared by K1's buckets, K15's placement and
// K16's probe walks, so that all three compute the same slot.
//
// A mask for a power of two, else Lemire's multiply-shift reduction
// floor(hash * T / 2^32) (the product of two values below 2^32 fits in 64
// bits).

#pragma once

#include <cstdint>

namespace dfp {
namespace {

__device__ __forceinline__ long long slot_of(uint32_t hash, uint64_t T) {
  return (long long)((T & (T - 1)) == 0 ? hash & (T - 1) : ((uint64_t)hash * T) >> 32);
}

}  // namespace
}  // namespace dfp
