// K10 match_flags: which build rows and which probe rows matched.
//
// Replaces the JAX package's `visited` and `probe_matched` scatter-sets
// (ops/join.py:363-368: zeros, then `.at[where(match, id, cap)].set(True,
// mode="drop")`).
//
// Bound on the H100: scattered one-byte stores. It reads the match bytes
// below the candidate total and the ids of the asked flags at the matched
// slots, and writes each asked flag once (its memset) plus a byte at a
// random build row a match: Q13's 14.8 M matches into 2 MB of visited flags
// take ~0.23 ms, the stores alone, against 0.025 ms for its bytes. The
// design:
//   * only the flags the caller asks for: a join type reads one of the two
//     (LEFT, semi and anti) or both (FULL), and a flag not asked for gets
//     no memset, no id reads and no stores;
//   * only the slots below min(total, n), the total read on the card: past
//     it K3 leaves match False, so the slots there set nothing; a block
//     past them leaves at once;
//   * where the candidates are CHECK_RATIO or more times the build rows
//     (the total against bcap, read on the card), a visited flag is read
//     before it is stored: most of a build row's matches then find it set
//     and store nothing (Q13's ~10 orders a customer). Below that the read
//     costs more than the stores it saves;
//   * the visited flags alone (LEFT, semi and anti; the streamed fold):
//     a thread takes 16 slots with one 16-byte load of `match`, skips them
//     when all 16 bytes are 0, and loads the build ids 4 at a time (16
//     bytes) where any of their match bytes is set, every load issued
//     before its stores. A scalar head (the slots before `match` reaches a
//     16-byte boundary) and tail (the last ones past the 16-slot chunks)
//     run on block 0; the wrapper checks that the ids are 16-byte aligned
//     at the head's end;
//   * the probe flags asked (RIGHT, FULL, right semi and anti): a slot a
//     thread, so a warp's probe stores land on neighbouring probe rows
//     (K3 emits a probe row's candidates together, in probe order), and a
//     lane whose probe row is its left neighbour's stores nothing. (The
//     16-slot layout measured 1.3x slower here, its probe stores spread
//     over a warp's 512 slots.)
// Every writer of a flag writes the same value 1, so concurrent writes to
// one flag (a build row matched by many probe rows) are benign and need no
// atomics, and the result does not depend on the order in which the
// blocks run.
//
// Accumulate mode (`keep_visited`): the visited flags are not zero-filled,
// so the matches OR into the caller's buffer: the streamed visited fold
// across probe chunks and grace's mask merge across partitions.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

using dfp::i64;

constexpr int MF_THREADS = 256;
constexpr int MF_SLOTS = 16;    // slots a thread of visited_kernel takes: one 16-byte load
constexpr int CHECK_RATIO = 4;  // candidates a build row from which visited is read first

__device__ __forceinline__ i64 candidate_slots(const int32_t* total, i64 n) {
  if (total == nullptr) return n;
  const i64 t = *total;
  return t < 0 ? 0 : (t < n ? t : n);
}

__device__ __forceinline__ void set_flag(uint8_t* flags, i64 cap, int32_t id) {
  if (id >= 0 && id < cap) flags[id] = 1;
}

// with `check`, a flag already set is not stored again
__device__ __forceinline__ void set_visited(uint8_t* flags, i64 cap, int32_t id, bool check) {
  if (id >= 0 && id < cap && !(check && flags[id])) flags[id] = 1;
}

// the visited flags alone: 16 slots a thread
__global__ void __launch_bounds__(MF_THREADS) visited_kernel(
    const uint8_t* __restrict__ match, const int32_t* __restrict__ build_id, i64 n,
    const int32_t* __restrict__ total, int head, uint8_t* __restrict__ visited, i64 bcap) {
  const i64 k = candidate_slots(total, n);
  const bool check = k >= CHECK_RATIO * bcap;
  const i64 chunks = k > head ? (k - head) / MF_SLOTS : 0;
  if (blockIdx.x == 0 && threadIdx.x < 2 * MF_SLOTS) {  // the head, then the tail
    const i64 j = threadIdx.x < MF_SLOTS ? (i64)threadIdx.x
                                         : head + chunks * MF_SLOTS + threadIdx.x - MF_SLOTS;
    const bool mine = threadIdx.x < MF_SLOTS ? j < head && j < k : j < k;
    if (mine && match[j]) set_visited(visited, bcap, build_id[j], check);
  }
  const i64 c = (i64)blockIdx.x * MF_THREADS + threadIdx.x;
  if (c >= chunks) return;
  const i64 s0 = head + c * MF_SLOTS;
  const uint4 mv = *(const uint4*)(match + s0);
  const uint32_t w[4] = {mv.x, mv.y, mv.z, mv.w};
  if ((w[0] | w[1] | w[2] | w[3]) == 0) return;
  int4 b[4] = {};
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (w[q] != 0) b[q] = *(const int4*)(build_id + s0 + 4 * q);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int32_t bs[4] = {b[q].x, b[q].y, b[q].z, b[q].w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if ((w[q] >> (8 * e)) & 0xFFu) set_visited(visited, bcap, bs[e], check);
  }
}

// the probe flags, and the visited flags where VISITED: a slot a thread
template <bool VISITED>
__global__ void __launch_bounds__(MF_THREADS) probe_kernel(
    const uint8_t* __restrict__ match, const int32_t* __restrict__ build_id,
    const int32_t* __restrict__ probe_idx, i64 n, const int32_t* __restrict__ total,
    uint8_t* __restrict__ visited, i64 bcap, uint8_t* __restrict__ probe_matched, i64 mcap) {
  const i64 k = candidate_slots(total, n);
  if ((i64)blockIdx.x * MF_THREADS >= k) return;  // the whole block past the candidates
  const i64 j = (i64)blockIdx.x * MF_THREADS + threadIdx.x;
  const bool m = j < k && match[j];
  if (VISITED && m) set_visited(visited, bcap, build_id[j], k >= CHECK_RATIO * bcap);
  const int32_t p = m ? probe_idx[j] : -1;
  const int32_t left = __shfl_up_sync(0xffffffffu, p, 1);
  if (m && ((threadIdx.x & 31) == 0 || p != left)) set_flag(probe_matched, mcap, p);
}

}  // namespace

// match, build_id, probe_idx [n] -> visited [bcap] and/or probe_matched
// [mcap] (bytes 0/1), each asked for by a non-null pointer; the slots below
// min(*total, n) (every slot when total is null). `head` (fewer than 16)
// slots bring `match` to a 16-byte boundary, where the build ids are
// 16-byte aligned too (read only when the visited flags alone are asked).
// With keep_visited the visited flags already set stay set.
extern "C" int dfp_match_flags(const void* match, const void* build_id, const void* probe_idx,
                               long long n, const void* total, int head, void* visited,
                               long long bcap, int keep_visited, void* probe_matched,
                               long long mcap, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (visited != nullptr && !keep_visited) cudaMemsetAsync(visited, 0, (size_t)bcap, st);
  if (probe_matched != nullptr) cudaMemsetAsync(probe_matched, 0, (size_t)mcap, st);
  if (n > 0) {
    const uint8_t* m = (const uint8_t*)match;
    const int32_t *b = (const int32_t*)build_id, *p = (const int32_t*)probe_idx;
    const int32_t* t = (const int32_t*)total;
    uint8_t *v = (uint8_t*)visited, *pm = (uint8_t*)probe_matched;
    if (pm == nullptr)
      visited_kernel<<<dfp::grid_for((n + MF_SLOTS - 1) / MF_SLOTS, MF_THREADS), MF_THREADS, 0,
                       st>>>(m, b, n, t, head, v, bcap);
    else if (v != nullptr)
      probe_kernel<true><<<dfp::grid_for(n, MF_THREADS), MF_THREADS, 0, st>>>(m, b, p, n, t, v,
                                                                              bcap, pm, mcap);
    else
      probe_kernel<false><<<dfp::grid_for(n, MF_THREADS), MF_THREADS, 0, st>>>(m, b, p, n, t, v,
                                                                               bcap, pm, mcap);
  }
  return (int)cudaGetLastError();
}
