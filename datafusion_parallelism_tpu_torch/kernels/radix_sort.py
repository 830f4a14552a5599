"""K6 radix_sort: stable lexicographic argsort over 32-bit key words.

Replaces the JAX package's multi-operand `jax.lax.sort(..., num_keys=k,
is_stable=True)` in `ops/sort.py:31` (`sort_table`) and in the grouping
sorts of `ops/aggregate.py:288-317`, and the argsorts of the SORT and OA
builds' composite keys (`ops/hash_table.py:129`, `:142`). The CUDA kernel
is `csrc/radix_sort.cu` over `csrc/onesweep.cuh`, whose headers say what
bounds it on the H100; the plain version below is the same function in
torch ops. On CPU tensors the wrapper runs the plain version; on CUDA
tensors it launches the kernel or raises.

Keys are given as int32 words [k, n], most significant first, each word
compared as signed or unsigned. An int64 key is its signed high word then
its unsigned low word; a float64 key is first mapped to an order-preserving
int64 (`ops/sort.py::float_sort_bits`).

The kernel sorts one packed key: the bits that vary between rows of each
word XOR its sign flip, most significant word highest (`sort_plan` plans
it from the words' AND and OR, `pack_key_plain` is the pack kernel's
plain twin), by 8-bit digit passes, least significant first, chunk by
chunk past 64 bits.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import _build

_SIGN = 0x80000000
DIGIT_BITS = 8
# rows of one pass tile by key width (csrc/onesweep.cuh: OS_BLOCK x
# OneSweepItems)
TILE_ROWS = {32: 256 * 32, 64: 256 * 24}


def radix_sort_plain(words: torch.Tensor, signed: Sequence[bool]) -> torch.Tensor:
    """perm int32[n]: the stable argsort of the rows of `words` [k, n] int32
    in lexicographic order of (words[0], ..., words[k-1]), word w compared
    as signed when signed[w], else as unsigned."""
    k, n = words.shape
    if len(signed) != k:
        raise ValueError(f"{k} key words but {len(signed)} signed flags")
    perm = torch.arange(n, device=words.device)
    for w in reversed(range(k)):
        key = words[w].index_select(0, perm).long()
        if not signed[w]:
            key = key & 0xFFFFFFFF
        perm = perm.index_select(0, torch.argsort(key, stable=True))
    return perm.to(torch.int32)


class SortPlan(NamedTuple):
    """How the kernel sorts: word w's varying bits `masks[w]` of word ^
    `flips[w]` packed into one key of `bits` bits, held in chunks of
    `key_bits` bits (64 where 32 < bits <= 64, else 32; 0: no chunk, the
    identity); `passes` (chunk, shift, width) are its digits, least
    significant first, chunk 0 the key's low bits."""
    masks: Tuple[int, ...]
    flips: Tuple[int, ...]
    bits: int
    key_bits: int
    passes: Tuple[Tuple[int, int, int], ...]

    @property
    def offsets(self) -> Tuple[int, ...]:
        """The bit of the packed key where each word's lowest varying bit
        lands: the words after it hold the bits below."""
        out, at = [0] * len(self.masks), 0
        for w in reversed(range(len(self.masks))):
            out[w] = at
            at += bin(self.masks[w]).count("1")
        return tuple(out)

    @property
    def chunks(self) -> int:
        return -(-self.bits // self.key_bits) if self.key_bits else 0


def sort_plan(span_and: Sequence[int], span_or: Sequence[int],
              signed: Sequence[bool]) -> SortPlan:
    """The plan of the sort from each word's AND and OR over the rows: a
    bit varies only where they differ (XOR with the sign flip keeps that
    set), and a bit every row shares cannot change the order. Past 64 bits
    the chunks are 32 bits wide: a pass over 32-bit keys moves 16 bytes a
    row against 24, more than the extra chunks' gathers cost."""
    masks = tuple((a ^ o) & 0xFFFFFFFF for a, o in zip(span_and, span_or))
    flips = tuple(_SIGN if s else 0 for s in signed)
    bits = sum(bin(m).count("1") for m in masks)
    key_bits = 0 if bits == 0 else 64 if 32 < bits <= 64 else 32
    passes = []
    for c in range(-(-bits // key_bits) if bits else 0):
        width = min(key_bits, bits - key_bits * c)
        passes += [(c, shift, min(DIGIT_BITS, width - shift))
                   for shift in range(0, width, DIGIT_BITS)]
    return SortPlan(masks, flips, bits, key_bits, tuple(passes))


def _runs(mask: int):
    """The contiguous runs of set bits of `mask`: (shift, length), low first."""
    shift = 0
    while mask >> shift:
        if (mask >> shift) & 1:
            length = 0
            while (mask >> (shift + length)) & 1:
                length += 1
            yield shift, length
            shift += length
        else:
            shift += 1


def pack_key_plain(words: torch.Tensor, plan: SortPlan) -> torch.Tensor:
    """int64 [plan.chunks, n]: the packed key of every row, chunk by chunk
    (the unsigned bits of each `plan.key_bits`-bit chunk, a 64-bit one as
    int64), chunk 0 the least significant; the pack kernel's work in torch
    ops."""
    n = words.shape[1]
    out = torch.zeros((plan.chunks, n), dtype=torch.int64, device=words.device)
    for w, (mask, flip, at) in enumerate(zip(plan.masks, plan.flips, plan.offsets)):
        if mask == 0:
            continue
        x = (words[w].long() & 0xFFFFFFFF) ^ flip
        e = torch.zeros_like(x)
        got = 0
        for shift, length in _runs(mask):
            e |= ((x >> shift) & ((1 << length) - 1)) << got
            got += length
        cw = plan.key_bits
        for c in range(plan.chunks):
            lo = at - cw * c
            if lo >= cw or lo + got <= 0:
                continue
            part = e << lo if lo >= 0 else e >> -lo
            # bits past the chunk's top belong to chunk c + 1
            out[c] |= part if cw == 64 else part & 0xFFFFFFFF
    return out


def radix_sort(words: torch.Tensor, signed: Sequence[bool]) -> torch.Tensor:
    """radix_sort_plain's contract; launches K6 for CUDA tensors. Reads the
    bit span of every key word on the host first (one synchronisation) to
    plan the packed key and its digit passes."""
    if not words.is_cuda:
        return radix_sort_plain(words, signed)
    if words.dim() != 2 or len(signed) != words.shape[0]:
        raise ValueError(f"words [k, n] with k signed flags expected, got "
                         f"{tuple(words.shape)} and {len(signed)}")
    _build.require(words, "words", torch.int32)
    k, n = words.shape
    if not 1 <= k <= 64 or n >= 2**31:
        raise ValueError(f"{k} key words of {n} rows: out of range")
    plan = planned(words, signed)
    uints = ctypes.c_uint * k
    ints = ctypes.c_int * max(len(plan.passes), 1)
    chunk, shift, width = (ints(*col) for col in zip(*plan.passes)) if plan.passes else (
        ints(), ints(), ints())
    scratch_bytes = _build.function("dfp_radix_sort_scratch_bytes",
                                    (_build.I64, _build.I32, _build.I32), _build.I64)
    fn = _build.function("dfp_radix_sort", (
        _build.P, _build.I32, _build.I64, ctypes.POINTER(ctypes.c_uint),
        ctypes.POINTER(ctypes.c_uint), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), _build.I32, _build.P,
        _build.P, _build.I64, _build.P))
    perm = torch.empty(n, dtype=torch.int32, device=words.device)
    nbytes = scratch_bytes(n, plan.bits, len(plan.passes)) if plan.passes else 0
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=words.device)
    err = fn(words.data_ptr(), k, n, uints(*plan.masks), uints(*plan.flips), chunk, shift,
             width, len(plan.passes), perm.data_ptr(), scratch.data_ptr(), nbytes,
             _build.stream(words.device))
    radix_sort.launches += 1
    _build.check(err, "radix_sort")
    return perm


def planned(words: torch.Tensor, signed: Sequence[bool]) -> SortPlan:
    """The plan for these words [k, n], from their bit span: read by a
    kernel for CUDA tensors (one synchronisation), by numpy on the CPU."""
    k, n = words.shape
    if not words.is_cuda:
        v = np.ascontiguousarray(words.numpy()).view(np.uint32)
        return sort_plan([int(x) for x in np.bitwise_and.reduce(v, axis=1)],
                         [int(x) for x in np.bitwise_or.reduce(v, axis=1)], signed)
    span = torch.empty(2 * k, dtype=torch.int32, device=words.device)
    err = _build.function("dfp_key_span", (_build.P, _build.I32, _build.I64, _build.P,
                                           _build.P))(
        words.data_ptr(), k, n, span.data_ptr(), _build.stream(words.device))
    _build.check(err, "radix_sort (key span)")
    host = [int(x) & 0xFFFFFFFF for x in span.tolist()]
    return sort_plan(host[:k], host[k:], signed)


radix_sort.launches = 0
