"""K6 radix_sort: stable lexicographic argsort over 32-bit key words.

Replaces the JAX package's multi-operand `jax.lax.sort(..., num_keys=k,
is_stable=True)` in `ops/sort.py:31` (`sort_table`) and in the grouping
sorts of `ops/aggregate.py:288-317`. The CUDA kernel is
`csrc/radix_sort.cu`, whose header says what bounds it on the H100; the
plain version below is the same function in torch ops. On CPU tensors the
wrapper runs the plain version; on CUDA tensors it launches the kernel or
raises.

Keys are given as int32 words [k, n], most significant first, each word
compared as signed or unsigned. An int64 key is its signed high word then
its unsigned low word; a float64 key is first mapped to an order-preserving
int64 (`ops/sort.py::float_sort_bits`).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build

_SIGN = 0x80000000


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


def passes(span_and: Sequence[int], span_or: Sequence[int], signed: Sequence[bool]):
    """The digit passes of the LSD sort, in order: (word, shift, flip) for
    every 8-bit digit that differs between rows (AND != OR over the word's
    values there); a digit every row shares leaves the order as it is."""
    out = []
    for w in reversed(range(len(signed))):
        varying = (span_and[w] ^ span_or[w]) & 0xFFFFFFFF
        for shift in (0, 8, 16, 24):
            if (varying >> shift) & 0xFF:
                out.append((w, shift, _SIGN if signed[w] else 0))
    return out


def radix_sort(words: torch.Tensor, signed: Sequence[bool]) -> torch.Tensor:
    """radix_sort_plain's contract; launches K6 for CUDA tensors. Reads the
    bit span of every key word on the host first (one synchronisation) to
    skip the digit passes that cannot reorder anything."""
    if not words.is_cuda:
        return radix_sort_plain(words, signed)
    if words.dim() != 2 or len(signed) != words.shape[0]:
        raise ValueError(f"words [k, n] with k signed flags expected, got "
                         f"{tuple(words.shape)} and {len(signed)}")
    _build.require(words, "words", torch.int32)
    k, n = words.shape
    if not 1 <= k <= 64 or n >= 2**31:
        raise ValueError(f"{k} key words of {n} rows: out of range")
    dev = words.device
    span = torch.empty(2 * k, dtype=torch.int32, device=dev)
    err = _build.function("dfp_key_span", (_build.P, _build.I32, _build.I64, _build.P,
                                           _build.P))(
        words.data_ptr(), k, n, span.data_ptr(), _build.stream(dev))
    _build.check(err, "radix_sort (key span)")
    host = [int(x) & 0xFFFFFFFF for x in span.tolist()]
    plan = passes(host[:k], host[k:], signed)
    ints = ctypes.c_int * max(len(plan), 1)
    pw = ints(*[p[0] for p in plan])
    ps = ints(*[p[1] for p in plan])
    pf = (ctypes.c_uint * max(len(plan), 1))(*[p[2] for p in plan])
    scratch_bytes = _build.function("dfp_radix_sort_scratch_bytes", (_build.I64,), _build.I64)
    fn = _build.function("dfp_radix_sort", (
        _build.P, _build.I64, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_uint), _build.I32, _build.P, _build.P, _build.I64, _build.P))
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    nbytes = scratch_bytes(n)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    err = fn(words.data_ptr(), n, pw, ps, pf, len(plan), perm.data_ptr(), scratch.data_ptr(),
             nbytes, _build.stream(dev))
    radix_sort.launches += 1
    _build.check(err, "radix_sort")
    return perm


radix_sort.launches = 0
