"""K15 oa_place: the open-addressing table's slots from the build rows in
(home, hash) order.

Replaces the placement of the JAX package's `hash_table.build_oa`
(ops/hash_table.py:160-175): the parking-function displacement
`cummax(where(ok, home - i, -cap))`, `pos = i + disp`, and the scatters of
the packed (hash << 32 | row + 1) slots and the row ids into zeroed arrays
of S = T + T/4 entries. The CUDA kernel is `csrc/oa_place.cu`, whose header
says what bounds it on the H100 (bytes) and how a device-wide max-scan
replaces sequential insertion; the plain version below is the JAX code in
torch ops. On CPU tensors the wrapper runs the plain version; on CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

_M32 = 0xFFFFFFFF


def oa_place_plain(order: torch.Tensor, home: torch.Tensor, hashes: torch.Tensor,
                   ok: torch.Tensor, S: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slots int64[S], perm int32[S]): `order` int32[cap] is the stable
    sort of the rows by (invalid, home, hash); `home`, `hashes` (uint32
    bits) int32[cap] and `ok` bool[cap] are in row order. The i-th sorted
    valid row o lands at pos = i + max_{j<=i}(home_j - j) and sets
    slots[pos] = (hash_o << 32) | (o + 1), perm[pos] = o; every other entry
    is 0 and invalid rows drop."""
    cap, dev = order.shape[0], order.device
    o = order.long()
    sok = ok.index_select(0, o)
    i = torch.arange(cap, dtype=torch.int64, device=dev)
    d = torch.where(sok, home.long().index_select(0, o) - i, -cap)
    disp = torch.cummax(d, 0).values if cap else d
    pos = torch.where(sok, i + disp, S)
    sval = ((hashes.long().index_select(0, o) & _M32) << 32) | (o + 1)
    slots = torch.zeros(S + 1, dtype=torch.int64, device=dev).scatter_(0, pos, sval)[:S]
    perm = torch.zeros(S + 1, dtype=torch.int32, device=dev).scatter_(0, pos, order)[:S]
    return slots, perm


def oa_place(order: torch.Tensor, home: torch.Tensor, hashes: torch.Tensor,
             ok: torch.Tensor, S: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """oa_place_plain's contract; launches K15 for CUDA tensors."""
    if not order.is_cuda:
        return oa_place_plain(order, home, hashes, ok, S)
    dev = order.device
    cap = order.shape[0] if order.dim() == 1 else -1
    _build.require(order, "order", torch.int32, (cap,))
    _build.require(home, "home", torch.int32, (cap,), dev)
    _build.require(hashes, "hashes", torch.int32, (cap,), dev)
    _build.require(ok, "ok", torch.bool, (cap,), dev)
    if not cap < S < 2**31:
        raise ValueError(f"slot count {S} must exceed the {cap} rows and stay below 2^31")
    scratch_bytes = _build.function("dfp_oa_place_scratch_bytes", (_build.I64,), _build.I64)
    fn = _build.function("dfp_oa_place", (
        _build.P, _build.P, _build.P, _build.P, _build.I64, _build.I64, _build.P, _build.P,
        _build.P, _build.I64, _build.P))
    slots = torch.empty(S, dtype=torch.int64, device=dev)
    perm = torch.empty(S, dtype=torch.int32, device=dev)
    nbytes = scratch_bytes(cap)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    err = fn(order.data_ptr(), home.data_ptr(), hashes.data_ptr(), ok.data_ptr(), cap, S,
             slots.data_ptr(), perm.data_ptr(), scratch.data_ptr(), nbytes, _build.stream(dev))
    oa_place.launches += 1
    _build.check(err, "oa_place")
    return slots, perm


oa_place.launches = 0
