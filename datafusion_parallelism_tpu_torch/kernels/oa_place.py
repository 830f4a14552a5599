"""K15 oa_place: the open-addressing table's slots from the build rows in
(invalid, home, hash) order.

Replaces the placement of the JAX package's `hash_table.build_oa`
(ops/hash_table.py:160-175): the parking-function displacement
`cummax(where(ok, home - i, -cap))`, `pos = i + disp`, and the scatters of
the packed (hash << 32 | row + 1) slots and the row ids into zeroed arrays
of S = T + T/4 entries. The CUDA kernel is `csrc/oa_place.cu`, whose header
says what bounds it on the H100 (bytes, most of them the S-slot outputs)
and how it writes every slot once: a count of the valid rows, one
look-back pass in which a tile of PLACE_TILE sorted rows carries the
displacement as a max and writes the slots from the row before it to its
last row, zeros included, then the zeros past the last row. The kernel
takes each row's home as slot_of(hash, T), T = 4S/5, and does not read
`home`: its one caller, `ops/hash_table.py` `oa_table_rows` (under
`build_oa` and the join's `_build_table`), makes `home` from the hashes
so, and the plain version places by the `home` it is given. The plain
version below is the JAX code in torch ops. On CPU tensors the wrapper
runs the plain version; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

_M32 = 0xFFFFFFFF
# csrc/oa_place.cu's launch plan, in the order of its dfp_oa_place_plan
# (`compiled_plan`)
PLACE_ITEMS = 8            # consecutive sorted rows a thread takes
PLACE_TILE = 256 * PLACE_ITEMS  # sorted rows a block of the look-back pass takes
SPAN_CHUNK = 2048          # slots a block stages in shared memory at a time
PLAN = ("PLACE_ITEMS", "PLACE_TILE", "SPAN_CHUNK")


def compiled_plan() -> dict:
    """PLAN's constants as csrc/oa_place.cu was built with them (builds the
    kernel), to hold against this module's copies."""
    fn = _build.function("dfp_oa_place_plan", (_build.I32,), _build.I64)
    return {name: fn(i) for i, name in enumerate(PLAN)}


def compiled_scratch_bytes(cap: int) -> int:
    """The kernel's own scratch bytes of a launch (builds the kernel), to
    hold against `scratch_bytes`."""
    return _build.function("dfp_oa_place_scratch_bytes", (_build.I64,), _build.I64)(cap)


def place_tiles(cap: int) -> int:
    """Blocks of the look-back pass: tiles of PLACE_TILE sorted rows."""
    return -(-cap // PLACE_TILE)


def home_slots(S: int) -> int:
    """T of a table of S = T + T/4 slots (ops/hash_table.py
    `oa_slots_for`); raises for any other S."""
    q, r = divmod(S, 5)          # T = 4q + r gives S = 5q + r for r < 4
    if r == 4:
        raise ValueError(f"slot count {S} is no T + T/4")
    return 4 * q + r


def scratch_bytes(cap: int) -> int:
    """The launch's scratch, zeroed by one memset: look-back status words
    and the tile counter, the valid rows' count, the tail's first slot (8
    bytes each)."""
    return 8 * (place_tiles(cap) + 1) + 16


def oa_place_plain(order: torch.Tensor, home: torch.Tensor, hashes: torch.Tensor,
                   ok: torch.Tensor, S: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slots int64[S], perm int32[S]): `order` int32[cap] is the stable
    sort of the rows by (invalid, home, hash), so its first n_valid = the
    count of `ok` rows are the valid ones (the kernel relies on it: it
    reads `ok` only to count it); `home`, `hashes` (uint32 bits)
    int32[cap] and `ok` bool[cap] are in row order; S = T + T/4 and a
    valid row's home is slot_of(its hash, T) (the kernel computes it so).
    The i-th sorted valid row o lands at pos = i + max_{j<=i}(home_j - j)
    and sets slots[pos] = (hash_o << 32) | (o + 1), perm[pos] = o; every
    other entry is 0 and invalid rows drop."""
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
    """oa_place_plain's contract (the valid rows first in `order`, S =
    T + T/4, home = slot_of(hash, T) on the valid rows); launches K15 for
    CUDA tensors, which computes the homes from the hashes and leaves
    `home` unread."""
    if not order.is_cuda:
        return oa_place_plain(order, home, hashes, ok, S)
    return _launch(order, home, hashes, ok, S)


def _launch(order: torch.Tensor, home: torch.Tensor, hashes: torch.Tensor, ok: torch.Tensor,
            S: int) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = order.device
    cap = order.shape[0] if order.dim() == 1 else -1
    _build.require(order, "order", torch.int32, (cap,))
    _build.require(hashes, "hashes", torch.int32, (cap,), dev)
    _build.require(ok, "ok", torch.bool, (cap,), dev)
    if not cap < S < 2**31:
        raise ValueError(f"slot count {S} must exceed the {cap} rows and stay below 2^31")
    T = home_slots(S)
    fn = _build.function("dfp_oa_place", (
        _build.P, _build.P, _build.P, _build.I64, _build.I64, _build.I64, _build.P, _build.P,
        _build.P, _build.I64, _build.I32, _build.P))
    slots = torch.empty(S, dtype=torch.int64, device=dev)
    perm = torch.empty(S, dtype=torch.int32, device=dev)
    nbytes = scratch_bytes(cap)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    err = fn(order.data_ptr(), hashes.data_ptr(), ok.data_ptr(), cap, S, T,
             slots.data_ptr(), perm.data_ptr(), scratch.data_ptr(), nbytes,
             _build.device_limits(dev).sms, _build.stream(dev))
    oa_place.launches += 1
    _build.check(err, "oa_place")
    return slots, perm


oa_place.launches = 0
