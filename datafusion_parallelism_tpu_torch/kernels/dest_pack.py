"""K18 dest_pack: each row's destination partition, and per destination
the row ids a shuffle sends there, in row order.

Replaces the JAX package's `route_of` (parallel/shuffle.py:62), the index
grid, `send_valid` and dropped count of `_pack_by_dest` (:69-94) and of
`replicating_shuffle`'s membership pick (:150-188), and `salted_route`
(parallel/skew.py:68-78). The CUDA kernel is `csrc/dest_pack.cu`, whose
header says what bounds it on the H100 (the grid's bytes) and how it keeps
row order within a destination while routing each row once and writing
each grid entry once: one pass by decoupled look-back over a vector of P
counts, then the zeros past each destination's members. The plain version
below is the same function in torch ops. On CPU tensors the wrapper runs
the plain version; on CUDA tensors it launches the kernel or raises.

A row's destination: P (never sent) outside `mask`; else `rank` where the
optional `heavy` table (bool [256], by the hash's top 8 bits) marks its
bucket (the salted probe side); else route_of(hash, P). A row in the mask
is a member of every destination where its optional `replicate` flag
(bool [cap]) is set, or, with `heavy_to_all`, where `heavy` marks its
bucket (the skewed build side; such a row does not stay on `rank`).
Outputs: the index grid int32
[P, send_cap] (grid[d, j] the j-th member of d for j < min(counts[d],
send_cap), 0 past it), counts int32 [P] (members, past send_cap too; a
shuffle sends grid[d, j] where j < counts[d]) and dropped, int32 0-dim:
the sum of max(counts[d] - send_cap, 0).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

_M32 = 0xFFFFFFFF
# csrc/dest_pack.cu's launch plan, in the order of its dfp_dest_pack_plan
# (`compiled_plan`)
ROUNDS = 8                   # 32-row rounds a warp takes
TILE = 256 * ROUNDS          # rows a block of the pass takes
MAX_P = 1024                 # destinations a launch takes
PLAN = ("ROUNDS", "TILE", "MAX_P")


def compiled_plan() -> dict:
    """PLAN's constants as csrc/dest_pack.cu was built with them (builds
    the kernel), to hold against this module's copies."""
    fn = _build.function("dfp_dest_pack_plan", (_build.I32,), _build.I64)
    return {name: fn(i) for i, name in enumerate(PLAN)}


def compiled_scratch_bytes(cap: int, P: int) -> int:
    """The kernel's own scratch bytes of a launch (builds the kernel), to
    hold against `scratch_bytes`; -1 for a P it does not take."""
    return _build.function("dfp_dest_pack_scratch_bytes", (_build.I64, _build.I32),
                           _build.I64)(cap, P)


def pack_tiles(cap: int) -> int:
    """Blocks of the pass: tiles of TILE rows."""
    return -(-cap // TILE)


def scratch_bytes(cap: int, P: int) -> int:
    """The launch's scratch, zeroed by the launcher: a look-back status
    word a tile and destination, then the tile counter (8 bytes each)."""
    return 8 * (pack_tiles(cap) * P + 1)


def route_of(hashes: torch.Tensor, P: int) -> torch.Tensor:
    """Destination of each row, int32: the top 16 bits of the uint32 hash
    (held in int32) mapped onto [0, P) by a multiply-shift. In int64, as
    CPU torch has no >> on uint32."""
    return (((hashes.long() & _M32) >> 16) * P >> 16).to(torch.int32)


def bucket_of(hashes: torch.Tensor) -> torch.Tensor:
    """The histogram bucket of each row, int32: the top 8 hash bits."""
    return ((hashes.long() & _M32) >> 24).to(torch.int32)


def dest_pack_plain(hashes: torch.Tensor, mask: torch.Tensor, P: int, send_cap: int,
                    heavy: Optional[torch.Tensor] = None, rank: int = 0,
                    replicate: Optional[torch.Tensor] = None, heavy_to_all: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(grid int32 [P, send_cap], counts int32 [P], dropped int32 0-dim):
    the module's contract, through the [P, cap] membership matrix and its
    row-wise cumsum (JAX's replicating_shuffle pick)."""
    cap, dev = hashes.shape[0], hashes.device
    dest = route_of(hashes, P).long()
    if heavy is not None:
        is_heavy = heavy[bucket_of(hashes).long()]
        if heavy_to_all:
            replicate = is_heavy if replicate is None else replicate | is_heavy
        else:
            dest = torch.where(is_heavy, rank, dest)
    dest = torch.where(mask, dest, P)
    member = dest[None, :] == torch.arange(P, device=dev)[:, None]
    if replicate is not None:
        member |= (replicate & mask)[None, :]
    csum = torch.cumsum(member, 1, dtype=torch.int64)
    counts = csum[:, -1] if cap else torch.zeros(P, dtype=torch.int64, device=dev)
    j = torch.arange(send_cap, dtype=torch.int64, device=dev)
    pick = torch.searchsorted(csum, (j + 1).expand(P, send_cap).contiguous()) if cap else \
        torch.zeros((P, send_cap), dtype=torch.int64, device=dev)
    grid = torch.where(j[None, :] < counts[:, None], pick, 0).to(torch.int32)
    dropped = torch.clamp(counts - send_cap, min=0).sum().to(torch.int32)
    return grid, counts.to(torch.int32), dropped


def check_args(hashes, mask, P: int, send_cap: int, heavy=None, rank: int = 0,
               replicate=None, heavy_to_all: bool = False) -> int:
    """The wrapper's checks before a launch; returns cap. Raises on what
    the kernel does not take."""
    dev = hashes.device
    cap = hashes.shape[0] if hashes.dim() == 1 else -1
    _build.require(hashes, "hashes", torch.int32, (cap,))
    _build.require(mask, "mask", torch.bool, (cap,), dev)
    if not 1 <= P <= MAX_P:
        raise ValueError(f"dest_pack takes 1-{MAX_P} destinations, got {P}")
    if send_cap < 0 or P * max(cap, send_cap) >= 2**31:
        raise ValueError(f"dest_pack: {P} destinations x {cap} rows / send_cap {send_cap} "
                         "out of range")
    if heavy_to_all and heavy is None:
        raise ValueError("dest_pack: heavy_to_all without a heavy table")
    if heavy is not None:
        _build.require(heavy, "heavy", torch.bool, (256,), dev)
        if not 0 <= rank < P:
            raise ValueError(f"rank {rank} outside the {P} destinations")
    if replicate is not None:
        _build.require(replicate, "replicate", torch.bool, (cap,), dev)
    return cap


def dest_pack(hashes: torch.Tensor, mask: torch.Tensor, P: int, send_cap: int,
              heavy: Optional[torch.Tensor] = None, rank: int = 0,
              replicate: Optional[torch.Tensor] = None, heavy_to_all: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dest_pack_plain's contract; launches K18 for CUDA tensors."""
    if not hashes.is_cuda:
        return dest_pack_plain(hashes, mask, P, send_cap, heavy, rank, replicate, heavy_to_all)
    return _launch(hashes, mask, P, send_cap, heavy, rank, replicate, heavy_to_all)


def _launch(hashes, mask, P, send_cap, heavy, rank, replicate, heavy_to_all):
    cap = check_args(hashes, mask, P, send_cap, heavy, rank, replicate, heavy_to_all)
    dev = hashes.device
    fn = _build.function("dfp_dest_pack", (
        _build.P, _build.P, _build.I64, _build.I32, _build.P, _build.I32, _build.I32, _build.P,
        _build.I64, _build.P, _build.P, _build.P, _build.P, _build.I64, _build.I32, _build.P))
    grid = torch.empty((P, send_cap), dtype=torch.int32, device=dev)
    counts = torch.empty(P, dtype=torch.int32, device=dev)
    dropped = torch.empty((), dtype=torch.int32, device=dev)
    nbytes = scratch_bytes(cap, P)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    err = fn(hashes.data_ptr(), mask.data_ptr(), cap, P,
             heavy.data_ptr() if heavy is not None else None, rank, int(heavy_to_all),
             replicate.data_ptr() if replicate is not None else None, send_cap,
             grid.data_ptr(), counts.data_ptr(), dropped.data_ptr(), scratch.data_ptr(), nbytes,
             _build.device_limits(dev).sms, _build.stream(dev))
    dest_pack.launches += 1
    _build.check(err, "dest_pack")
    return grid, counts, dropped


dest_pack.launches = 0
