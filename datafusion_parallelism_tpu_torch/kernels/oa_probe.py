"""K16 oa_probe: candidate ranges of the probe rows against the OA
strategy's open-addressing table.

Replaces the JAX package's `hash_table._probe_oa` (ops/hash_table.py:180,
a lockstep `while_loop` over all probe rows) and the cumsum of
`probe_candidates` (:283), with JAX's contract: the table's slots give T =
4S/5 and each probe row's home is slot_of(hash, T). The CUDA kernel is
`csrc/oa_probe.cu`, whose header says what bounds it on the H100 (random
reads of short walks) and how it runs: one launch in which each probe row
walks from its home, computed from its hash, on its own thread for its
first THREAD_SLOTS slots and with its warp past them, and each tile's
base is taken by decoupled look-back. The plain version below is the JAX
loop in torch ops. On CPU tensors the wrapper runs the plain
version; on CUDA tensors it launches the kernel or raises.

The output is K3's `Ranges` contract (start, count, base, total), with the
same OverflowError when the candidate total reaches 2^31.
"""

from __future__ import annotations

import torch

from . import _build
from .probe_expand import Ranges, check_total

_M32 = 0xFFFFFFFF
# csrc/oa_probe.cu's launch plan, in the order of its dfp_oa_probe_plan
# (`compiled_plan`)
PROBE_ITEMS = 4                  # probe rows a thread walks at once, PROBE_BLOCK apart
PROBE_ROUNDS = 8                 # rounds of PROBE_ITEMS rows a thread a tile
PROBE_TILE = 256 * PROBE_ITEMS * PROBE_ROUNDS   # probe rows a block takes
THREAD_SLOTS = 6                 # slots a row walks on its own thread; its warp walks on
PLAN = ("PROBE_ITEMS", "PROBE_ROUNDS", "PROBE_TILE", "THREAD_SLOTS")


def compiled_plan() -> dict:
    """PLAN's constants as csrc/oa_probe.cu was built with them (builds the
    kernel), to hold against this module's copies."""
    fn = _build.function("dfp_oa_probe_plan", (_build.I32,), _build.I64)
    return {name: fn(i) for i, name in enumerate(PLAN)}


def compiled_scratch_bytes(m: int) -> int:
    """The kernel's own scratch bytes of a launch (builds the kernel), to
    hold against `scratch_bytes`."""
    return _build.function("dfp_oa_probe_scratch_bytes", (_build.I64,), _build.I64)(m)


def probe_tiles(m: int) -> int:
    """Blocks of the launch: tiles of PROBE_TILE probe rows."""
    return -(-m // PROBE_TILE)


def scratch_bytes(m: int) -> int:
    """The launch's scratch, zeroed by the launcher: a look-back status
    word a tile and the tile counter (8 bytes each)."""
    return 8 * (probe_tiles(m) + 1)


def home_slots(S: int) -> int:
    """T of a table of S slots, as JAX's walk takes it: 4S/5 (S = T + T/4
    for every T the builds use, a multiple of 4)."""
    return 4 * S // 5


def oa_probe_plain(hashes: torch.Tensor, ok: torch.Tensor, slots: torch.Tensor) -> Ranges:
    """(start, count, base, total) per probe row: every row with `ok` walks
    the int64 `slots` [S] from its home slot_of(hash, T), T = 4S/5, one
    slot a step and all rows in lockstep (at most S steps, the position
    clamped at S - 1): seeking, an empty slot (0) ends it with count 0;
    the first slot whose high word is the row's hash (uint32 bits in
    int32) sets start and count 1; counting, each further equal hash adds
    one, anything else ends it. Rows without `ok`: start 0, count 0.

    The steps are taken a window at a time over the rows still walking
    (`_walk_window`), which gives the lockstep's result in as many
    rounds as the longest walk has windows."""
    from ..ops.hash_table import slot_of
    S, m, dev = slots.shape[0], hashes.shape[0], hashes.device
    h = hashes.long() & _M32
    cur = slot_of(hashes, home_slots(S)).long()
    start = torch.zeros(m, dtype=torch.int64, device=dev)
    count = torch.zeros(m, dtype=torch.int64, device=dev)
    phase = torch.where(ok, 0, 2)          # 0 seeking, 1 counting, 2 done
    k = 0
    while k < S:
        act = torch.nonzero(phase < 2).flatten()
        if act.numel() == 0:
            break
        W = min(S - k, max(16, min(1024, (1 << 22) // act.numel())))
        phase[act], start[act], count[act], cur[act] = _walk_window(
            slots, h[act], cur[act], phase[act], start[act], count[act], W)
        k += W
    count = count.to(torch.int32)
    cum = torch.cumsum(count, 0, dtype=torch.int64)
    total = check_total(cum[-1])
    return start.to(torch.int32), count, (cum - count).to(torch.int32), total


def _walk_window(slots, h, cur, phase, start, count, W: int):
    """W lockstep steps of oa_probe_plain's walk for the rows given (none
    done): each reads the slots min(cur + i, S - 1), i < W; a seeking row
    ends at its first empty slot or turns to counting at its first equal
    hash; a counting row adds the equal hashes up to its first other
    slot. Returns (phase, start, count, cur) after the W steps."""
    S = slots.shape[0]
    i = torch.arange(W, device=h.device)
    pos = torch.clamp(cur[:, None] + i, max=S - 1)
    v = slots[pos]
    empty = v == 0
    hit = ~empty & (((v >> 32) & _M32) == h[:, None])

    def first(mask):   # the first index where mask is set, W where none
        return torch.where(mask.any(1), torch.argmax(mask.to(torch.uint8), 1), W)

    j0 = first(empty | hit)
    at = j0.clamp(max=W - 1)[:, None]
    seeking = phase == 0
    found = seeking & (j0 < W) & hit.gather(1, at).squeeze(1)
    ended = seeking & (j0 < W) & ~found
    counting = found | (phase == 1)
    jc = torch.where(found, j0 + 1, torch.where(phase == 1, 0, W))
    je = first(~hit & (i[None, :] >= jc[:, None]))
    add = je - jc.clamp(max=W)
    count = torch.where(found, 1 + add, torch.where(phase == 1, count + add, count))
    start = torch.where(found, pos.gather(1, at).squeeze(1), start)
    done = ended | (counting & (je < W))
    phase = torch.where(done, 2, torch.where(counting, 1, phase))
    return phase, start, count, torch.clamp(cur + W, max=S - 1)


def check_args(hashes, ok, slots) -> int:
    """The wrapper's checks before a launch; returns m. Raises on what the
    kernel does not take."""
    dev = hashes.device
    m = hashes.shape[0] if hashes.dim() == 1 else -1
    _build.require(hashes, "hashes", torch.int32, (m,))
    _build.require(ok, "ok", torch.bool, (m,), dev)
    if slots.dim() != 1 or not 2 <= slots.shape[0] < 2**31:
        raise ValueError(f"slots: expected [S], 2 <= S < 2^31, got {tuple(slots.shape)}")
    _build.require(slots, "slots", torch.int64, None, dev)
    if m < 1:
        raise ValueError("probe side has no rows")
    return m


def oa_probe(hashes: torch.Tensor, ok: torch.Tensor, slots: torch.Tensor) -> Ranges:
    """oa_probe_plain's contract; launches K16 for CUDA tensors."""
    if not hashes.is_cuda:
        return oa_probe_plain(hashes, ok, slots)
    return _launch(hashes, ok, slots)


def _launch(hashes: torch.Tensor, ok: torch.Tensor, slots: torch.Tensor) -> Ranges:
    m = check_args(hashes, ok, slots)
    dev = hashes.device
    S = slots.shape[0]
    fn = _build.function("dfp_oa_probe", (
        _build.P, _build.P, _build.I64, _build.P, _build.I64, _build.I64, _build.P, _build.P,
        _build.P, _build.P, _build.P, _build.I64, _build.P))
    start = torch.empty(m, dtype=torch.int32, device=dev)
    count = torch.empty(m, dtype=torch.int32, device=dev)
    base = torch.empty(m, dtype=torch.int32, device=dev)
    total64 = torch.empty((), dtype=torch.int64, device=dev)
    nbytes = scratch_bytes(m)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    err = fn(hashes.data_ptr(), ok.data_ptr(), m, slots.data_ptr(), S, home_slots(S),
             start.data_ptr(), count.data_ptr(), base.data_ptr(), total64.data_ptr(),
             scratch.data_ptr(), nbytes, _build.stream(dev))
    oa_probe.launches += 1
    _build.check(err, "oa_probe")
    return start, count, base, check_total(total64)


oa_probe.launches = 0
