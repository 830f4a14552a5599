"""K14 sorted_probe: candidate ranges of the probe rows against the SORT
strategy's table.

Replaces the JAX package's SORT branch of `hash_table.probe_ranges`
(ops/hash_table.py:257-263, two `jnp.searchsorted`) and the cumsum of
`probe_candidates` (:283). The CUDA kernel is `csrc/sorted_probe.cu`, whose
header says what bounds it on the H100 (random reads) and how a bucket
directory over the sorted keys, built inside each launch, puts every probe
row within one bucket of its place: `directory_bits` buckets of about
KEYS_A_BUCKET capacity keys, then one look-back pass that searches each
row's bucket and takes its base; the plain version below is the same
function in torch ops. On CPU tensors the wrapper runs the plain version;
on CUDA tensors it launches the kernel or raises.

The output is K3's `Ranges` contract (start, count, base, total), with the
same OverflowError when the candidate total reaches 2^31.
"""

from __future__ import annotations

import torch

from . import _build
from .probe_expand import Ranges, check_total

_M32 = 0xFFFFFFFF
KEYS_A_BUCKET = 8          # capacity keys a directory bucket, at most
# csrc/sorted_probe.cu's launch plan, in the order of its
# dfp_sorted_probe_plan (`compiled_plan`)
MAX_DIRECTORY_BITS = 28    # MAX_BITS
DIR_TILE = 256 * 16        # directory entries a fill block writes
DIR_SCAN_KEYS = 16 * DIR_TILE   # past this many keys a fill tile searches
PROBE_TILE = 256 * 8       # probe rows a block of the look-back pass takes
BUCKET_SCAN = 8            # a bucket of at most this many keys is read whole
RUN_SCAN = 8               # keys read on from the lower bound before a search
PLAN = ("MAX_DIRECTORY_BITS", "DIR_TILE", "DIR_SCAN_KEYS", "PROBE_TILE", "BUCKET_SCAN",
        "RUN_SCAN")


def compiled_plan() -> dict:
    """PLAN's constants as csrc/sorted_probe.cu was built with them (builds
    the kernel), to hold against this module's copies."""
    fn = _build.function("dfp_sorted_probe_plan", (_build.I32,), _build.I64)
    return {name: fn(i) for i, name in enumerate(PLAN)}


def compiled_scratch_bytes(m: int, bits: int) -> int:
    """The kernel's own scratch bytes of a launch (builds the kernel), to
    hold against `scratch_bytes`."""
    return _build.function("dfp_sorted_probe_scratch_bytes", (_build.I64, _build.I32),
                           _build.I64)(m, bits)


def directory_bits(cap: int) -> int:
    """The directory's bits b for a table of `cap` sorted keys: the least
    b with cap / 2^b <= KEYS_A_BUCKET (2^22 buckets, 16 MB, at 2^25)."""
    return min(MAX_DIRECTORY_BITS, (-(-max(cap, 1) // KEYS_A_BUCKET) - 1).bit_length())


def directory_tiles(bits: int) -> int:
    """Blocks of the directory's fill: its 2^bits + 1 entries in tiles of
    DIR_TILE."""
    return -(-((1 << bits) + 1) // DIR_TILE)


def probe_tiles(m: int) -> int:
    """Blocks of the look-back pass: tiles of PROBE_TILE probe rows."""
    return -(-m // PROBE_TILE)


def scratch_bytes(m: int, bits: int) -> int:
    """The launch's scratch: look-back status words and the tile counter
    (8 bytes each), the directory (int32, to 8 bytes), each fill tile's
    first position and the one past the last (int32)."""
    return (8 * (probe_tiles(m) + 1) + -(-4 * ((1 << bits) + 1) // 8) * 8
            + 4 * (directory_tiles(bits) + 1))


def sorted_probe_plain(hashes: torch.Tensor, ok: torch.Tensor,
                       sorted_hash: torch.Tensor) -> Ranges:
    """(start, count, base, total) per probe row: the hash int32[m] (uint32
    bits) widened as unsigned, start/end its left/right insertion points in
    the sorted int64 keys `sorted_hash`, count = end - start (0 where `ok`
    is False; start is kept), base the exclusive cumsum of count."""
    key = hashes.long() & _M32
    start = torch.searchsorted(sorted_hash, key, side="left")
    end = torch.searchsorted(sorted_hash, key, side="right")
    count = torch.where(ok, end - start, 0).to(torch.int32)
    cum = torch.cumsum(count, 0, dtype=torch.int64)
    total = check_total(cum[-1])
    return start.to(torch.int32), count, (cum - count).to(torch.int32), total


def sorted_probe(hashes: torch.Tensor, ok: torch.Tensor, sorted_hash: torch.Tensor) -> Ranges:
    """sorted_probe_plain's contract (`sorted_hash` ascending); launches
    K14 for CUDA tensors."""
    if not hashes.is_cuda:
        return sorted_probe_plain(hashes, ok, sorted_hash)
    return _launch(hashes, ok, sorted_hash)


def _launch(hashes: torch.Tensor, ok: torch.Tensor, sorted_hash: torch.Tensor) -> Ranges:
    dev = hashes.device
    m = hashes.shape[0] if hashes.dim() == 1 else -1
    if sorted_hash.dim() != 1:
        raise ValueError(f"sorted_hash: expected [cap], got {tuple(sorted_hash.shape)}")
    if m < 1:
        raise ValueError("probe side has no rows")
    _build.require(hashes, "hashes", torch.int32, (m,))
    _build.require(ok, "ok", torch.bool, (m,), dev)
    _build.require(sorted_hash, "sorted_hash", torch.int64, None, dev)
    cap = sorted_hash.shape[0]
    if cap >= 2**31:
        raise ValueError(f"sorted_hash: {cap} keys, positions must stay below 2^31")
    bits = directory_bits(cap)
    fn = _build.function("dfp_sorted_probe", (
        _build.P, _build.P, _build.I64, _build.P, _build.I64, _build.I32, _build.P, _build.P,
        _build.P, _build.P, _build.P, _build.I64, _build.P))
    start = torch.empty(m, dtype=torch.int32, device=dev)
    count = torch.empty(m, dtype=torch.int32, device=dev)
    base = torch.empty(m, dtype=torch.int32, device=dev)
    total64 = torch.empty((), dtype=torch.int64, device=dev)
    nbytes = scratch_bytes(m, bits)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    err = fn(hashes.data_ptr(), ok.data_ptr(), m, sorted_hash.data_ptr(), cap, bits,
             start.data_ptr(), count.data_ptr(), base.data_ptr(), total64.data_ptr(),
             scratch.data_ptr(), nbytes, _build.stream(dev))
    sorted_probe.launches += 1
    _build.check(err, "sorted_probe")
    return start, count, base, check_total(total64)


sorted_probe.launches = 0
