"""K14 sorted_probe: candidate ranges of the probe rows against the SORT
strategy's table.

Replaces the JAX package's SORT branch of `hash_table.probe_ranges`
(ops/hash_table.py:257-263, two `jnp.searchsorted`) and the cumsum of
`probe_candidates` (:283). The CUDA kernel is `csrc/sorted_probe.cu`, whose
header says what bounds it on the H100 (dependent random reads of two
binary searches) and why it runs one thread per probe row; the plain
version below is the same function in torch ops. On CPU tensors the
wrapper runs the plain version; on CUDA tensors it launches the kernel or
raises.

The output is K3's `Ranges` contract (start, count, base, total), with the
same OverflowError when the candidate total reaches 2^31.
"""

from __future__ import annotations

import torch

from . import _build
from .probe_expand import Ranges, check_total

_M32 = 0xFFFFFFFF


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
    """sorted_probe_plain's contract; launches K14 and the scan for CUDA
    tensors."""
    if not hashes.is_cuda:
        return sorted_probe_plain(hashes, ok, sorted_hash)
    dev = hashes.device
    m = hashes.shape[0] if hashes.dim() == 1 else -1
    _build.require(hashes, "hashes", torch.int32, (m,))
    _build.require(ok, "ok", torch.bool, (m,), dev)
    if sorted_hash.dim() != 1:
        raise ValueError(f"sorted_hash: expected [cap], got {tuple(sorted_hash.shape)}")
    _build.require(sorted_hash, "sorted_hash", torch.int64, None, dev)
    if m < 1:
        raise ValueError("probe side has no rows")
    scratch_bytes = _build.function("dfp_sorted_probe_scratch_bytes", (_build.I64,), _build.I64)
    fn = _build.function("dfp_sorted_probe", (
        _build.P, _build.P, _build.I64, _build.P, _build.I64, _build.P, _build.P, _build.P,
        _build.P, _build.P, _build.I64, _build.P))
    start = torch.empty(m, dtype=torch.int32, device=dev)
    count = torch.empty(m, dtype=torch.int32, device=dev)
    base = torch.empty(m, dtype=torch.int32, device=dev)
    total64 = torch.empty((), dtype=torch.int64, device=dev)
    nbytes = scratch_bytes(m)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    err = fn(hashes.data_ptr(), ok.data_ptr(), m, sorted_hash.data_ptr(), sorted_hash.shape[0],
             start.data_ptr(), count.data_ptr(), base.data_ptr(), total64.data_ptr(),
             scratch.data_ptr(), nbytes, _build.stream(dev))
    sorted_probe.launches += 1
    _build.check(err, "sorted_probe")
    return start, count, base, check_total(total64)


sorted_probe.launches = 0
