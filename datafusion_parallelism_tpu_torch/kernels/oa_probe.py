"""K16 oa_probe: candidate ranges of the probe rows against the OA
strategy's open-addressing table.

Replaces the JAX package's `hash_table._probe_oa` (ops/hash_table.py:180,
a lockstep `while_loop` over all probe rows) and the cumsum of
`probe_candidates` (:283). The CUDA kernel is `csrc/oa_probe.cu`, whose
header says what bounds it on the H100 (random reads of short walks) and
why each row walks on its own thread; the plain version below is the JAX
loop in torch ops. On CPU tensors the wrapper runs the plain version; on
CUDA tensors it launches the kernel or raises.

The output is K3's `Ranges` contract (start, count, base, total), with the
same OverflowError when the candidate total reaches 2^31.
"""

from __future__ import annotations

import torch

from . import _build
from .probe_expand import Ranges, check_total

_M32 = 0xFFFFFFFF


def oa_probe_plain(home: torch.Tensor, hashes: torch.Tensor, ok: torch.Tensor,
                   slots: torch.Tensor) -> Ranges:
    """(start, count, base, total) per probe row: every row with `ok` walks
    the int64 `slots` [S] from its home slot, one slot a step and all rows
    in lockstep (at most S steps): seeking, an empty slot (0) ends it with
    count 0; the first slot whose high word is the row's hash (uint32 bits
    in int32) sets start and count 1; counting, each further equal hash adds
    one, anything else ends it. Rows without `ok`: start 0, count 0."""
    S, m, dev = slots.shape[0], home.shape[0], home.device
    h = hashes.long() & _M32
    cur = home.long()
    start = torch.zeros(m, dtype=torch.int64, device=dev)
    count = torch.zeros(m, dtype=torch.int64, device=dev)
    phase = torch.where(ok, 0, 2)          # 0 seeking, 1 counting, 2 done
    k = 0
    while k < S:
        if k % 16 == 0 and not bool((phase < 2).any()):
            break
        v = slots.index_select(0, cur)
        empty = v == 0
        match = ~empty & (((v >> 32) & _M32) == h)
        seeking, counting = phase == 0, phase == 1
        found = seeking & match
        start = torch.where(found, cur, start)
        count = torch.where(found, 1, torch.where(counting & match, count + 1, count))
        phase = torch.where(seeking & empty, 2,
                            torch.where(found, 1, torch.where(counting & ~match, 2, phase)))
        cur = torch.clamp(torch.where(phase < 2, cur + 1, cur), max=S - 1)
        k += 1
    count = count.to(torch.int32)
    cum = torch.cumsum(count, 0, dtype=torch.int64)
    total = check_total(cum[-1])
    return start.to(torch.int32), count, (cum - count).to(torch.int32), total


def oa_probe(home: torch.Tensor, hashes: torch.Tensor, ok: torch.Tensor,
             slots: torch.Tensor) -> Ranges:
    """oa_probe_plain's contract; launches K16 and the scan for CUDA
    tensors."""
    if not home.is_cuda:
        return oa_probe_plain(home, hashes, ok, slots)
    dev = home.device
    m = home.shape[0] if home.dim() == 1 else -1
    _build.require(home, "home", torch.int32, (m,))
    _build.require(hashes, "hashes", torch.int32, (m,), dev)
    _build.require(ok, "ok", torch.bool, (m,), dev)
    if slots.dim() != 1 or slots.shape[0] < 1:
        raise ValueError(f"slots: expected [S], got {tuple(slots.shape)}")
    _build.require(slots, "slots", torch.int64, None, dev)
    if m < 1:
        raise ValueError("probe side has no rows")
    scratch_bytes = _build.function("dfp_oa_probe_scratch_bytes", (_build.I64,), _build.I64)
    fn = _build.function("dfp_oa_probe", (
        _build.P, _build.P, _build.P, _build.I64, _build.P, _build.I64, _build.P, _build.P,
        _build.P, _build.P, _build.P, _build.I64, _build.P))
    start = torch.empty(m, dtype=torch.int32, device=dev)
    count = torch.empty(m, dtype=torch.int32, device=dev)
    base = torch.empty(m, dtype=torch.int32, device=dev)
    total64 = torch.empty((), dtype=torch.int64, device=dev)
    nbytes = scratch_bytes(m)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    err = fn(home.data_ptr(), hashes.data_ptr(), ok.data_ptr(), m, slots.data_ptr(),
             slots.shape[0], start.data_ptr(), count.data_ptr(), base.data_ptr(),
             total64.data_ptr(), scratch.data_ptr(), nbytes, _build.stream(dev))
    oa_probe.launches += 1
    _build.check(err, "oa_probe")
    return start, count, base, check_total(total64)


oa_probe.launches = 0
