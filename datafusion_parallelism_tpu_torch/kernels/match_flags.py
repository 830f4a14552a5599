"""K10 match_flags: which build rows and which probe rows matched.

Replaces the JAX package's `visited` / `probe_matched` scatter-sets
(ops/join.py:363-368), the analog of the reference's ConcurrentBitSet of
visited build rows: outer, semi and anti joins read them. The CUDA kernel
is `csrc/match_flags.cu`, whose header says what bounds it on the H100; the
plain version below is the same function in torch ops. On CPU tensors the
wrapper runs the plain version; on CUDA tensors it launches the kernel or
raises.

The caller names the flags it reads: a capacity of None (`bcap` for the
visited build rows, `mcap` for the matched probe rows) leaves that flag
out, and it comes back as None. `total` (K3's candidate total, int32
0-dim on the match's device) names the candidate slots, those below
min(total, n); past it K3 leaves match False, so they set nothing. The
JAX package writes both flags over every slot and XLA drops the unread
one as dead code.

Accumulate mode (a caller-given `visited`): the matches are ORed into that
bool [bcap] buffer in place, with no zero fill, and it is returned as the
visited flags. Streamed execution folds a frozen build side's visited
flags across probe chunks this way, and grace's mask merge across
partitions (JAX runtime/streaming.py's `incoming | vis`,
models/physical.py:309-310). A chunk that must run again after a capacity
overflow ORs into the same buffer: its truncated first attempt set a
subset of the flags the full attempt sets.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

ALIGN = 16   # bytes the visited-only kernel loads at a time: 16 match bytes, 4 build ids

Flags = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]


def match_flags_plain(match: torch.Tensor, build_id: torch.Tensor, probe_idx: torch.Tensor,
                      bcap: Optional[int], mcap: Optional[int],
                      visited: Optional[torch.Tensor] = None,
                      total: Optional[torch.Tensor] = None) -> Flags:
    """(visited bool[bcap] or None, probe_matched bool[mcap] or None): True
    at build_id[j] and probe_idx[j] for every candidate slot j below
    min(total, n) (every slot when total is None) whose `match` is True;
    a flag whose capacity is None is not made. A given `visited` keeps
    its True flags and is updated in place."""
    hit = match
    if total is not None:
        hit = match & (torch.arange(match.shape[0], device=match.device) < total)
    probe_matched = None
    if bcap is not None:
        if visited is None:
            visited = torch.zeros(bcap, dtype=torch.bool, device=match.device)
        visited[build_id[hit].long()] = True
    if mcap is not None:
        probe_matched = torch.zeros(mcap, dtype=torch.bool, device=match.device)
        probe_matched[probe_idx[hit].long()] = True
    return visited, probe_matched


def check_args(match, build_id, probe_idx, bcap, mcap, visited=None, total=None
               ) -> Tuple[int, int]:
    """The wrapper's checks before a launch; returns (n, head): the slots,
    and the first ones (fewer than ALIGN) that the kernel takes one at a
    time before `match` reaches a 16-byte boundary. Raises on what the
    kernel does not take: no flag asked, a capacity out of range, a
    visited buffer without its capacity, a total that is not int32 0-dim
    on the match's device; with the visited flags alone asked (which the
    kernel reads 16 bytes at a time), build ids that are not 16-byte
    aligned where the match is."""
    dev = match.device
    n = match.shape[0] if match.dim() == 1 else -1
    _build.require(match, "match", torch.bool, (n,))
    if bcap is None and mcap is None:
        raise ValueError("match_flags: no flag asked for")
    if visited is not None and bcap is None:
        raise ValueError("match_flags: a visited buffer needs its capacity bcap")
    for name, cap in (("bcap", bcap), ("mcap", mcap)):
        if cap is not None and not 0 < cap < 2**31:
            raise ValueError(f"{name} {cap} out of range")
    if visited is not None:
        _build.require(visited, "visited", torch.bool, (bcap,), dev)
    if total is not None:
        _build.require(total, "total", torch.int32, (), dev)
    head = min(-match.data_ptr() % ALIGN, n)
    for name, ids, asked in (("build_id", build_id, bcap), ("probe_idx", probe_idx, mcap)):
        if asked is not None:
            _build.require(ids, name, torch.int32, (n,), dev)
    if mcap is None and n > head and (build_id.data_ptr() + 4 * head) % ALIGN:
        raise ValueError(f"build_id: not {ALIGN}-byte aligned where the match is (slot {head})")
    return n, head


def match_flags(match: torch.Tensor, build_id: torch.Tensor, probe_idx: torch.Tensor,
                bcap: Optional[int], mcap: Optional[int],
                visited: Optional[torch.Tensor] = None,
                total: Optional[torch.Tensor] = None) -> Flags:
    """match_flags_plain's contract; launches K10 for CUDA tensors."""
    if not match.is_cuda:
        return match_flags_plain(match, build_id, probe_idx, bcap, mcap, visited, total)
    n, head = check_args(match, build_id, probe_idx, bcap, mcap, visited, total)
    dev = match.device
    accumulate = visited is not None
    if bcap is not None and not accumulate:
        visited = torch.empty(bcap, dtype=torch.bool, device=dev)
    probe_matched = torch.empty(mcap, dtype=torch.bool, device=dev) if mcap is not None else None
    fn = _build.function("dfp_match_flags", (_build.P, _build.P, _build.P, _build.I64,
                                             _build.P, _build.I32, _build.P, _build.I64,
                                             _build.I32, _build.P, _build.I64, _build.P))
    err = fn(match.data_ptr(), build_id.data_ptr(), probe_idx.data_ptr(), n,
             None if total is None else total.data_ptr(), head,
             None if visited is None else visited.data_ptr(), bcap or 0, int(accumulate),
             None if probe_matched is None else probe_matched.data_ptr(), mcap or 0,
             _build.stream(dev))
    match_flags.launches += 1
    _build.check(err, "match_flags")
    return visited, probe_matched


match_flags.launches = 0
