"""K10 match_flags: which build rows and which probe rows matched.

Replaces the JAX package's `visited` / `probe_matched` scatter-sets
(ops/join.py:363-368), the analog of the reference's ConcurrentBitSet of
visited build rows: outer, semi and anti joins read them. The CUDA kernel
is `csrc/match_flags.cu`, whose header says what bounds it on the H100; the
plain version below is the same function in torch ops. On CPU tensors the
wrapper runs the plain version; on CUDA tensors it launches the kernel or
raises.

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


def match_flags_plain(match: torch.Tensor, build_id: torch.Tensor, probe_idx: torch.Tensor,
                      bcap: int, mcap: int, visited: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(visited bool[bcap], probe_matched bool[mcap]): True at build_id[j]
    and probe_idx[j] for every candidate slot j whose `match` is True; a
    given `visited` keeps its True flags and is updated in place."""
    if visited is None:
        visited = torch.zeros(bcap, dtype=torch.bool, device=match.device)
    probe_matched = torch.zeros(mcap, dtype=torch.bool, device=match.device)
    visited[build_id[match].long()] = True
    probe_matched[probe_idx[match].long()] = True
    return visited, probe_matched


def match_flags(match: torch.Tensor, build_id: torch.Tensor, probe_idx: torch.Tensor,
                bcap: int, mcap: int, visited: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """match_flags_plain's contract; launches K10 for CUDA tensors."""
    if not match.is_cuda:
        return match_flags_plain(match, build_id, probe_idx, bcap, mcap, visited)
    dev = match.device
    n = match.shape[0] if match.dim() == 1 else -1
    _build.require(match, "match", torch.bool, (n,))
    _build.require(build_id, "build_id", torch.int32, (n,), dev)
    _build.require(probe_idx, "probe_idx", torch.int32, (n,), dev)
    if not (0 < bcap < 2**31 and 0 < mcap < 2**31):
        raise ValueError(f"capacities {bcap}, {mcap} out of range")
    accumulate = visited is not None
    if accumulate:
        _build.require(visited, "visited", torch.bool, (bcap,), dev)
    else:
        visited = torch.empty(bcap, dtype=torch.bool, device=dev)
    probe_matched = torch.empty(mcap, dtype=torch.bool, device=dev)
    fn = _build.function("dfp_match_flags", (_build.P, _build.P, _build.P, _build.I64,
                                             _build.P, _build.I64, _build.I32, _build.P,
                                             _build.I64, _build.P))
    err = fn(match.data_ptr(), build_id.data_ptr(), probe_idx.data_ptr(), n,
             visited.data_ptr(), bcap, int(accumulate), probe_matched.data_ptr(), mcap,
             _build.stream(dev))
    match_flags.launches += 1
    _build.check(err, "match_flags")
    return visited, probe_matched


match_flags.launches = 0
