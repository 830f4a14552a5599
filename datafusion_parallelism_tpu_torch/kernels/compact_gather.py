"""K4 compact_gather: stable compaction of the matched candidate pairs and
the full packed rows of both join sides at the survivors.

Replaces the JAX package's `columnar.compaction_indices`, the deferred
`pairs_table` gathers (ops/join.py:393-416) and `_zero_validity_past`. The
CUDA kernel is `csrc/compact_gather.cu`, whose header says what bounds it on
the H100; the plain version below is the same function in torch ops. On CPU
tensors the wrapper runs the plain version; on CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

Gathered = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def compact_gather_plain(match: torch.Tensor, build_id: torch.Tensor,
                         probe_idx: torch.Tensor, bwords: torch.Tensor,
                         bf64: torch.Tensor, pwords: torch.Tensor,
                         pf64: torch.Tensor) -> Gathered:
    """(out_b, out_bf64, out_p, out_pf64, n_match) over the out_cap
    candidate slots: the j-th match (in slot order) gives output row j =
    build row build_id[slot] of `bwords` [Wb, bcap] (+ float64 sidecars
    `bf64` [Fb, bcap]) and probe row probe_idx[slot] of `pwords`/`pf64`.
    Rows at or past n_match (int64 0-dim) are zeros."""
    out_cap = match.shape[0]
    # compaction_indices: stable argsort of ~match puts the matches first
    cidx = torch.argsort((~match).to(torch.int32), stable=True)
    n_match = match.sum(dtype=torch.int64)
    ok = torch.arange(out_cap, device=match.device) < n_match
    b = build_id.long().index_select(0, cidx)
    p = probe_idx.long().index_select(0, cidx)

    def take(mat, idx):
        return torch.where(ok, mat.index_select(1, idx), 0)

    return take(bwords, b), take(bf64, b), take(pwords, p), take(pf64, p), n_match


def compact_gather(match, build_id, probe_idx, bwords, bf64, pwords, pf64) -> Gathered:
    """compact_gather_plain's contract; launches K4 for CUDA tensors."""
    if not match.is_cuda:
        return compact_gather_plain(match, build_id, probe_idx, bwords, bf64, pwords, pf64)
    dev = match.device
    n = match.shape[0] if match.dim() == 1 else -1
    _build.require(match, "match", torch.bool, (n,))
    _build.require(build_id, "build_id", torch.int32, (n,), dev)
    _build.require(probe_idx, "probe_idx", torch.int32, (n,), dev)
    for name, words, f64 in (("build", bwords, bf64), ("probe", pwords, pf64)):
        if words.dim() != 2 or f64.dim() != 2 or f64.shape[1] != words.shape[1]:
            raise ValueError(f"{name}: words [W, cap] and float64 [F, cap] expected")
        _build.require(words, f"{name} words", torch.int32, None, dev)
        _build.require(f64, f"{name} float64", torch.float64, None, dev)
    scratch_bytes = _build.function("dfp_compact_gather_scratch_bytes", (_build.I64,),
                                    _build.I64)
    fn = _build.function("dfp_compact_gather", (
        _build.P, _build.I64, _build.P, _build.P, _build.P, _build.I32, _build.I64,
        _build.P, _build.I32, _build.P, _build.I32, _build.I64, _build.P, _build.I32,
        _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.I64, _build.P))
    out_b = torch.empty((bwords.shape[0], n), dtype=torch.int32, device=dev)
    out_bf64 = torch.empty((bf64.shape[0], n), dtype=torch.float64, device=dev)
    out_p = torch.empty((pwords.shape[0], n), dtype=torch.int32, device=dev)
    out_pf64 = torch.empty((pf64.shape[0], n), dtype=torch.float64, device=dev)
    n_match = torch.empty((), dtype=torch.int64, device=dev)
    nbytes = scratch_bytes(n)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    err = fn(match.data_ptr(), n, build_id.data_ptr(), probe_idx.data_ptr(),
             bwords.data_ptr(), bwords.shape[0], bwords.shape[1],
             bf64.data_ptr(), bf64.shape[0],
             pwords.data_ptr(), pwords.shape[0], pwords.shape[1],
             pf64.data_ptr(), pf64.shape[0],
             out_b.data_ptr(), out_bf64.data_ptr(), out_p.data_ptr(), out_pf64.data_ptr(),
             n_match.data_ptr(), scratch.data_ptr(), nbytes, _build.stream(dev))
    compact_gather.launches += 1
    _build.check(err, "compact_gather")
    return out_b, out_bf64, out_p, out_pf64, n_match


compact_gather.launches = 0
