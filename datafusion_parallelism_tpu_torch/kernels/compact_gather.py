"""K4 compact_gather: stable compaction of the matched candidate pairs and
the columns of both join sides at the survivors.

Replaces the JAX package's `columnar.compaction_indices`, the deferred
`pairs_table` gathers (ops/join.py:393-416) and `_zero_validity_past`. The
CUDA kernel is `csrc/compact_gather.cu`, whose header says what bounds it on
the H100; the plain version below is the same function in torch ops. On CPU
tensors the wrapper runs the plain version; on CUDA tensors it launches the
kernel or raises.

It reads the input tables' column buffers themselves, through a
descriptor a column passed by value (MAX_COLS a launch: a wider pair of
tables takes a launch a group of columns, `col_groups`), so the deferred
join packs neither input nor unpacks its output.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from . import _build

Column = Tuple[torch.Tensor, torch.Tensor]
Gathered = Tuple[List[Column], List[Column], torch.Tensor]

MAX_COLS = 64   # column descriptors a launch (csrc/compact_gather.cu)
_WIDTH = {torch.bool: 1, torch.int32: 4, torch.float32: 4, torch.int64: 8, torch.float64: 8}


def compact_gather_plain(match: torch.Tensor, build_id: torch.Tensor,
                         probe_idx: torch.Tensor, build_cols: Sequence[Column],
                         probe_cols: Sequence[Column],
                         total: Optional[torch.Tensor] = None) -> Gathered:
    """(build columns, probe columns, n_match) over the out_cap candidate
    slots: the j-th match (in slot order) gives output row j = build row
    build_id[slot] of every (values, validity) column of `build_cols` and
    probe row probe_idx[slot] of `probe_cols`. Rows at or past n_match
    (int64 0-dim) are zeros and False. `total` (K3's candidate total) names
    the slots that can match, those below min(total, out_cap); match is
    False past them by K3's contract, so the result does not depend on
    it."""
    out_cap = match.shape[0]
    # compaction_indices: stable argsort of ~match puts the matches first
    cidx = torch.argsort((~match).to(torch.int32), stable=True)
    n_match = match.sum(dtype=torch.int64)
    ok = torch.arange(out_cap, device=match.device) < n_match

    def take(cols, ids):
        idx = ids.long().index_select(0, cidx)
        return [(torch.where(ok, v.index_select(0, idx), torch.zeros((), dtype=v.dtype)),
                 ok & valid.index_select(0, idx)) for v, valid in cols]

    return take(build_cols, build_id), take(probe_cols, probe_idx), n_match


def col_groups(n_build: int, n_probe: int) -> List[List[Tuple[int, int]]]:
    """The (side, column) pairs of both tables, build's first, in the runs
    of at most MAX_COLS that one launch each takes (one empty run where
    there are no columns: the count is still made)."""
    cols = [(0, k) for k in range(n_build)] + [(1, k) for k in range(n_probe)]
    return [cols[i:i + MAX_COLS] for i in range(0, len(cols), MAX_COLS)] or [[]]


class ColC(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("src_valid", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("out_valid", ctypes.c_void_p),
                ("width", ctypes.c_int), ("side", ctypes.c_int)]


class SpecC(ctypes.Structure):
    """One launch's columns, passed by value in the kernel's parameters."""
    _fields_ = [("n", ctypes.c_int), ("c", ColC * MAX_COLS)]


def _side(cols: Sequence[Column], name: str, dev) -> List[Column]:
    """One side's columns as the kernel reads them (contiguous, as K12's
    pack took them), checked: one capacity, a K4 width, bool validity."""
    out = []
    for k, (v, valid) in enumerate(cols):
        if v.dtype not in _WIDTH:
            raise TypeError(f"{name} column {k}: dtype {v.dtype} has no K4 width")
        v, valid = v.contiguous(), valid.contiguous()
        cap = out[0][0].shape[0] if out else v.shape[0]
        _build.require(v, f"{name} column {k} values", v.dtype, (cap,), dev)
        _build.require(valid, f"{name} column {k} validity", torch.bool, (cap,), dev)
        out.append((v, valid))
    return out


def compact_gather(match, build_id, probe_idx, build_cols, probe_cols,
                   total: Optional[torch.Tensor] = None) -> Gathered:
    """compact_gather_plain's contract; launches K4 for CUDA tensors, once
    per run of col_groups, its blocks past min(total, out_cap) leaving at
    once."""
    if not match.is_cuda:
        return compact_gather_plain(match, build_id, probe_idx, build_cols, probe_cols, total)
    dev = match.device
    n = match.shape[0] if match.dim() == 1 else -1
    _build.require(match, "match", torch.bool, (n,))
    _build.require(build_id, "build_id", torch.int32, (n,), dev)
    _build.require(probe_idx, "probe_idx", torch.int32, (n,), dev)
    if total is not None:
        _build.require(total, "total", torch.int32, (), dev)
    sides = (_side(build_cols, "build", dev), _side(probe_cols, "probe", dev))
    outs = tuple([(torch.empty(n, dtype=v.dtype, device=dev),
                   torch.empty(n, dtype=torch.bool, device=dev)) for v, _ in cols]
                 for cols in sides)
    scratch_bytes = _build.function("dfp_compact_gather_scratch_bytes", (_build.I64,),
                                    _build.I64)
    fn = _build.function("dfp_compact_gather", (
        ctypes.POINTER(SpecC), _build.P, _build.P, _build.P, _build.P, _build.I64, _build.P,
        _build.P, _build.I64, _build.P))
    n_match = torch.empty((), dtype=torch.int64, device=dev)
    nbytes = scratch_bytes(n)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    for group in col_groups(len(sides[0]), len(sides[1])):
        spec = SpecC(n=len(group))
        for k, (side, c) in enumerate(group):
            (v, valid), (ov, ovalid) = sides[side][c], outs[side][c]
            spec.c[k].src, spec.c[k].src_valid = v.data_ptr(), valid.data_ptr()
            spec.c[k].out, spec.c[k].out_valid = ov.data_ptr(), ovalid.data_ptr()
            spec.c[k].width, spec.c[k].side = _WIDTH[v.dtype], side
        err = fn(ctypes.byref(spec), match.data_ptr(), build_id.data_ptr(),
                 probe_idx.data_ptr(), total.data_ptr() if total is not None else None, n,
                 n_match.data_ptr(), scratch.data_ptr(), nbytes, _build.stream(dev))
        compact_gather.launches += 1
        _build.check(err, "compact_gather")
    return outs[0], outs[1], n_match


compact_gather.launches = 0
