"""K7 segment_agg: group boundaries and per-group reductions over rows that
are already in group order.

Replaces the sorted path of the JAX package's `hash_aggregate_counted`
(ops/aggregate.py:338-432: value-compare boundary flags with NULL == NULL,
`compaction_indices` of the boundaries, SUM/COUNT/AVG as prefix-sum
differences, MIN/MAX as a sorted scatter). The CUDA kernel is
`csrc/segment_agg.cu`: one pass by decoupled look-back over tiles of
TILE_ROWS rows, whose work follows the rows below n_valid, then a zero
tail; its header says what bounds it on the H100 and how float64 sums keep
their bits from run to run. The plain version below is the same function
in torch ops. On CPU tensors the wrapper runs the plain version; on CUDA
tensors it launches the kernel or raises.

The group key comes as K1 reads one (kernels/hash_slot.py): an int32 word
matrix and, per key column, its kind (ops.hashing's KIND_*), word rows and
validity (row, bit). Two adjacent rows are in one group when every key
column is NULL in both, or valid in both and equal (floats compared as
floats: -0.0 == 0.0, NaN != NaN).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from ..ops.hashing import KIND_F32, KIND_F64, KIND_I32
from . import _agg, _build
from .hash_slot import MAX_KEY_COLUMNS, KeyCol, col_groups
from .hash_slot import _spec as key_spec

Result = Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor], torch.Tensor]

# csrc/segment_agg.cu's pass: rows a tile (SA_TILE), tiles a window whose
# values fold in a fixed order (SA_WINDOW), key specs of 16 columns a
# launch (MAX_SPECS)
TILE_ROWS = 8192
WINDOW = 32
MAX_KEY_SPECS = 8


def scratch_layout(n: int, n_aggs: int) -> Tuple[int, int]:
    """(bytes zeroed by the launch's memset, scratch bytes) of a launch over
    n rows and n_aggs requests: the group counts' look-back status words and
    the tile counter (scan.cuh), a value state word a tile, then the tiles'
    published values and each window's inclusive values, one slot a request
    and one for the segment starts, each part from a 256-byte boundary."""
    def align(b):
        return -(-b // 256) * 256
    tiles = -(-n // TILE_ROWS)
    windows = -(-tiles // WINDOW)
    zeroed = (tiles + 1) * 8 + tiles * 4
    slots = n_aggs + 1
    return zeroed, align(zeroed) + align(slots * tiles * 8) + align(slots * windows * 8)


def _key_values(words: torch.Tensor, kind: int, rows) -> torch.Tensor:
    if kind == KIND_I32:
        return words[rows[0]]
    if kind == KIND_F32:
        return words[rows[0]].contiguous().view(torch.float32)
    v = (words[rows[1]].long() << 32) | (words[rows[0]].long() & 0xFFFFFFFF)
    return v.view(torch.float64) if kind == KIND_F64 else v


def boundaries_plain(words: torch.Tensor, cols: Sequence[KeyCol],
                     n_valid: torch.Tensor) -> torch.Tensor:
    """bool[n]: row i < n_valid opens a group (row 0, or a key differs from
    row i-1)."""
    n = words.shape[1]
    ar = torch.arange(n, device=words.device)
    same = torch.ones(n, dtype=torch.bool, device=words.device)
    for kind, rows, (vrow, vbit) in cols:
        valid = ((words[vrow] >> vbit) & 1).to(torch.bool)
        v = _key_values(words, kind, rows)
        pv, pvalid = torch.roll(v, 1), torch.roll(valid, 1)
        same = same & ((valid & pvalid & (v == pv)) | (~valid & ~pvalid))
    return (~same | (ar == 0)) & (ar < n_valid)


def segment_agg_plain(words: torch.Tensor, cols: Sequence[KeyCol], n_valid: torch.Tensor,
                      reqs: Sequence[_agg.Request], out_cap: int) -> Result:
    """(starts int32[out_cap], sizes int64[out_cap], results, n_groups):
    over the first n_valid (0-dim int32) rows of `words` [R, n], group g
    starts at row starts[g] and holds sizes[g] rows; results holds one
    [out_cap] tensor per aggregate request (kernels/_agg.py) in its
    accumulator type; n_groups (int32 0-dim) is the true group count, which
    may exceed out_cap (later groups drop). Entries at or past
    min(n_groups, out_cap) are zeros.

    When groups drop, the last kept group's size, counts and sums run to
    row n_valid, over the dropped groups' rows too, as the JAX package's
    prefix-sum differences do (ops/aggregate.py:378-379); its min and max
    cover its own rows."""
    boundary = boundaries_plain(words, cols, n_valid)
    n_groups = boundary.sum(dtype=torch.int32)
    first = torch.nonzero(boundary).flatten()
    kept = min(int(n_groups), out_cap)
    ends = torch.cat([first[1:kept], n_valid.reshape(1).long()])
    seg = torch.where(torch.arange(words.shape[1], device=words.device) < n_valid,
                      torch.cumsum(boundary, 0) - 1, -1)
    seg_sum = torch.where(seg >= out_cap, out_cap - 1, seg)
    starts = torch.zeros(out_cap, dtype=torch.int32, device=words.device)
    sizes = torch.zeros(out_cap, dtype=torch.int64, device=words.device)
    starts[:kept] = first[:kept].to(torch.int32)
    sizes[:kept] = (ends - first[:kept])[:kept]
    ok = torch.arange(out_cap, device=words.device) < kept
    results = [torch.where(ok, _agg.reduce_plain(f, v, m, seg_sum if f in ("count", "sum")
                                                 else seg, out_cap), 0)
               for f, v, m in reqs]
    return starts, sizes, results, n_groups


def check_args(words: torch.Tensor, cols: Sequence[KeyCol], n_valid: torch.Tensor,
               out_cap: int):
    """The wrapper's host-side checks of the key and the sizes: words a
    contiguous int32 [R, n], n_valid an int32 0-dim count on its device,
    0 <= out_cap < 2^31, every key column inside the matrix and at most
    MAX_KEY_SPECS runs of 16 key columns; raises as `_build.require` does.
    Returns the key specs, one a run (kernels/hash_slot.py `_spec`)."""
    if words.dim() != 2:
        raise ValueError(f"words: expected [R, n], got {tuple(words.shape)}")
    if words.dtype != torch.int32:
        raise TypeError(f"words: dtype {words.dtype}, expected torch.int32")
    if not words.is_contiguous():
        raise ValueError("words: must be contiguous")
    if n_valid.dtype != torch.int32 or n_valid.dim() != 0 or n_valid.device != words.device:
        raise ValueError(f"n_valid: expected an int32 0-dim count on {words.device}, got "
                         f"{n_valid.dtype} {tuple(n_valid.shape)} on {n_valid.device}")
    if not 0 <= out_cap < 2**31:
        raise ValueError(f"out_cap {out_cap} out of range")
    groups = col_groups(cols)
    if len(groups) > MAX_KEY_SPECS:
        raise ValueError(f"{len(cols)} key columns; K7 takes at most "
                         f"{MAX_KEY_SPECS * MAX_KEY_COLUMNS}")
    return [key_spec(g, words.shape[0]) for g in groups]


def segment_agg(words: torch.Tensor, cols: Sequence[KeyCol], n_valid: torch.Tensor,
                reqs: Sequence[_agg.Request], out_cap: int) -> Result:
    """segment_agg_plain's contract; launches K7 for CUDA tensors: once per
    run of at most 32 requests (_agg.request_groups), each over the whole
    key (its columns 16 at a time, folded in the kernel)."""
    if not words.is_cuda:
        return segment_agg_plain(words, cols, n_valid, reqs, out_cap)
    specs = check_args(words, cols, n_valid, out_cap)
    dev, n = words.device, words.shape[1]
    keys = (ctypes.c_int * sum(len(s) for s in specs))(*[x for s in specs for x in s])
    scratch_bytes = _build.function("dfp_segment_agg_scratch_bytes",
                                    (_build.I64, _build.I32), _build.I64)
    fn = _build.function("dfp_segment_agg", (
        _build.P, _build.I64, ctypes.POINTER(ctypes.c_int), _build.I32, _build.P,
        ctypes.POINTER(_agg.AggSpecC), _build.I64, _build.P, _build.P, _build.P, _build.P,
        _build.P, _build.I64, _build.P))
    starts = torch.empty(out_cap, dtype=torch.int32, device=dev)
    sizes = torch.empty(out_cap, dtype=torch.int64, device=dev)
    out = torch.empty((len(reqs), out_cap), dtype=torch.int64, device=dev)
    n_groups = torch.empty((), dtype=torch.int64, device=dev)
    lo = 0
    for group in _agg.request_groups(reqs):
        spec = _agg.spec(group, n, dev)
        nbytes = scratch_bytes(n, len(group))
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        # every launch writes the same starts, sizes and group count
        err = fn(words.data_ptr(), n, keys, len(specs), n_valid.data_ptr(), ctypes.byref(spec),
                 out_cap, starts.data_ptr(), sizes.data_ptr(), out[lo:].data_ptr(),
                 n_groups.data_ptr(), scratch.data_ptr(), nbytes, _build.stream(dev))
        segment_agg.launches += 1
        _build.check(err, "segment_agg")
        lo += len(group)
    return starts, sizes, _agg.split_results(out, reqs), n_groups.to(torch.int32)


segment_agg.launches = 0
