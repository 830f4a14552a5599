"""K11 concat_rows: the valid rows of several packed tables, one after the
other, in one table.

Replaces the JAX package's `concat_tables` scatter (utils/columnar.py:
818-843), which LEFT, RIGHT and FULL joins use to put the matched pairs
and the unmatched rows together. The CUDA kernel is `csrc/concat_rows.cu`,
whose header says what bounds it on the H100; the plain version below is
the same function in torch ops. On CPU tensors the wrapper runs the plain
version; on CUDA tensors it launches the kernel or raises, through the
lean launch path (`_lean.py`).

A part is (words int32 [W, cap_p], f64 float64 [F, cap_p], num_rows int32
0-dim on the device): the same W and F in every part, each part's valid
rows at its front. Offsets come from the parts' device row counts, so
nothing is read back to the host.
"""

from __future__ import annotations

from array import array
from typing import Sequence, Tuple

import torch

from . import _build, _lean

MAX_PARTS = 8
Part = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def concat_rows_plain(parts: Sequence[Part]) -> Tuple[torch.Tensor, torch.Tensor,
                                                      torch.Tensor]:
    """(words [W, sum cap_p], f64 [F, sum cap_p], num_rows int32 0-dim): part
    p's first num_rows_p rows at rows [off_p, off_p + num_rows_p), off_p the
    sum of the earlier parts' num_rows; the rows past the total are zeros
    (their validity words read NULL)."""
    dev = parts[0][0].device
    words = torch.cat([w for w, _, _ in parts], 1)
    f64 = torch.cat([f for _, f, _ in parts], 1)
    total_cap = words.shape[1]
    n = torch.stack([r.reshape(()).long() for _, _, r in parts])
    ends = torch.cumsum(n, 0)
    caps = torch.tensor([w.shape[1] for w, _, _ in parts], dtype=torch.int64, device=dev)
    cap_base = torch.cumsum(caps, 0) - caps
    j = torch.arange(total_cap, dtype=torch.int64, device=dev)
    p = torch.searchsorted(ends, j, right=True)
    ok = p < len(parts)
    p = p.clamp(max=len(parts) - 1)
    src = torch.where(ok, cap_base[p] + j - (ends[p] - n[p]), 0)
    return (torch.where(ok, words.index_select(1, src), 0),
            torch.where(ok, f64.index_select(1, src), 0.0), ends[-1].to(torch.int32))


def check_parts(parts: Sequence[Part]) -> Tuple[int, int, int, array, int]:
    """The wrapper's host-side checks in one pass: 1-8 parts, each (words
    int32 [W, cap_p], float64 [F, cap_p], num_rows int32 0-dim) on the
    first part's device and contiguous, the capacities summing below 2^31;
    raises as `_build.require` does. Returns (W, F, total capacity, the
    parts as the kernel takes them, device index): csrc/concat_rows.cu's
    ConcatParts, 1 + 4 * MAX_PARTS int64 -- the count of parts, then the
    word matrices' and the float64 matrices' addresses, the capacities and
    the row counts' addresses, each padded to MAX_PARTS."""
    if not 1 <= len(parts) <= MAX_PARTS:
        raise ValueError(f"concat_rows takes 1-{MAX_PARTS} parts, got {len(parts)}")
    w, f = parts[0][0].shape[0], parts[0][1].shape[0]
    index = parts[0][0].get_device()
    ptrs, f64s, caps, counts = [], [], [], []
    for i, (words, f64, num_rows) in enumerate(parts):
        if words.dim() != 2 or f64.dim() != 2:
            raise ValueError("part words [W, cap] and float64 [F, cap] expected")
        cap = words.shape[1]
        _lean.check(((words, "words", torch.int32, (w, cap)),
                     (f64, "float64", torch.float64, (f, cap)),
                     (num_rows, "num_rows", torch.int32, ())), index, f"part {i} ")
        ptrs.append(words.data_ptr())
        f64s.append(f64.data_ptr())
        caps.append(cap)
        counts.append(num_rows.data_ptr())
    total_cap = sum(caps)
    if total_cap >= 2**31:
        raise ValueError(f"concatenated capacity {total_cap} reaches 2^31")
    pad = [0] * (MAX_PARTS - len(parts))
    spec = array("q", [len(parts), *ptrs, *pad, *f64s, *pad, *caps, *pad, *counts, *pad])
    return w, f, total_cap, spec, index


_launch = None   # dfp_concat_rows, resolved at the first launch


def concat_rows(parts: Sequence[Part]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """concat_rows_plain's contract; launches K11 for CUDA tensors."""
    global _launch
    if not parts[0][0].is_cuda:
        return concat_rows_plain(parts)
    w, f, total_cap, spec, index = check_parts(parts)
    if _launch is None:
        _launch = _build.function("dfp_concat_rows", (
            _build.P, _build.I32, _build.I32, _build.I64, _build.P, _build.P, _build.P,
            _build.P))
    words, f64, num_rows = parts[0]
    out = words.new_empty((w, total_cap))
    out_f64 = f64.new_empty((f, total_cap))
    total = num_rows.new_empty(())
    err = _launch(spec.buffer_info()[0], w, f, total_cap, out.data_ptr(), out_f64.data_ptr(),
                  total.data_ptr(), _lean.current_stream(index))
    concat_rows.launches += 1
    _build.check(err, "concat_rows")
    return out, out_f64, total


concat_rows.launches = 0
