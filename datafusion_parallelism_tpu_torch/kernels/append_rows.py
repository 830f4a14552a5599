"""K13 append_rows: a grace partition's rows appended to the row-union
accumulator, in place.

Replaces the JAX package's row-union append (runtime/grace.py:544-553),
the merge of a grace-partitioned plan whose root is a join (TPC-H Q2's
shape). The accumulator is held packed (words [W, acc_cap] int32 and
float64 sidecars [F, acc_cap]); row i < num_rows of the partition's
packed output goes to row acc_rows + i where that is below acc_cap, and
the new count acc_rows + num_rows comes back as a device tensor. Nothing
is read back to the host. The CUDA kernel is `csrc/append_rows.cu`, whose
header says what bounds it on the H100; the plain version below is the
same function in torch ops. On CPU tensors the wrapper runs the plain
version; on CUDA tensors it launches the kernel or raises. A union
partition moves a few rows, so the wrapper's host time is most of a call:
it takes the lean launch path (`_lean.py`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build, _lean


def append_rows_plain(acc: torch.Tensor, acc_f64: torch.Tensor, acc_rows: torch.Tensor,
                      words: torch.Tensor, f64: torch.Tensor,
                      num_rows: torch.Tensor) -> torch.Tensor:
    """Write rows i < num_rows of `words` / `f64` into `acc` / `acc_f64`
    at acc_rows + i (dropped at or past acc_cap); return acc_rows +
    num_rows (int32 0-dim)."""
    acc_cap, cap = acc.shape[1], words.shape[1]
    i = torch.arange(cap, dtype=torch.int64, device=acc.device)
    dst = i + acc_rows.long()
    ok = (i < num_rows.long()) & (dst < acc_cap)
    acc[:, dst[ok]] = words[:, ok]
    acc_f64[:, dst[ok]] = f64[:, ok]
    return (acc_rows + num_rows).to(torch.int32)


def check_args(acc: torch.Tensor, acc_f64: torch.Tensor, acc_rows: torch.Tensor,
               words: torch.Tensor, f64: torch.Tensor,
               num_rows: torch.Tensor) -> Tuple[int, int, int, int, int]:
    """The wrapper's host-side checks in one pass: every tensor on acc's
    device, of its dtype, shape ([W, acc_cap], [F, acc_cap], (), [W, cap],
    [F, cap], ()) and contiguous; raises as `_build.require` does. Returns
    (W, F, acc_cap, cap, device index)."""
    if acc.dim() != 2 or words.dim() != 2 or acc.shape[0] != words.shape[0]:
        raise ValueError(f"acc {tuple(acc.shape)} and words {tuple(words.shape)}: "
                         "expected [W, acc_cap] and [W, cap]")
    w, acc_cap = acc.shape
    cap = words.shape[1]
    f = acc_f64.shape[0] if acc_f64.dim() == 2 else -1
    index = acc.get_device()
    _lean.check(((acc, "acc", torch.int32, (w, acc_cap)),
                 (acc_f64, "acc_f64", torch.float64, (f, acc_cap)),
                 (acc_rows, "acc_rows", torch.int32, ()),
                 (words, "words", torch.int32, (w, cap)),
                 (f64, "f64", torch.float64, (f, cap)),
                 (num_rows, "num_rows", torch.int32, ())), index)
    return w, f, acc_cap, cap, index


_launch = None   # dfp_append_rows, resolved at the first launch


def append_rows(acc: torch.Tensor, acc_f64: torch.Tensor, acc_rows: torch.Tensor,
                words: torch.Tensor, f64: torch.Tensor, num_rows: torch.Tensor) -> torch.Tensor:
    """append_rows_plain's contract; launches K13 for CUDA tensors."""
    global _launch
    if not acc.is_cuda:
        return append_rows_plain(acc, acc_f64, acc_rows, words, f64, num_rows)
    w, f, acc_cap, cap, index = check_args(acc, acc_f64, acc_rows, words, f64, num_rows)
    if cap == 0:
        return (acc_rows + num_rows).to(torch.int32)
    if _launch is None:
        _launch = _build.function("dfp_append_rows", (
            _build.P, _build.P, _build.I64, _build.P, _build.P, _build.P, _build.I64,
            _build.I32, _build.I32, _build.P, _build.P, _build.P))
    new_rows = acc_rows.new_empty(())
    err = _launch(acc.data_ptr(), acc_f64.data_ptr(), acc_cap, acc_rows.data_ptr(),
                  words.data_ptr(), f64.data_ptr(), cap, w, f, num_rows.data_ptr(),
                  new_rows.data_ptr(), _lean.current_stream(index))
    append_rows.launches += 1
    _build.check(err, "append_rows")
    return new_rows


append_rows.launches = 0
