"""What K7 segment_agg and K8 direct_agg share: the description of the
aggregates they compute (as `csrc/agg.cuh`'s AggSpec), their accumulator
types and identities, and the plain per-group reduction.

An aggregate request is (func, values, validity): func one of "count",
"sum", "min", "max"; values a [n] tensor of int32, int64, float32, float64
or bool; validity a bool [n] tensor or None (every row valid). "count"
counts the valid rows. Sums accumulate in int64 (exact, wrapping as the
JAX package's int64 sums do) or, for float inputs, in float64; min and max
are taken in the same 64-bit type and are the identity (the type's max or
min, +-inf for floats) for a group with no valid row.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from . import _build

FUNCS = ("count", "sum", "min", "max")
MAX_AGGS = 32
_IN_TYPE = {torch.int32: 0, torch.int64: 1, torch.float32: 2, torch.float64: 3, torch.bool: 4}
_I64 = torch.iinfo(torch.int64)

Request = Tuple[str, torch.Tensor, Optional[torch.Tensor]]


class AggSpecC(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int),
                ("func", ctypes.c_int * MAX_AGGS),
                ("in_type", ctypes.c_int * MAX_AGGS),
                ("vals", ctypes.c_void_p * MAX_AGGS),
                ("valid", ctypes.c_void_p * MAX_AGGS)]


def acc_dtype(func: str, values: torch.Tensor) -> torch.dtype:
    if func != "count" and values.is_floating_point():
        return torch.float64
    return torch.int64


def identity(func: str, dtype: torch.dtype):
    if func in ("count", "sum"):
        return 0
    if dtype == torch.float64:
        return float("inf") if func == "min" else float("-inf")
    return _I64.max if func == "min" else _I64.min


def reduce_plain(func: str, values: torch.Tensor, validity: Optional[torch.Tensor],
                 seg: torch.Tensor, n_seg: int) -> torch.Tensor:
    """[n_seg] per-group results of one request; rows whose segment id
    `seg` (int64 [n]) lies outside [0, n_seg) take no part."""
    acc = acc_dtype(func, values)
    keep = (seg >= 0) & (seg < n_seg)
    if validity is not None:
        keep = keep & validity
    s = seg[keep]
    out = torch.full((n_seg,), identity(func, acc), dtype=acc, device=seg.device)
    if func == "count":
        return out.index_add_(0, s, torch.ones_like(s))
    x = values[keep].to(acc)
    if func == "sum":
        return out.index_add_(0, s, x)
    return out.scatter_reduce_(0, s, x, "amin" if func == "min" else "amax")


def request_groups(reqs: Sequence[Request]) -> List[Sequence[Request]]:
    """The requests in the runs of at most MAX_AGGS that one launch of K7
    or K8 each takes, in order (one empty run for no requests)."""
    return [reqs[i:i + MAX_AGGS] for i in range(0, max(len(reqs), 1), MAX_AGGS)]


def spec(reqs: Sequence[Request], n: int, dev: torch.device) -> AggSpecC:
    """The requests as the kernels' AggSpec, after checking each tensor."""
    if len(reqs) > MAX_AGGS:
        raise ValueError(f"{len(reqs)} aggregates; the kernels take at most {MAX_AGGS}")
    c = AggSpecC()
    c.n = len(reqs)
    for i, (func, values, validity) in enumerate(reqs):
        if func not in FUNCS:
            raise ValueError(f"aggregate function {func!r}")
        if values.dtype not in _IN_TYPE:
            raise TypeError(f"aggregate input dtype {values.dtype}")
        _build.require(values, f"aggregate {i} values", values.dtype, (n,), dev)
        c.func[i] = FUNCS.index(func)
        c.in_type[i] = _IN_TYPE[values.dtype]
        c.vals[i] = values.data_ptr()
        if validity is not None:
            _build.require(validity, f"aggregate {i} validity", torch.bool, (n,), dev)
            c.valid[i] = validity.data_ptr()
    return c


def split_results(bits: torch.Tensor, reqs: Sequence[Request]) -> List[torch.Tensor]:
    """The kernels' [A, m] int64 result words as one tensor per request, in
    its accumulator type (float64 results are stored as their bits)."""
    return [row.view(torch.float64) if acc_dtype(f, v) == torch.float64 else row
            for row, (f, v, _) in zip(bits, reqs)]
