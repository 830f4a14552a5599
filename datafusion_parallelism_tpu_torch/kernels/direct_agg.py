"""K8 direct_agg: masked per-group reductions over at most 64 groups whose
id is arithmetic on dictionary or bool codes.

Replaces the JAX package's `_direct_aggregate` (ops/aggregate.py:108: the
group id from the key codes, then one-hot [G, cap] masked reductions) and
`_global_aggregate` (:499, the G = 1 case). The CUDA kernel is
`csrc/direct_agg.cu`, whose header says what bounds it on the H100; the
plain version below is the same function in torch ops. On CPU tensors the
wrapper runs the plain version; on CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from . import _agg, _build

MAX_GROUPS = 64
MAX_KEYS = 8
Key = Tuple[torch.Tensor, torch.Tensor]   # (int32 codes or bool, validity)


class DirectKeysC(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int),
                ("dom", ctypes.c_int * MAX_KEYS),
                ("is_bool", ctypes.c_int * MAX_KEYS),
                ("vals", ctypes.c_void_p * MAX_KEYS),
                ("valid", ctypes.c_void_p * MAX_KEYS)]


def n_groups_of(doms: Sequence[int]) -> int:
    G = 1
    for d in doms:
        G *= d + 1
    return G


def direct_agg_plain(keys: Sequence[Key], doms: Sequence[int], num_rows: torch.Tensor,
                     row_filter: Optional[torch.Tensor], reqs: Sequence[_agg.Request],
                     cap: int) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(rowcount int64[G], results): G = prod(d + 1) groups over the `cap`
    rows; rowcount[g] counts the rows of group g, results holds one [G]
    tensor per aggregate request (kernels/_agg.py) in its accumulator type.
    A row takes part when it lies below num_rows (0-dim int32) and, with
    `row_filter` (bool [cap]), where that is True."""
    G = n_groups_of(doms)
    gid = _group_ids(keys, doms, num_rows, row_filter, cap)
    rowcount = torch.bincount(gid, minlength=G + 1)[:G]
    return rowcount, [_agg.reduce_plain(f, v, m, gid, G) for f, v, m in reqs]


def _group_ids(keys, doms, num_rows, row_filter, cap):
    in_row = torch.arange(cap, device=num_rows.device) < num_rows
    if row_filter is not None:
        in_row = in_row & row_filter
    gid = torch.zeros(cap, dtype=torch.int64, device=num_rows.device)
    for (v, valid), d in zip(keys, doms):
        gid = gid * (d + 1) + torch.where(valid, v.long(), d)
    return torch.where(in_row, gid, n_groups_of(doms))


def direct_agg(keys: Sequence[Key], doms: Sequence[int], num_rows: torch.Tensor,
               row_filter: Optional[torch.Tensor], reqs: Sequence[_agg.Request],
               cap: int) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """direct_agg_plain's contract; launches K8 for CUDA tensors, once per
    run of at most 32 requests (_agg.request_groups)."""
    if not num_rows.is_cuda:
        return direct_agg_plain(keys, doms, num_rows, row_filter, reqs, cap)
    dev = num_rows.device
    G = n_groups_of(doms)
    if G > MAX_GROUPS or len(keys) > MAX_KEYS or len(keys) != len(doms):
        raise ValueError(f"{len(keys)} keys over domains {list(doms)}: G = {G} > "
                         f"{MAX_GROUPS} or too many keys")
    _build.require(num_rows, "num_rows", torch.int32, (), dev)
    if row_filter is not None:
        _build.require(row_filter, "row_filter", torch.bool, (cap,), dev)
    kc = DirectKeysC()
    kc.n = len(keys)
    for i, ((v, valid), d) in enumerate(zip(keys, doms)):
        if v.dtype not in (torch.int32, torch.bool):
            raise TypeError(f"key {i}: codes must be int32 or bool, got {v.dtype}")
        _build.require(v, f"key {i}", v.dtype, (cap,), dev)
        _build.require(valid, f"key {i} validity", torch.bool, (cap,), dev)
        kc.dom[i], kc.is_bool[i] = d, int(v.dtype == torch.bool)
        kc.vals[i], kc.valid[i] = v.data_ptr(), valid.data_ptr()
    scratch_bytes = _build.function("dfp_direct_agg_scratch_bytes",
                                    (_build.I64, _build.I32, _build.I32), _build.I64)
    fn = _build.function("dfp_direct_agg", (
        ctypes.POINTER(DirectKeysC), ctypes.POINTER(_agg.AggSpecC), _build.I64, _build.P,
        _build.P, _build.P, _build.P, _build.I64, _build.P))
    rowcount, results = None, []
    for group in _agg.request_groups(reqs):
        spec = _agg.spec(group, cap, dev)
        # one row per request, then the row count (the same in every launch)
        out = torch.empty((len(group) + 1, G), dtype=torch.int64, device=dev)
        nbytes = scratch_bytes(cap, len(group) + 1, G)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        err = fn(ctypes.byref(kc), ctypes.byref(spec), cap, num_rows.data_ptr(),
                 row_filter.data_ptr() if row_filter is not None else None, out.data_ptr(),
                 scratch.data_ptr(), nbytes, _build.stream(dev))
        direct_agg.launches += 1
        _build.check(err, "direct_agg")
        rowcount = out[-1] if rowcount is None else rowcount
        results += _agg.split_results(out[:-1], group)
    return rowcount, results


direct_agg.launches = 0
