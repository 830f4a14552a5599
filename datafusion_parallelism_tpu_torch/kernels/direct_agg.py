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
WARPS = 8      # csrc/direct_agg.cu's warps a block
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


# the bytes a row of a column of each input dtype takes in a staged tile
_ESZ = {torch.int32: 4, torch.int64: 8, torch.float32: 4, torch.float64: 8, torch.bool: 1}


def stream_bytes(keys: Sequence[Key], reqs: Sequence[_agg.Request],
                 row_filter: Optional[torch.Tensor]) -> int:
    """The bytes a row of K8's staged tile takes: each distinct input column
    (by storage address and width) once, as csrc/direct_agg.cu `streams_of`
    lists them: the filter, each key's validity and codes, each request's
    validity and values (a count reads no values)."""
    cols = set()
    if row_filter is not None:
        cols.add((row_filter.data_ptr(), 1))
    for v, valid in keys:
        cols |= {(valid.data_ptr(), 1), (v.data_ptr(), _ESZ[v.dtype])}
    for func, values, validity in reqs:
        if validity is not None:
            cols.add((validity.data_ptr(), 1))
        if func != "count":
            cols.add((values.data_ptr(), _ESZ[values.dtype]))
    return sum(esz for _, esz in cols)


# csrc/direct_agg.cu's request kinds: op * 6 + input type, a count 5
_OPS = {("sum", False): 0, ("sum", True): 1, ("min", False): 2, ("max", False): 3,
        ("min", True): 4, ("max", True): 5}
_TYPE = {torch.int32: 0, torch.int64: 1, torch.float32: 2, torch.float64: 3, torch.bool: 4}


def request_kind(func: str, values: torch.Tensor) -> int:
    """The kind csrc/direct_agg.cu specialises a request's walk for: its
    accumulator operation times 6 plus its input type (5: a count, which
    reads no values). The row count is ("count", ...)."""
    if func == "count":
        return 5
    return _OPS[(func, values.is_floating_point())] * 6 + _TYPE[values.dtype]


def warp_sets(kinds: Sequence[int]) -> Tuple[List[int], List[int]]:
    """(order, start): the requests of these kinds (the row count last)
    sorted by kind, stably, and the WARPS + 1 bounds of each warp's run of
    them, as csrc/direct_agg.cu `sets_of` cuts them: each kind's requests
    into pieces of at most q, q the least that gives at most WARPS pieces,
    sizes within one of each other; past WARPS kinds, WARPS pieces of the
    sorted order, kinds mixed."""
    R = len(kinds)
    order = sorted(range(R), key=lambda r: kinds[r])
    runs, i = [], 0
    while i < R:
        j = i
        while j < R and kinds[order[j]] == kinds[order[i]]:
            j += 1
        runs.append(j - i)
        i = j
    for q in range(-(-R // WARPS), R + 1):
        if sum(-(-m // q) for m in runs) <= WARPS:
            start = [0]
            for m in runs:
                n = -(-m // q)
                for c in range(n):
                    start.append(start[-1] + m // n + (c < m % n))
            return order, start + [R] * (WARPS + 1 - len(start))
    q = -(-R // WARPS)
    return order, [min(w * q, R) for w in range(WARPS + 1)]


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
    kc = _keys_c(keys, doms, num_rows, row_filter, cap)
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
        if nbytes < 0:
            raise RuntimeError(f"direct_agg: {len(group) + 1} requests, {G} groups")
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


def launch_plans(keys: Sequence[Key], doms: Sequence[int], num_rows: torch.Tensor,
                 row_filter: Optional[torch.Tensor], reqs: Sequence[_agg.Request],
                 cap: int) -> List[Tuple[int, ...]]:
    """The plan of each launch direct_agg makes for these CUDA arguments,
    read from csrc/direct_agg.cu without launching: T, the shared bytes, the
    blocks, the blocks an SM holds, then the warps' sets as warp_sets gives
    them (start[0..WARPS], order[0..R))."""
    dev = num_rows.device
    kc = _keys_c(keys, doms, num_rows, row_filter, cap)
    fn = _build.function("dfp_direct_agg_plan", (
        ctypes.POINTER(DirectKeysC), ctypes.POINTER(_agg.AggSpecC), _build.I64, _build.P,
        _build.P))
    plans = []
    for group in _agg.request_groups(reqs):
        spec = _agg.spec(group, cap, dev)
        plan = (ctypes.c_longlong * (4 + WARPS + 1 + len(group) + 1))()
        _build.check(fn(ctypes.byref(kc), ctypes.byref(spec), cap,
                        row_filter.data_ptr() if row_filter is not None else None,
                        ctypes.cast(plan, ctypes.c_void_p)), "direct_agg_plan")
        plans.append(tuple(plan))
    return plans


def _keys_c(keys, doms, num_rows, row_filter, cap) -> DirectKeysC:
    """The keys as csrc/direct_agg.cu takes them, after the wrapper's checks
    of every argument but the requests (_agg.spec checks those)."""
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
    return kc
