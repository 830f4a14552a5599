"""K9 pair_fetch: every candidate pair's whole build and probe rows, and
the key recheck by value.

Replaces the JAX package's full-fetch join body (ops/join.py:322-357):
`replicate_rows_exact` over whole probe rows, `bperm.take_rows(pos)`,
`unpack_table` and the value recheck under `jnp.promote_types`. The join
takes this path where its consumers read whole candidate rows (a residual
filter, a late-materialized INNER join) or where bit equality of packed
words is not value equality (float keys, keys of different widths). The
CUDA kernel is `csrc/pair_fetch.cu`, whose header says what bounds it on the
H100; the plain version below is the same function in torch ops. On CPU
tensors the wrapper runs the plain version; on CUDA tensors it launches the
kernel or raises.

Inputs are K3's candidate ranges (`start`, `base`, `total`), the probe's
packed words [Wp, m] and float64 sidecars [Fp, m], and the build side in
perm order as K2 leaves it: one int32 matrix [Wb + 2 Fb + 1, cap] of the
packed words, each float64 sidecar as a (lo, hi) word pair, and the build
row id last.

A key of the recheck is (build kind, build row, probe kind, probe row,
(build validity row, bit), (probe validity row, bit)), kinds:

  KEY_I32  one int32 word (int32, date32, string codes, bool)
  KEY_I64  two words, lo at `row`, hi at `row + 1` (int64, decimal)
  KEY_F32  one float32 word
  KEY_F64  a float64: on the build side the word pair at `row`, `row + 1`;
           on the probe side the float64 sidecar `row`

Two keys compare in the type JAX promotes them to: float64 if either is
float64, else float32 if either is float32, else int64. So -0.0 == 0.0,
NaN matches nothing, and an int32 key meets an int64 one by value.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from . import _build

KEY_I32, KEY_I64, KEY_F32, KEY_F64 = 0, 1, 2, 3
MAX_KEYS = 4
# (build kind, build row, probe kind, probe row, (bvrow, bvbit), (pvrow, pvbit))
FetchKey = Tuple[int, int, int, int, Tuple[int, int], Tuple[int, int]]
Fetched = Tuple[torch.Tensor, ...]
_M32 = 0xFFFFFFFF


def _pair_f64(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return ((hi.long() << 32) | (lo.long() & _M32)).view(torch.float64)


def _key_value(words: torch.Tensor, f64: torch.Tensor, kind: int, row: int, build: bool):
    if kind == KEY_I32:
        return words[row]
    if kind == KEY_I64:
        return (words[row + 1].long() << 32) | (words[row].long() & _M32)
    if kind == KEY_F32:
        return words[row].contiguous().view(torch.float32)
    return _pair_f64(words[row], words[row + 1]) if build else f64[row]


def recheck_plain(bwords, pwords, pf64, keys: Sequence[FetchKey]) -> torch.Tensor:
    """bool [n]: every key equal by value (in the promoted type) and valid
    on both sides, over gathered build words `bwords` (float64 keys as word
    pairs) and probe words `pwords` / sidecars `pf64`."""
    eq = torch.ones(bwords.shape[1], dtype=torch.bool, device=bwords.device)
    for bk, br, pk, pr, (bvr, bvb), (pvr, pvb) in keys:
        b = _key_value(bwords, None, bk, br, True)
        p = _key_value(pwords, pf64, pk, pr, False)
        if b.dtype != p.dtype:
            wide = torch.promote_types(b.dtype, p.dtype)
            b, p = b.to(wide), p.to(wide)
        eq &= (b == p) & ((bwords[bvr] >> bvb) & 1).to(torch.bool) \
            & ((pwords[pvr] >> pvb) & 1).to(torch.bool)
    return eq


def pair_fetch_plain(start: torch.Tensor, base: torch.Tensor, total: torch.Tensor,
                     pwords: torch.Tensor, pf64: torch.Tensor, bwords: torch.Tensor,
                     n_bf64: int, keys: Sequence[FetchKey], out_cap: int) -> Fetched:
    """(out_b [Wb, out_cap], out_bf [Fb, out_cap], out_p [Wp, out_cap],
    out_pf [Fp, out_cap], probe_idx, build_id, match) over the output slots
    j < out_cap: slot j's probe row i is the last row with base[i] <= j,
    its build row the one at perm position start[i] + j - base[i]. Slots at
    or past min(total, out_cap) are zeros with match False."""
    dev = base.device
    j = torch.arange(out_cap, dtype=torch.int64, device=dev)
    cand = j < total
    i = torch.searchsorted(base.long(), j, right=True) - 1
    i = torch.where(cand, i, 0)
    pos = torch.where(cand, start.long()[i] + j - base.long()[i], 0)
    wb = bwords.shape[0] - 1 - 2 * n_bf64
    bw = torch.where(cand, bwords.index_select(1, pos), 0)
    pw = torch.where(cand, pwords.index_select(1, i), 0)
    pf = torch.where(cand, pf64.index_select(1, i), 0.0)
    bf = torch.stack([_pair_f64(bw[wb + 2 * f], bw[wb + 2 * f + 1]) for f in range(n_bf64)]) \
        if n_bf64 else torch.empty((0, out_cap), dtype=torch.float64, device=dev)
    match = cand & recheck_plain(bw, pw, pf, keys)
    return bw[:wb], bf, pw, pf, i.to(torch.int32), bw[-1], match


def key_groups(keys: Sequence[FetchKey]) -> List[Sequence[FetchKey]]:
    """The keys in the runs of at most MAX_KEYS that one launch each takes,
    in order."""
    return [keys[i:i + MAX_KEYS] for i in range(0, max(len(keys), 1), MAX_KEYS)]


def _spec(keys: Sequence[FetchKey], rows_b: int, rows_p: int, n_pf64: int):
    """The keys as the kernel's FetchSpec: n, then per key bkind, brow,
    pkind, prow, bvrow, bvbit, pvrow, pvbit (MAX_KEYS each)."""
    if not 1 <= len(keys) <= MAX_KEYS:
        raise ValueError(f"pair_fetch takes 1-{MAX_KEYS} keys, got {len(keys)}")
    for bk, br, pk, pr, (bvr, bvb), (pvr, pvb) in keys:
        if bk not in range(4) or pk not in range(4):
            raise ValueError(f"key kinds {bk}, {pk}")
        wide_b = 2 if bk in (KEY_I64, KEY_F64) else 1
        wide_p = 2 if pk == KEY_I64 else 1
        p_rows = n_pf64 if pk == KEY_F64 else rows_p
        if not (0 <= br and br + wide_b <= rows_b and 0 <= pr and pr + wide_p <= p_rows
                and 0 <= bvr < rows_b and 0 <= pvr < rows_p and 0 <= bvb < 32
                and 0 <= pvb < 32):
            raise ValueError(f"key names a word row outside the matrices: {keys}")
    cols = list(zip(*[(bk, br, pk, pr, bv[0], bv[1], pv[0], pv[1])
                      for bk, br, pk, pr, bv, pv in keys]))
    fields = [len(keys)]
    for c in cols:
        fields += list(c) + [0] * (MAX_KEYS - len(keys))
    return (ctypes.c_int * len(fields))(*fields)


def pair_fetch(start, base, total, pwords, pf64, bwords, n_bf64: int,
               keys: Sequence[FetchKey], out_cap: int) -> Fetched:
    """pair_fetch_plain's contract; launches K9 for CUDA tensors, once per
    run of key_groups(keys): the first fetches the rows, the later ones AND
    their recheck into match."""
    if not base.is_cuda:
        return pair_fetch_plain(start, base, total, pwords, pf64, bwords, n_bf64, keys,
                                out_cap)
    dev = base.device
    m = base.shape[0] if base.dim() == 1 else -1
    _build.require(base, "base", torch.int32, (m,))
    _build.require(start, "start", torch.int32, (m,), dev)
    if pwords.dim() != 2 or pf64.dim() != 2 or bwords.dim() != 2:
        raise ValueError("pwords [Wp, m], pf64 [Fp, m] and bwords [R, cap] expected")
    _build.require(pwords, "pwords", torch.int32, (pwords.shape[0], m), dev)
    _build.require(pf64, "pf64", torch.float64, (pf64.shape[0], m), dev)
    _build.require(bwords, "bwords", torch.int32, None, dev)
    wb = bwords.shape[0] - 1 - 2 * n_bf64
    if wb < 0 or m < 1 or not 0 <= out_cap < 2**31:
        raise ValueError(f"pair_fetch: {bwords.shape[0]} build rows for {n_bf64} float64 "
                         f"pairs, {m} probe rows, out_cap {out_cap}")
    specs = [_spec(g, bwords.shape[0] - 1, pwords.shape[0], pf64.shape[0])
             for g in key_groups(keys)]
    total64 = total.to(torch.int64)
    _build.require(total64, "total", torch.int64, (), dev)
    out_b = torch.empty((wb, out_cap), dtype=torch.int32, device=dev)
    out_bf = torch.empty((n_bf64, out_cap), dtype=torch.float64, device=dev)
    out_p = torch.empty((pwords.shape[0], out_cap), dtype=torch.int32, device=dev)
    out_pf = torch.empty((pf64.shape[0], out_cap), dtype=torch.float64, device=dev)
    probe_idx = torch.empty(out_cap, dtype=torch.int32, device=dev)
    build_id = torch.empty(out_cap, dtype=torch.int32, device=dev)
    match = torch.empty(out_cap, dtype=torch.bool, device=dev)
    fn = _build.function("dfp_pair_fetch", (
        _build.P, _build.P, _build.P, _build.I64, _build.P, _build.I32, _build.P, _build.I32,
        _build.P, _build.I32, _build.I32, _build.I64, ctypes.POINTER(ctypes.c_int), _build.I64,
        _build.I32, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P,
        _build.P))
    for k, spec in enumerate(specs):
        err = fn(start.data_ptr(), base.data_ptr(), total64.data_ptr(), m, pwords.data_ptr(),
                 pwords.shape[0], pf64.data_ptr(), pf64.shape[0], bwords.data_ptr(), wb,
                 n_bf64, bwords.shape[1], spec, out_cap, int(k > 0), out_b.data_ptr(),
                 out_bf.data_ptr(), out_p.data_ptr(), out_pf.data_ptr(), probe_idx.data_ptr(),
                 build_id.data_ptr(), match.data_ptr(), _build.stream(dev))
        pair_fetch.launches += 1
        _build.check(err, "pair_fetch")
    return out_b, out_bf, out_p, out_pf, probe_idx, build_id, match


pair_fetch.launches = 0
