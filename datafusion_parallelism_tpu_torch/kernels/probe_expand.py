"""K3 probe_expand: candidate ranges of the probe rows, then every
candidate pair with its key recheck.

Two entry points, each with its own launch counter: `probe_ranges` (the
CSR ranges and their scan, its first pass) and `expand_ranges` (the
candidate pairs of any strategy's ranges: K3's first pass, K14's or
K16's; its second pass).

Replaces the JAX package's `hash_table.probe_ranges` / `probe_candidates`
(CSR branch), `columnar.replicate_rows_exact` and the deferred join body's
candidate fetch and key recheck (ops/join.py:277-320). The CUDA kernel is
`csrc/probe_expand.cu`, whose header says what bounds it on the H100: the
first pass reads one offset pair a probe row and takes its scan in the
same launch (`range_tiles` blocks), the second takes a tile of 1,024
output slots a block (the rows owning each tile's first slot from a launch
before it, each slot's row by marks and a max-scan over the tile's bases
in shared memory) and reads each candidate's build row in one load where
the rows are row-major; the plain
versions below are the same functions in torch ops. On CPU tensors the
wrappers run the plain versions; on CUDA tensors they launch the kernel or
raise.

The build rows `bwords` [R+1, n] (word k of table position r at
bwords[k, r], the row id last) are word-major (contiguous), or the view
of a row-major [n, 4 or 8] buffer that K2 writes for the deferred join
(kernels/csr_build.py `row_major`): strides (1, 4 or 8), 16-byte aligned.

Candidate totals are summed in int64: a total of 2^31 or more raises
OverflowError, where the JAX package's int32 cumsum would wrap.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from . import _build

MAX_EQ_WORDS, MAX_KEYS = 8, 4
RANGE_TILE = 256 * 16   # probe rows a first-pass block takes (csrc/probe_expand.cu)
ROW_MAJOR_WORDS = (4, 8)   # the padded widths of row-major build rows
Ranges = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
# one key column of the recheck plan (ops/join.py `_defer_key_plan`):
# (build word rows, probe word rows, (build validity row, bit) or None,
#  (probe validity row, bit)); None: no build-side test, where the table
#  holds only rows with valid keys
Compare = Tuple[List[int], List[int], Optional[Tuple[int, int]], Tuple[int, int]]


def check_total(total: torch.Tensor) -> torch.Tensor:
    """The int64 candidate total as int32; raises OverflowError at 2^31
    (one synchronisation)."""
    if int(total) >= 2**31:
        raise OverflowError(f"join candidate total {int(total)} reaches 2^31")
    return total.to(torch.int32)


def probe_ranges_plain(slot: torch.Tensor, ok: torch.Tensor, offsets: torch.Tensor) -> Ranges:
    """(start, count, base, total) per probe row: its bucket's start
    offsets[slot] and count offsets[slot + 1] - offsets[slot] (the table's
    offsets [T+2]), count zeroed where `ok` is False, base the exclusive
    cumsum of count, total their int32 0-dim sum."""
    sl = slot.long()
    start = offsets.index_select(0, sl)
    count = torch.where(ok, offsets.index_select(0, sl + 1) - start, 0).to(torch.int32)
    cum = torch.cumsum(count, 0, dtype=torch.int64)
    total = check_total(cum[-1])
    return start, count, (cum - count).to(torch.int32), total


def range_tiles(m: int) -> int:
    """Blocks of K3's first pass: tiles of RANGE_TILE probe rows, each
    taking its offset by look-back."""
    return -(-m // RANGE_TILE)


def probe_ranges(slot: torch.Tensor, ok: torch.Tensor, offsets: torch.Tensor) -> Ranges:
    """probe_ranges_plain's contract; launches K3's first pass (its scan
    fused) for CUDA tensors."""
    if not slot.is_cuda:
        return probe_ranges_plain(slot, ok, offsets)
    return _ranges_launch(slot, ok, offsets)


def _ranges_launch(slot: torch.Tensor, ok: torch.Tensor, offsets: torch.Tensor) -> Ranges:
    dev = slot.device
    m = slot.shape[0] if slot.dim() == 1 else -1
    if offsets.dim() != 1 or offsets.shape[0] < 3:
        raise ValueError(f"offsets: expected [T+2], got {tuple(offsets.shape)}")
    if m < 1:
        raise ValueError("probe side has no rows")
    _build.require(slot, "slot", torch.int32, (m,))
    _build.require(ok, "ok", torch.bool, (m,), dev)
    _build.require(offsets, "offsets", torch.int32, None, dev)
    fn = _build.function("dfp_probe_ranges", (
        _build.P, _build.P, _build.I64, _build.P, _build.P, _build.P, _build.P, _build.P,
        _build.P, _build.I64, _build.P))
    start = torch.empty(m, dtype=torch.int32, device=dev)
    count = torch.empty(m, dtype=torch.int32, device=dev)
    base = torch.empty(m, dtype=torch.int32, device=dev)
    total64 = torch.empty((), dtype=torch.int64, device=dev)
    nbytes = 8 * (range_tiles(m) + 1)   # look-back status words and the tile counter
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    err = fn(slot.data_ptr(), ok.data_ptr(), m, offsets.data_ptr(), start.data_ptr(),
             count.data_ptr(), base.data_ptr(), total64.data_ptr(), scratch.data_ptr(), nbytes,
             _build.stream(dev))
    probe_ranges.launches += 1
    _build.check(err, "probe_ranges")
    return start, count, base, check_total(total64)


def _recheck(bn: torch.Tensor, pn: torch.Tensor, compares: Sequence[Compare]) -> torch.Tensor:
    """Bitwise key-word equality and the plan's validity bits, per
    candidate."""
    eq = torch.ones(bn.shape[1], dtype=torch.bool, device=bn.device)
    for bw, pw, bvalid, (pvr, pbit) in compares:
        for wb, wp in zip(bw, pw):
            eq &= bn[wb] == pn[wp]
        if bvalid is not None:
            eq &= ((bn[bvalid[0]] >> bvalid[1]) & 1).to(torch.bool)
        eq &= ((pn[pvr] >> pbit) & 1).to(torch.bool)
    return eq


def expand_ranges_plain(start, count, base, total, pwords, bwords, compares, out_cap):
    """K3's second pass, from candidate ranges of any strategy (`Ranges`:
    K3's first pass, K14 or K16): (match, probe_idx, build_id) over the
    out_cap output slots.

    Probe row i owns slots [base[i], base[i]+count[i]); slot j's candidate
    is table position pos = start[i] + j - base[i]. `pwords` [*, m] are the
    probe's narrow word rows, `bwords` [*, cap] the build's in table order
    with the build row id last, in either layout (`build_strides`). match
    = keys equal and valid on each side the plan names (a key without a
    build validity row tests the probe's alone); past min(total, out_cap)
    match is False and probe_idx = build_id = 0."""
    m, dev = start.shape[0], start.device
    j = torch.arange(out_cap, dtype=torch.int64, device=dev)
    # replicate_rows_exact: each non-empty segment's first slot gets its
    # row id (bases of non-empty rows are distinct), a cummax fills it on
    dest = torch.where(count > 0, base.long(), out_cap).clamp(max=out_cap)
    seg = torch.zeros(out_cap + 1, dtype=torch.int64, device=dev).scatter_reduce_(
        0, dest, torch.arange(m, dtype=torch.int64, device=dev), "amax")[:out_cap]
    cand = j < total
    i = torch.where(cand, torch.cummax(seg, 0).values, 0)
    pos = torch.where(cand, start.long()[i] + j - base.long()[i], 0)
    bn = bwords.index_select(1, pos)
    match = cand & _recheck(bn, pwords.index_select(1, i), compares)
    build_id = torch.where(cand, bn[-1], 0)
    return match, i.to(torch.int32), build_id


def key_groups(compares: Sequence[Compare]) -> List[Sequence[Compare]]:
    """The recheck plan in the runs, in order, that one launch of the
    second pass each takes: at most MAX_KEYS keys of MAX_EQ_WORDS words."""
    groups, cur, words = [], [], 0
    for c in compares:
        if cur and (len(cur) == MAX_KEYS or words + len(c[0]) > MAX_EQ_WORDS):
            groups.append(cur)
            cur, words = [], 0
        cur.append(c)
        words += len(c[0])
    return groups + [cur]


def _spec(compares: Sequence[Compare]):
    """The recheck plan as the kernel's KeySpec: n_eq, eq_b[8], eq_p[8],
    n_keys, vb_row[4] (-1: none), vb_bit[4], vp_row[4], vp_bit[4]."""
    eq_b = [w for bw, _, _, _ in compares for w in bw]
    eq_p = [w for _, pw, _, _ in compares for w in pw]
    if len(eq_b) > MAX_EQ_WORDS or len(compares) > MAX_KEYS:
        raise ValueError(f"expand_ranges takes at most {MAX_KEYS} keys of "
                         f"{MAX_EQ_WORDS} words in all")

    def pad(xs, k):
        return list(xs) + [0] * (k - len(xs))

    fields = ([len(eq_b)] + pad(eq_b, MAX_EQ_WORDS) + pad(eq_p, MAX_EQ_WORDS)
              + [len(compares)]
              + pad([-1 if c[2] is None else c[2][0] for c in compares], MAX_KEYS)
              + pad([0 if c[2] is None else c[2][1] for c in compares], MAX_KEYS)
              + pad([c[3][0] for c in compares], MAX_KEYS)
              + pad([c[3][1] for c in compares], MAX_KEYS))
    return (ctypes.c_int * len(fields))(*fields)


def build_strides(bwords: torch.Tensor) -> Tuple[int, int]:
    """(word stride, row stride) of the build rows: word-major (contiguous)
    or row-major (strides (1, 4 or 8), 16-byte aligned, the words within
    the padded row); raises on any other layout."""
    if bwords.is_contiguous():
        return bwords.stride()
    wstride, rstride = bwords.stride()
    if (wstride != 1 or rstride not in ROW_MAJOR_WORDS or bwords.shape[0] > rstride
            or bwords.data_ptr() % 16):
        raise ValueError(f"bwords: strides {bwords.stride()} are neither word-major nor "
                         f"row-major rows of {ROW_MAJOR_WORDS} words, 16-byte aligned")
    return wstride, rstride


def _check_expand(start, pwords, bwords, compares, out_cap):
    dev, m = start.device, start.shape[0]
    if pwords.dim() != 2 or bwords.dim() != 2:
        raise ValueError("pwords and bwords are [rows, n] word matrices")
    _build.require(pwords, "pwords", torch.int32, (pwords.shape[0], m), dev)
    _build.require(bwords, "bwords", torch.int32, None, dev, contiguous=False)
    build_strides(bwords)
    for bw, pw, bvalid, (pvr, _) in compares:
        brows = bw + ([] if bvalid is None else [bvalid[0]])
        if max(brows) >= bwords.shape[0] - 1 or max(pw + [pvr]) >= pwords.shape[0]:
            raise ValueError("recheck plan names a word row the matrices lack")
    if out_cap < 1:
        raise ValueError(f"out_cap {out_cap} < 1")
    return [_spec(g) for g in key_groups(compares)]


def expand_ranges(start, count, base, total, pwords, bwords, compares, out_cap):
    """expand_ranges_plain's contract; launches K3's second pass for CUDA
    tensors (the SORT and OA strategies' ranges come from K14 / K16), once
    per run of key_groups(compares), the later runs ANDing into match."""
    if not start.is_cuda:
        return expand_ranges_plain(start, count, base, total, pwords, bwords, compares,
                                   out_cap)
    m = start.shape[0] if start.dim() == 1 else -1
    _build.require(start, "start", torch.int32, (m,))
    _build.require(base, "base", torch.int32, (m,), start.device)
    if m < 1:
        raise ValueError("probe side has no rows")
    specs = _check_expand(start, pwords, bwords, compares, out_cap)
    dev = start.device
    scratch_bytes = _build.function("dfp_probe_expand_scratch_bytes", (_build.I64,),
                                    _build.I64)
    fn = _build.function("dfp_probe_expand", (
        _build.P, _build.P, _build.P, _build.I64, _build.P, _build.I64, _build.P,
        _build.I64, _build.I64, _build.I32, ctypes.POINTER(ctypes.c_int),
        _build.I64, _build.I32, _build.P, _build.P, _build.P, _build.P, _build.I64, _build.P))
    wstride, rstride = build_strides(bwords)
    nbytes = scratch_bytes(out_cap)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    total64 = total.to(torch.int64)
    match = torch.empty(out_cap, dtype=torch.bool, device=dev)
    probe_idx = torch.empty(out_cap, dtype=torch.int32, device=dev)
    build_id = torch.empty(out_cap, dtype=torch.int32, device=dev)
    for k, spec in enumerate(specs):
        err = fn(start.data_ptr(), base.data_ptr(), total64.data_ptr(), m, pwords.data_ptr(),
                 m, bwords.data_ptr(), wstride, rstride, bwords.shape[0], spec, out_cap,
                 int(k > 0), match.data_ptr(), probe_idx.data_ptr(), build_id.data_ptr(),
                 scratch.data_ptr(), nbytes, _build.stream(dev))
        expand_ranges.launches += 1
        _build.check(err, "expand_ranges")
    return match, probe_idx, build_id


expand_ranges.launches = 0
probe_ranges.launches = 0
