"""K5 filter_compact: stable stream compaction of packed rows, and the plain
row gather.

Replaces the JAX package's `columnar.compaction_indices`, `compact_rows`,
`filter_rows`, `take_rows_fused`, `PackedTable.take_rows` and
`gather_table` (utils/columnar.py:406-640). The CUDA kernel is
`csrc/filter_compact.cu`, whose header says what bounds it on the H100; the
plain versions below are the same functions in torch ops. On CPU tensors the
wrappers run the plain versions; on CUDA tensors they launch the kernel or
raise.

Two entry points, each with its own launch counter:

  filter_compact(mask, words, f64, out_cap)  one pass over tiles of
      COMPACT_TILE rows (a decoupled look-back gives each its base), each
      survivor written at its rank; rows at or past the survivor count are
      zeros
  gather_rows(words, f64, idx, n=None)       row j = source row idx[j]
      (clipped into range, as JAX's mode="clip"); with n, rows at or past
      n are zeros and read nothing; its thread layout (`gather_layout`)
      follows the source's size against the device's L2

Both move the float64 sidecars bit for bit (selections and copies, never
arithmetic), NaN payloads and denormals included: the SORT build
(ops/hash_table.py `sort_table_rows`) carries int64 keys through them as
float64 bits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

Rows = Tuple[torch.Tensor, torch.Tensor]

# csrc/filter_compact.cu's gather layouts: one thread per output row and
# word, or per four output rows and a word
GATHER_WORD, GATHER_WORD4 = 0, 1
# rows a block of csrc/filter_compact.cu's compaction takes (FC_TILE)
COMPACT_TILE = 4096


def compact_tiles(cap: int) -> int:
    """The tiles of COMPACT_TILE rows K5's compaction takes, a block each."""
    return -(-cap // COMPACT_TILE)


def compact_scratch_bytes(cap: int) -> int:
    """K5's compaction scratch: a look-back status word a tile and the
    tile counter (scan.cuh `lookback_scratch_bytes`), zeroed by one memset."""
    return (compact_tiles(cap) + 1) * 8


def gather_layout(cap: int, F: int, l2_bytes: int) -> int:
    """The gather's thread layout for a source of `cap` rows (F float64
    sidecars): GATHER_WORD while one word row of the source (a sidecar row
    where there is one) fits in the L2, where that layout's random reads
    hit; GATHER_WORD4 past it."""
    return GATHER_WORD if cap * (8 if F else 4) <= l2_bytes else GATHER_WORD4


def gather_bytes(W: int, F: int, cap: int, m: int, n: Optional[int] = None) -> int:
    """The bytes a gather of m rows of W words and F sidecars from `cap`
    source rows must move: idx and a source row read for each row below
    min(n, m) (no more source bytes than there are), and m rows written."""
    k = m if n is None else max(0, min(int(n), m))
    row = 4 * W + 8 * F
    return 4 * k + min(cap * row, k * row) + m * row


def gather_rows_plain(words: torch.Tensor, f64: torch.Tensor, idx: torch.Tensor,
                      n: Optional[torch.Tensor] = None) -> Rows:
    """(out_words [W, m], out_f64 [F, m]): column j of the int32 word matrix
    `words` [W, cap] and of the float64 sidecars `f64` [F, cap] at row
    idx[j] (clipped to [0, cap)); with `n` (a 0-dim count), columns at or
    past n are zeros."""
    i = idx.long().clamp(0, max(words.shape[1] - 1, 0))
    out, out_f64 = words.index_select(1, i), f64.index_select(1, i)
    if n is not None:
        ok = torch.arange(idx.shape[0], device=idx.device) < n
        out, out_f64 = torch.where(ok, out, 0), torch.where(ok, out_f64, 0.0)
    return out, out_f64


def filter_compact_plain(mask: torch.Tensor, words: torch.Tensor, f64: torch.Tensor,
                         out_cap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out_words [W, out_cap], out_f64 [F, out_cap], n): the rows where
    `mask` [cap] is True, in their order, at the front; n (int64 0-dim) is
    the true survivor count, which may exceed out_cap (the rest drop).
    Rows at or past n are zeros."""
    cap = mask.shape[0]
    idx = torch.argsort((~mask).to(torch.int32), stable=True)
    idx = idx[:out_cap] if out_cap <= cap else torch.cat([idx, idx.new_zeros(out_cap - cap)])
    n = mask.sum(dtype=torch.int64)
    return (*gather_rows_plain(words, f64, idx, n), n)


def _check_rows(words, f64, dev):
    if words.dim() != 2 or f64.dim() != 2 or f64.shape[1] != words.shape[1]:
        raise ValueError("words [W, cap] int32 and float64 [F, cap] expected")
    _build.require(words, "words", torch.int32, None, dev)
    _build.require(f64, "float64", torch.float64, None, dev)


def filter_compact(mask: torch.Tensor, words: torch.Tensor, f64: torch.Tensor,
                   out_cap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """filter_compact_plain's contract; launches K5 for CUDA tensors."""
    if not mask.is_cuda:
        return filter_compact_plain(mask, words, f64, out_cap)
    dev = mask.device
    cap = mask.shape[0] if mask.dim() == 1 else -1
    _build.require(mask, "mask", torch.bool, (cap,))
    _check_rows(words, f64, dev)
    if words.shape[1] != cap:
        raise ValueError(f"mask has {cap} rows, words {words.shape[1]}")
    if not 0 <= out_cap < 2**31:
        raise ValueError(f"out_cap {out_cap} out of range")
    scratch_bytes = _build.function("dfp_filter_compact_scratch_bytes",
                                    (_build.I64, _build.I64), _build.I64)
    fn = _build.function("dfp_filter_compact", (
        _build.P, _build.I64, _build.P, _build.I32, _build.P, _build.I32, _build.I64,
        _build.P, _build.P, _build.P, _build.P, _build.I64, _build.P))
    out = torch.empty((words.shape[0], out_cap), dtype=torch.int32, device=dev)
    out_f64 = torch.empty((f64.shape[0], out_cap), dtype=torch.float64, device=dev)
    n = torch.empty((), dtype=torch.int64, device=dev)
    nbytes = scratch_bytes(cap, out_cap)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    err = fn(mask.data_ptr(), cap, words.data_ptr(), words.shape[0], f64.data_ptr(),
             f64.shape[0], out_cap, out.data_ptr(), out_f64.data_ptr(), n.data_ptr(),
             scratch.data_ptr(), nbytes, _build.stream(dev))
    filter_compact.launches += 1
    _build.check(err, "filter_compact")
    return out, out_f64, n


def gather_rows(words: torch.Tensor, f64: torch.Tensor, idx: torch.Tensor,
                n: Optional[torch.Tensor] = None) -> Rows:
    """gather_rows_plain's contract; launches K5's gather for CUDA tensors,
    in the layout `gather_layout` picks from the source's size and the
    device's L2."""
    if not words.is_cuda:
        return gather_rows_plain(words, f64, idx, n)
    dev = words.device
    _check_rows(words, f64, dev)
    m = idx.shape[0] if idx.dim() == 1 else -1
    _build.require(idx, "idx", torch.int32, (m,), dev)
    if n is not None:
        if n.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"n: dtype {n.dtype}, expected an integer count")
        n = n.to(torch.int64)
        _build.require(n, "n", torch.int64, (), dev)
    layout = gather_layout(words.shape[1], f64.shape[0], _build.device_limits(dev).l2_bytes)
    return _gather(words, f64, idx, n, layout)


def _gather(words, f64, idx, n, layout: int) -> Rows:
    """One launch of K5's gather in `layout` (gather_rows', or the other
    where a measurement compares them), on checked arguments."""
    dev, m = words.device, idx.shape[0]
    fn = _build.function("dfp_row_gather", (
        _build.P, _build.I32, _build.P, _build.I32, _build.I64, _build.P, _build.I64,
        _build.P, _build.P, _build.P, _build.I32, _build.P))
    out = torch.empty((words.shape[0], m), dtype=torch.int32, device=dev)
    out_f64 = torch.empty((f64.shape[0], m), dtype=torch.float64, device=dev)
    err = fn(words.data_ptr(), words.shape[0], f64.data_ptr(), f64.shape[0], words.shape[1],
             idx.data_ptr(), m, n.data_ptr() if n is not None else None,
             out.data_ptr(), out_f64.data_ptr(), layout, _build.stream(dev))
    gather_rows.launches += 1
    _build.check(err, "gather_rows")
    return out, out_f64


filter_compact.launches = 0
gather_rows.launches = 0
