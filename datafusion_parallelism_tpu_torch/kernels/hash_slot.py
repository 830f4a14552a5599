"""K1 hash_slot: row hash over the key columns and its bucket.

Replaces the JAX package's `hashing.hash_rows` and `hash_table.slot_of`
(with the build side's null/padding mask). The CUDA kernel is
`csrc/hash_slot.cu`, whose header says what bounds it on the H100; the
plain version below is the same function in torch ops, built on
`ops/hashing.py`'s primitives. On CPU tensors the wrapper runs the plain
version; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from ..ops.hash_table import slot_of
from ..ops.hashing import (KIND_F32, KIND_I32, NULL_HASH, SEED, combine,
                           hash_words)
from . import _build

MAX_KEY_COLUMNS = 16   # a launch's columns; a wider key runs in several launches
# one key column as K1 reads it from the word matrix: (kind, its word rows
# (lo,) or (lo, hi), (validity word row, bit))
KeyCol = Tuple[int, Tuple[int, ...], Tuple[int, int]]


def _n_words(kind: int) -> int:
    return 1 if kind in (KIND_I32, KIND_F32) else 2


def _bit(words: torch.Tensor, row: int, bit: int) -> torch.Tensor:
    return ((words[row] >> bit) & 1).to(torch.bool)


def hash_slot_plain(words: torch.Tensor, cols: Sequence[KeyCol], T: Optional[int] = None,
                    num_rows: Optional[torch.Tensor] = None,
                    row_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(hash, slot): hash int32[n] with the uint32 bits of the row hash over
    the key columns `cols` of the word matrix `words` [R, n] int32 (kinds
    are ops.hashing's KIND_*); slot = the bucket of the hash in [0, T), or
    None without T. With `num_rows` (the build side) rows at or past it,
    or with a null key, go to bucket T; so do rows where the bool [n]
    `row_mask` is False (a chain-fused build side's `build_valid`)."""
    h, ok = None, None
    for kind, rows, (vrow, vbit) in cols:
        valid = _bit(words, vrow, vbit)
        hv = torch.where(valid, hash_words([words[r] for r in rows], kind), NULL_HASH)
        h = combine(SEED if h is None else h, hv)
        ok = valid if ok is None else ok & valid
    hashes = h.to(torch.int32)
    if T is None:
        return hashes, None
    slot = slot_of(hashes, T)
    if num_rows is not None:
        n = hashes.shape[0]
        ok = ok & (torch.arange(n, dtype=torch.int32, device=hashes.device) < num_rows)
        slot = torch.where(ok, slot, T).to(torch.int32)
    if row_mask is not None:
        slot = torch.where(row_mask, slot, T).to(torch.int32)
    return hashes, slot


def _spec(cols: Sequence[KeyCol], n_rows: int):
    """The columns as the kernel's HashSpec: n_cols, then kind, lo, hi, vrow
    and vbit, each MAX_KEY_COLUMNS long."""
    if not 1 <= len(cols) <= MAX_KEY_COLUMNS:
        raise ValueError(f"hash_slot takes 1-{MAX_KEY_COLUMNS} key columns, got {len(cols)}")
    for kind, rows, (vrow, vbit) in cols:
        if kind not in range(4) or len(rows) != _n_words(kind):
            raise ValueError(f"key column of kind {kind} with word rows {rows}")
        if not all(0 <= r < n_rows for r in (*rows, vrow)) or not 0 <= vbit < 32:
            raise ValueError(f"key column names word row {rows}/{vrow} bit {vbit} "
                             f"outside the {n_rows}-row matrix")

    def pad(xs):
        xs = list(xs)
        return xs + [0] * (MAX_KEY_COLUMNS - len(xs))

    fields = ([len(cols)] + pad(c[0] for c in cols) + pad(c[1][0] for c in cols)
              + pad(c[1][-1] for c in cols) + pad(c[2][0] for c in cols)
              + pad(c[2][1] for c in cols))
    return (ctypes.c_int * len(fields))(*fields)


def col_groups(cols: Sequence[KeyCol]) -> List[Sequence[KeyCol]]:
    """The key columns in the runs of at most MAX_KEY_COLUMNS that one
    launch each takes, in order."""
    return [cols[i:i + MAX_KEY_COLUMNS] for i in range(0, max(len(cols), 1), MAX_KEY_COLUMNS)]


def hash_slot(words: torch.Tensor, cols: Sequence[KeyCol], T: Optional[int] = None,
              num_rows: Optional[torch.Tensor] = None,
              row_mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """hash_slot_plain's contract; launches the CUDA kernel for CUDA
    tensors, once per run of col_groups(cols): each launch continues the
    hash (and the all-keys-valid flag) of the one before."""
    if not words.is_cuda:
        return hash_slot_plain(words, cols, T, num_rows, row_mask)
    if words.dim() != 2:
        raise ValueError(f"words: expected [R, n], got {tuple(words.shape)}")
    _build.require(words, "words", torch.int32)
    specs = [_spec(g, words.shape[0]) for g in col_groups(cols)]
    n, dev = words.shape[1], words.device
    if T is not None and not 1 <= T < 2**31 - 1:
        raise ValueError(f"table size {T} out of range")
    if num_rows is not None:
        if T is None:
            raise ValueError("num_rows masks slots: give T too")
        _build.require(num_rows, "num_rows", torch.int32, (), dev)
    if row_mask is not None:
        if T is None:
            raise ValueError("row_mask masks slots: give T too")
        _build.require(row_mask, "row_mask", torch.bool, (n,), dev)
    fn = _build.function("dfp_hash_slot", (_build.P, ctypes.POINTER(ctypes.c_int), _build.I64,
                                           _build.I64, _build.P, _build.P, _build.P, _build.P,
                                           _build.P, _build.P, _build.P, _build.P))
    # the fold carried between launches: the hash, and with num_rows the
    # flag that every key column so far is valid
    ok = (torch.empty(n, dtype=torch.uint8, device=dev)
          if len(specs) > 1 and num_rows is not None else None)
    hashes, slot = None, None
    for k, spec in enumerate(specs):
        last = k == len(specs) - 1
        h_in, hashes = hashes, torch.empty(n, dtype=torch.int32, device=dev)
        slot = torch.empty(n, dtype=torch.int32, device=dev) if last and T is not None else None
        err = fn(words.data_ptr(), spec, n, T if last and T is not None else 0,
                 num_rows.data_ptr() if last and num_rows is not None else None,
                 row_mask.data_ptr() if last and row_mask is not None else None,
                 h_in.data_ptr() if h_in is not None else None,
                 ok.data_ptr() if ok is not None and k > 0 else None,
                 hashes.data_ptr(), slot.data_ptr() if slot is not None else None,
                 ok.data_ptr() if ok is not None and not last else None, _build.stream(dev))
        hash_slot.launches += 1
        _build.check(err, "hash_slot")
    return hashes, slot


hash_slot.launches = 0
