"""K2 csr_build: the CSR hash table of the build side, and its narrow rows
in bucket order.

Replaces the JAX package's `hash_table.build_csr` and the deferred join's
narrow permute (ops/join.py:301-306). The CUDA kernel is `csrc/csr_build.cu`
over K6's one-sweep pass (`csrc/onesweep.cuh`), whose headers say what
bounds it on the H100; the plain version below is the same function in
torch ops. On CPU tensors the wrapper runs the plain version; on CUDA
tensors it launches the kernel or raises.

The kernel puts bucket T's rows (null keys, padding) at the end of the
perm in row order, sorts the other rows' bucket ids stably by
`digit_passes(T)` digit passes, gathers the narrow rows through the perm
and writes the T side (offsets, starts, counts) by a fill: a block a
tile of FILL_TILE buckets (`fill_tiles`), from the sorted keys.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

Tensors5 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

DIGIT_BITS = 8
FILL_TILE = 4096                 # buckets a fill block writes (csrc/csr_build.cu)
FILL_SCAN_KEYS = 4 * FILL_TILE   # past this many keys a fill tile searches


def csr_build_plain(slot: torch.Tensor, T: int, rows: torch.Tensor) -> Tensors5:
    """(counts, offsets, perm, start_count, rows_out) of `slot` int32[n], the
    bucket of each row in [0, T] (T = null key or padding):

    counts[T+1] rows per bucket, offsets[T+2] their exclusive cumsum with
    the total last, perm[n] the stable argsort of slot, start_count[2, T+1]
    = [offsets[:-1]; counts], and rows_out[R+1, n] = the narrow word rows
    `rows` [R, n] plus the row id, permuted into perm order."""
    n = slot.shape[0]
    counts = torch.bincount(slot.long(), minlength=T + 1).to(torch.int32)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0, dtype=torch.int32)])
    perm = torch.argsort(slot, stable=True).to(torch.int32)
    start_count = torch.stack([offsets[:-1], counts])
    ids = torch.arange(n, dtype=torch.int32, device=slot.device)
    rows_out = torch.cat([rows, ids[None]]).index_select(1, perm.long())
    return counts, offsets, perm, start_count, rows_out


def digit_passes(T: int) -> Tuple[int, ...]:
    """The widths of the sort's digits, least significant first: the bits
    of T (the largest bucket id) in digits of DIGIT_BITS, the last the
    rest."""
    bits = T.bit_length()
    return tuple(min(DIGIT_BITS, bits - lo) for lo in range(0, bits, DIGIT_BITS))


def fill_tiles(T: int) -> int:
    """Blocks of the fill: the T + 2 offsets in tiles of FILL_TILE buckets,
    so a gap between two neighbouring keys is split at the tiles it
    spans."""
    return -(-(T + 2) // FILL_TILE)


def csr_build(slot: torch.Tensor, T: int, rows: torch.Tensor) -> Tensors5:
    """csr_build_plain's contract; launches the CUDA kernel for CUDA tensors.
    counts is a view of start_count[1] and perm one of rows_out[-1]."""
    if not slot.is_cuda:
        return csr_build_plain(slot, T, rows)
    return _launch(slot, T, rows)


def _launch(slot: torch.Tensor, T: int, rows: torch.Tensor) -> Tensors5:
    dev = slot.device
    n = slot.shape[0] if slot.dim() == 1 else -1
    if not 1 <= T < 2**31 - 2:
        raise ValueError(f"table size {T} out of range")
    if rows.dim() != 2:
        raise ValueError(f"rows: expected [R, n], got {tuple(rows.shape)}")
    _build.require(slot, "slot", torch.int32, (n,))
    _build.require(rows, "rows", torch.int32, (rows.shape[0], n), dev)
    widths = digit_passes(T)
    scratch_bytes = _build.function("dfp_csr_build_scratch_bytes",
                                    (_build.I64, _build.I64, _build.I32), _build.I64)
    fn = _build.function("dfp_csr_build", (
        _build.P, _build.I64, _build.I64, _build.P, _build.I32, ctypes.POINTER(ctypes.c_int),
        _build.I32, _build.P, _build.P, _build.P, _build.P, _build.I64, _build.P))
    R = rows.shape[0]
    offsets = torch.empty(T + 2, dtype=torch.int32, device=dev)
    start_count = torch.empty((2, T + 1), dtype=torch.int32, device=dev)
    rows_out = torch.empty((R + 1, n), dtype=torch.int32, device=dev)
    nbytes = scratch_bytes(n, T, len(widths))
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    err = fn(slot.data_ptr(), n, T, rows.data_ptr(), R, (ctypes.c_int * len(widths))(*widths),
             len(widths), offsets.data_ptr(), start_count.data_ptr(),
             rows_out.data_ptr(), scratch.data_ptr(), nbytes, _build.stream(dev))
    csr_build.launches += 1
    _build.check(err, "csr_build")
    return start_count[1], offsets, rows_out[R], start_count, rows_out


csr_build.launches = 0
