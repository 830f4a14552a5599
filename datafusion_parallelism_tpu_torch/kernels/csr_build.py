"""K2 csr_build: the CSR hash table of the build side, and its narrow rows
in bucket order.

Replaces the JAX package's `hash_table.build_csr` and the deferred join's
narrow permute (ops/join.py:301-306). The CUDA kernel is `csrc/csr_build.cu`,
whose header says what bounds it on the H100 and why it is a stable radix
sort; the plain version below is the same function in torch ops. On CPU
tensors the wrapper runs the plain version; on CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

Tensors5 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


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


def csr_build(slot: torch.Tensor, T: int, rows: torch.Tensor) -> Tensors5:
    """csr_build_plain's contract; launches the CUDA kernel for CUDA tensors."""
    if not slot.is_cuda:
        return csr_build_plain(slot, T, rows)
    dev = slot.device
    n = slot.shape[0] if slot.dim() == 1 else -1
    _build.require(slot, "slot", torch.int32, (n,))
    if rows.dim() != 2:
        raise ValueError(f"rows: expected [R, n], got {tuple(rows.shape)}")
    _build.require(rows, "rows", torch.int32, (rows.shape[0], n), dev)
    if not 1 <= T < 2**31 - 2:
        raise ValueError(f"table size {T} out of range")
    lib_scratch = _build.function("dfp_csr_build_scratch_bytes",
                                  (_build.I64, _build.I64), _build.I64)
    fn = _build.function("dfp_csr_build", (
        _build.P, _build.I64, _build.I64, _build.P, _build.I32, _build.P, _build.P,
        _build.P, _build.P, _build.P, _build.P, _build.I64, _build.P))
    counts = torch.empty(T + 2, dtype=torch.int32, device=dev)  # last entry stays 0
    offsets = torch.empty(T + 2, dtype=torch.int32, device=dev)
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    start_count = torch.empty((2, T + 1), dtype=torch.int32, device=dev)
    rows_out = torch.empty((rows.shape[0] + 1, n), dtype=torch.int32, device=dev)
    nbytes = lib_scratch(n, T)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    err = fn(slot.data_ptr(), n, T, rows.data_ptr(), rows.shape[0], counts.data_ptr(),
             offsets.data_ptr(), perm.data_ptr(), start_count.data_ptr(),
             rows_out.data_ptr(), scratch.data_ptr(), nbytes, _build.stream(dev))
    csr_build.launches += 1
    _build.check(err, "csr_build")
    return counts[:T + 1], offsets, perm, start_count, rows_out


csr_build.launches = 0
