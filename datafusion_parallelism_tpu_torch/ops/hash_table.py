"""Join lookup structure: the CSR hash table (torch).

Counterpart of `datafusion_parallelism_tpu/ops/hash_table.py`, CSR strategy
only. The build side becomes bucket counts, offsets, a stable row
permutation into bucket order and a `[2, T+1]` (start, count) descriptor per
bucket; bucket T holds the rows with null keys and the padding. A probe row
reads its bucket's descriptor and its candidates are the perm positions
`[start, start+count)`.

`build_csr` goes through kernel K2 (kernels/csr_build.py) and
`probe_candidates` through K3's first pass (kernels/probe_expand.py): the
kernels on CUDA tensors, their plain versions on CPU tensors.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import torch

from ..kernels.csr_build import csr_build
from ..kernels.probe_expand import probe_ranges as _probe_ranges

_M32 = 0xFFFFFFFF


class JoinStrategy(enum.Enum):
    CSR = "csr"          # bucketed hash table (the only one ported)
    SORT = "sort"        # sort-merge on hashes (ROADMAP queue 1 item 11)
    OA = "oa"            # open addressing (ROADMAP queue 1 item 11)


class JoinTable(NamedTuple):
    """Frozen build-side lookup structure (CSR; the JAX package's JoinTable
    without the SORT/OA fields).

    offsets[T+2] int32 bucket offsets, perm[cap] int32 row ids in bucket
    order, start_count[2, T+1] int32 rows (bucket starts; bucket counts)."""
    offsets: torch.Tensor
    perm: torch.Tensor
    start_count: torch.Tensor


def table_size_for(capacity: int) -> int:
    # 4x load headroom (false bucket collisions add ~cap/4 candidates) and a
    # floor of 64k buckets so a tiny build probed by a huge side stays cheap
    return max(4 * capacity, 1 << 16)


def slot_of(hashes: torch.Tensor, T: int) -> torch.Tensor:
    """Map uint32 hash bits (held in int32) to a bucket in [0, T) for ANY T:
    a mask for a power of two, else the multiply-shift reduction (Lemire)
    floor(h * T / 2^32), whose product stays below 2^62 in int64."""
    h = hashes.long() & _M32
    if T & (T - 1) == 0:
        return (h & (T - 1)).to(torch.int32)
    return ((h * T) >> 32).to(torch.int32)


def build_csr(hashes: torch.Tensor, key_valid: torch.Tensor, num_rows) -> JoinTable:
    cap = hashes.shape[0]
    T = table_size_for(cap)
    in_row = torch.arange(cap, dtype=torch.int32, device=hashes.device) < num_rows
    slot = torch.where(in_row & key_valid, slot_of(hashes, T), T).to(torch.int32)
    no_rows = torch.empty((0, cap), dtype=torch.int32, device=hashes.device)
    _, offsets, perm, start_count, _ = csr_build(slot, T, no_rows)
    return JoinTable(offsets, perm, start_count)


class CandidateRanges(NamedTuple):
    """Per probe row: candidates at perm positions [start, start+count),
    output slots [base, base+count); `total` is the candidate count (the
    caller's overflow check)."""
    start: torch.Tensor       # int32[m]
    count: torch.Tensor       # int32[m]
    base: torch.Tensor        # int32[m]
    total: torch.Tensor       # int32 0-dim


def _csr_ranges(table: JoinTable, probe_hashes, probe_key_valid, probe_num_rows):
    mcap = probe_hashes.shape[0]
    T = table.offsets.shape[0] - 2
    in_row = (torch.arange(mcap, dtype=torch.int32, device=probe_hashes.device)
              < probe_num_rows)
    return _probe_ranges(slot_of(probe_hashes, T), in_row & probe_key_valid,
                         table.start_count)


def probe_ranges(table: JoinTable, probe_hashes: torch.Tensor,
                 probe_key_valid: torch.Tensor, probe_num_rows):
    """Per probe row: (start, count) range of hash-bucket candidates in perm;
    count is 0 for rows past num_rows or with a null key."""
    start, count, _, _ = _csr_ranges(table, probe_hashes, probe_key_valid,
                                     probe_num_rows)
    return start, count


def probe_candidates(table: JoinTable, probe_hashes, probe_key_valid,
                     probe_num_rows) -> CandidateRanges:
    return CandidateRanges(*_csr_ranges(table, probe_hashes, probe_key_valid,
                                        probe_num_rows))
