"""Join lookup structures (torch): the CSR, SORT and OA strategies.

Counterpart of `datafusion_parallelism_tpu/ops/hash_table.py`, with the
same three strategies and tables bit for bit:

  * CSR   bucket counts, offsets, a stable row permutation into bucket
          order and a [2, T+1] (start, count) descriptor per bucket; bucket
          T holds the rows with null keys and the padding (K2);
  * SORT  the rows stably sorted by their hash (K6 over the words
          (invalid, hash)); a probe binary-searches the sorted keys (K14);
  * OA    open addressing: the rows sorted by (home slot, hash) (K6) and
          placed by the parking-function scan (K15) into S = T + T/4
          slots; a probe walks from its home slot (K16).

Every strategy gives each probe row a contiguous candidate range
[start, start+count) of positions in its table's row order, so the join
downstream is one code path. The functions here reach the kernels through
their wrappers (kernels on CUDA tensors, plain versions on CPU tensors);
`ops/join.py` reaches the same builds through its kernel tables.
"""

from __future__ import annotations

import enum
from typing import Callable, NamedTuple, Tuple

import torch

from ..kernels import csr_build as k2
from ..kernels import filter_compact as k5
from ..kernels import oa_place as k15
from ..kernels import oa_probe as k16
from ..kernels import probe_expand as k3
from ..kernels import radix_sort as k6
from ..kernels import sorted_probe as k14

_M32 = 0xFFFFFFFF
_SORT_INVALID = 1 << 33      # SORT's key of a null-key or padding row


class JoinStrategy(enum.Enum):
    CSR = "csr"          # bucketed hash table (default)
    SORT = "sort"        # rows sorted by hash, binary-search probe
    OA = "oa"            # open addressing, linear-probe walk


class JoinTable(NamedTuple):
    """Frozen build-side lookup structure; the JAX package's JoinTable with
    an explicit strategy in place of its shape tags.

    CSR:  offsets[T+2] int32 bucket offsets, perm[cap] int32 row ids in
          bucket order, start_count[2, T+1] int32 (bucket starts; counts).
    SORT: perm[cap] the stable order of the rows by hash, sorted_hash[cap]
          int64 their keys (the hash as unsigned, 2^33 for a null key or
          padding) in that order.
    OA:   sorted_hash[S] int64 slots, each (hash << 32 | row id + 1), 0 where
          empty; perm[S] the row id of each slot (0 where empty); S = T + T/4.
    A field a strategy does not use is an empty tensor."""
    offsets: torch.Tensor
    perm: torch.Tensor
    sorted_hash: torch.Tensor
    start_count: torch.Tensor
    strategy: JoinStrategy = JoinStrategy.CSR

    @property
    def is_sort(self) -> bool:
        return self.strategy is JoinStrategy.SORT

    @property
    def is_oa(self) -> bool:
        return self.strategy is JoinStrategy.OA


def table_size_for(capacity: int) -> int:
    # 4x load headroom (false bucket collisions add ~cap/4 candidates) and a
    # floor of 64k buckets so a tiny build probed by a huge side stays cheap
    return max(4 * capacity, 1 << 16)


def oa_slots_for(T: int) -> int:
    """OA's slot count: a spill region of T/4 past the T home slots
    replaces wraparound (any row lands below (cap - 1) + (T - 1) < S - 1)."""
    return T + T // 4


def slot_of(hashes: torch.Tensor, T: int) -> torch.Tensor:
    """Map uint32 hash bits (held in int32) to a bucket in [0, T) for ANY T:
    a mask for a power of two, else the multiply-shift reduction (Lemire)
    floor(h * T / 2^32), whose product stays below 2^62 in int64."""
    if T & (T - 1) == 0 and T <= 2**31 and hashes.dtype == torch.int32:
        return hashes & (T - 1)       # the low bits, in one int32 pass
    h = hashes.long() & _M32
    if T & (T - 1) == 0:
        return (h & (T - 1)).to(torch.int32)
    return ((h * T) >> 32).to(torch.int32)


def _empty(dtype, device) -> torch.Tensor:
    return torch.empty(0, dtype=dtype, device=device)


def _valid_rows(hashes, key_valid, num_rows) -> torch.Tensor:
    in_row = torch.arange(hashes.shape[0], dtype=torch.int32, device=hashes.device) < num_rows
    return in_row & key_valid


def _with_ids(rows: torch.Tensor) -> torch.Tensor:
    """`rows` [R, cap] with the row id appended as the last word row."""
    ids = torch.arange(rows.shape[1], dtype=torch.int32, device=rows.device)
    return torch.cat([rows, ids[None]])


def sort_table_rows(hashes: torch.Tensor, ok: torch.Tensor, rows: torch.Tensor,
                    sort: Callable = k6.radix_sort, gather: Callable = k5.gather_rows
                    ) -> Tuple[JoinTable, torch.Tensor]:
    """The SORT table of hashes int32[cap] (uint32 bits) over the rows where
    `ok`, and `rows` [R, cap] plus the row id in its row order. `sort` (K6)
    stably orders the rows by the words (invalid, hash as unsigned), which
    is JAX's argsort of the int64 key with its 2^33 sentinel; `gather` (K5)
    puts the rows and the key (its bits carried as a float64 sidecar) into
    that order in one pass."""
    inval = (~ok).to(torch.int32)
    perm = sort(torch.stack([inval, torch.where(ok, hashes, 0)]), [False, False])
    key = torch.where(ok, hashes.long() & _M32, _SORT_INVALID)
    rows_out, key_out = gather(_with_ids(rows), key.view(torch.float64)[None], perm)
    table = JoinTable(_empty(torch.int32, hashes.device), perm,
                      key_out[0].view(torch.int64), _empty(torch.int32, hashes.device),
                      JoinStrategy.SORT)
    return table, rows_out


def oa_table_rows(hashes: torch.Tensor, ok: torch.Tensor, T: int,
                  rows: torch.Tensor, sort: Callable = k6.radix_sort,
                  place: Callable = k15.oa_place, gather: Callable = k5.gather_rows
                  ) -> Tuple[JoinTable, torch.Tensor]:
    """The OA table of hashes int32[cap] over the rows where `ok`, each
    homed at slot_of(hash, T), and `rows` [R, cap] plus the row id in slot
    order ([R + 1, S]; an empty slot holds row 0's words, which no
    candidate reads). `sort` (K6) orders the rows by (invalid, home, hash),
    JAX's composite key with its 2^62 sentinel; `place` (K15) parks them;
    `gather` (K5) puts the rows into slot order. The homes are made here
    from the hashes, so they are what K15 computes on the card."""
    inval = (~ok).to(torch.int32)
    key = torch.where(ok, hashes, 0)
    home = slot_of(key, T)            # slot_of(0) = 0: the invalid rows' home word
    order = sort(torch.stack([inval, home, key]), [False, False, False])
    slots, perm = place(order, home, hashes, ok, oa_slots_for(T))
    rows_out, _ = gather(_with_ids(rows), rows.new_empty((0, rows.shape[1]), dtype=torch.float64),
                         perm)
    table = JoinTable(_empty(torch.int32, hashes.device), perm, slots,
                      _empty(torch.int32, hashes.device), JoinStrategy.OA)
    return table, rows_out


def build_csr(hashes: torch.Tensor, key_valid: torch.Tensor, num_rows,
              csr_build: Callable = k2.csr_build) -> JoinTable:
    """The CSR table of hashes int32[cap]; `csr_build` is K2's wrapper or
    its plain version."""
    cap = hashes.shape[0]
    T = table_size_for(cap)
    slot = torch.where(_valid_rows(hashes, key_valid, num_rows), slot_of(hashes, T),
                       T).to(torch.int32)
    no_rows = torch.empty((0, cap), dtype=torch.int32, device=hashes.device)
    _, offsets, perm, start_count, _ = csr_build(slot, T, no_rows)
    return JoinTable(offsets, perm, _empty(torch.int64, hashes.device), start_count)


def build_sorted(hashes: torch.Tensor, key_valid: torch.Tensor, num_rows) -> JoinTable:
    ok = _valid_rows(hashes, key_valid, num_rows)
    no_rows = torch.empty((0, hashes.shape[0]), dtype=torch.int32, device=hashes.device)
    return sort_table_rows(hashes, ok, no_rows)[0]


def build_oa(hashes: torch.Tensor, key_valid: torch.Tensor, num_rows) -> JoinTable:
    T = table_size_for(hashes.shape[0])
    ok = _valid_rows(hashes, key_valid, num_rows)
    no_rows = torch.empty((0, hashes.shape[0]), dtype=torch.int32, device=hashes.device)
    return oa_table_rows(hashes, ok, T, no_rows)[0]


def build_join_table(hashes, key_valid, num_rows,
                     strategy: JoinStrategy = JoinStrategy.CSR) -> JoinTable:
    if strategy is JoinStrategy.SORT:
        return build_sorted(hashes, key_valid, num_rows)
    if strategy is JoinStrategy.OA:
        return build_oa(hashes, key_valid, num_rows)
    return build_csr(hashes, key_valid, num_rows)


class CandidateRanges(NamedTuple):
    """Per probe row: candidates at table positions [start, start+count),
    output slots [base, base+count); `total` is the candidate count (the
    caller's overflow check)."""
    start: torch.Tensor       # int32[m]
    count: torch.Tensor       # int32[m]
    base: torch.Tensor        # int32[m]
    total: torch.Tensor       # int32 0-dim


def table_ranges(table: JoinTable, hashes: torch.Tensor, slot: torch.Tensor,
                 ok: torch.Tensor, probe_ranges: Callable = k3.probe_ranges,
                 sorted_probe: Callable = k14.sorted_probe,
                 oa_probe: Callable = k16.oa_probe) -> k3.Ranges:
    """(start, count, base, total) of probe rows with hashes int32[m], their
    buckets in [0, T) (CSR; None under SORT and OA, whose probes work from
    the hashes) and `ok` (in range, keys valid): K3's first pass under CSR,
    K14 under SORT, K16 under OA."""
    if table.is_sort:
        return sorted_probe(hashes, ok, table.sorted_hash)
    if table.is_oa:
        return oa_probe(hashes, ok, table.sorted_hash)
    return probe_ranges(slot, ok, table.offsets)


def probe_candidates(table: JoinTable, probe_hashes, probe_key_valid,
                     probe_num_rows) -> CandidateRanges:
    ok = _valid_rows(probe_hashes, probe_key_valid, probe_num_rows)
    slot = (None if table.is_sort or table.is_oa
            else slot_of(probe_hashes, table.offsets.shape[0] - 2))
    return CandidateRanges(*table_ranges(table, probe_hashes, slot, ok))


def probe_ranges(table: JoinTable, probe_hashes: torch.Tensor,
                 probe_key_valid: torch.Tensor, probe_num_rows):
    """Per probe row: (start, count) range of candidates in the table's row
    order; count is 0 for rows past num_rows or with a null key."""
    cr = probe_candidates(table, probe_hashes, probe_key_valid, probe_num_rows)
    return cr.start, cr.count
