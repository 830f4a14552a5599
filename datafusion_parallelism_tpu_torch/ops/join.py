"""Vectorized hash join (torch): all eight join types on the CSR, SORT and
OA strategies.

Counterpart of `datafusion_parallelism_tpu/ops/join.py`. Two paths, as in
the JAX package:

  * deferred (no residual, not a late-materialized INNER join, keys whose
    words compare bit for bit): only the key words (`key_words`) and the
    row id travel through the candidate stage; the columns of both sides
    are gathered once, at the matches, from the tables' own buffers (JAX
    ops/join.py:255-320, :393-416);
  * full fetch (a residual filter, `expanded` INNER, float keys, keys of
    different widths): every candidate pair's whole rows, rechecked by
    value (JAX :322-357).

The kernels, each reached through a `JoinKernels` table:

  K1  hash_slot       row hash of both sides; the CSR buckets of both,
                      the SORT and OA builds' null/padding rows (slot T)
  K2  csr_build       CSR table + build rows in bucket order (row-major
                      for the deferred path's recheck)
  K3  probe_expand    CSR candidate ranges (probe_ranges); the candidate
                      pairs of any strategy's ranges and the bitwise key
                      recheck of the deferred path (expand_ranges)
  K4  compact_gather  stable compaction + both sides' columns gathered
                      (deferred)
  K6  table_sort      SORT / OA: the build rows' stable order by hash
  K9  pair_fetch      whole candidate rows + the value recheck (full fetch)
  K10 match_flags     visited build rows / matched probe rows
  K11 concat_rows     pairs + unmatched rows of LEFT/RIGHT/FULL joins
  K14 sorted_probe    SORT: candidate ranges through a bucket directory
  K15 oa_place        OA: the rows parked into the open-addressing slots
  K16 oa_probe        OA: candidate ranges by linear-probe walks

plus K5 and K12 (through the chain's `ChainKernels`) for the SORT and OA
builds' rows in table order, the compactions of the full-fetch pairs and
of semi, anti and unmatched rows, and for packing and unpacking the
tables of those paths (a prepared build's rows, the full fetch, the outer
joins' concatenation); the deferred INNER join packs nothing. Each
wrapper launches its CUDA kernel on CUDA tensors and runs its plain torch
version on CPU tensors.

A frozen build side (`prepare_build`, JAX :85-162) is K1 and the
strategy's build run once: streamed and grace-partitioned execution probe
it with every chunk.
"""

from __future__ import annotations

import enum
from typing import Callable, List, NamedTuple, Optional

import torch

from ..kernels import compact_gather as k4
from ..kernels import concat_rows as k11
from ..kernels import csr_build as k2
from ..kernels import hash_slot as k1
from ..kernels import match_flags as k10
from ..kernels import oa_place as k15
from ..kernels import oa_probe as k16
from ..kernels import pair_fetch as k9
from ..kernels import probe_expand as k3
from ..kernels import radix_sort as k6
from ..kernels import sorted_probe as k14
from ..kernels.chain import KERNELS as CHAIN_KERNELS
from ..kernels.chain import ChainKernels
from ..utils.columnar import (DeviceTable, Kind, PackedTable, Schema, compact_rows,
                              concat_tables, f64_matrix, filter_rows, hstack_tables,
                              int64_words, null_columns_like, pack_table, unpack_table)
from .hash_table import (JoinStrategy, JoinTable, oa_table_rows, sort_table_rows,
                         table_ranges, table_size_for)
from .hashing import KIND_F32, KIND_F64, key_words


class JoinType(enum.Enum):
    INNER = "inner"
    LEFT = "left"            # build-side outer
    RIGHT = "right"          # probe-side outer
    FULL = "full"
    LEFT_SEMI = "left_semi"
    LEFT_ANTI = "left_anti"
    RIGHT_SEMI = "right_semi"
    RIGHT_ANTI = "right_anti"

    @property
    def emits_build(self) -> bool:
        return self in (JoinType.INNER, JoinType.LEFT, JoinType.RIGHT,
                        JoinType.FULL, JoinType.LEFT_SEMI, JoinType.LEFT_ANTI)

    @property
    def emits_probe(self) -> bool:
        return self in (JoinType.INNER, JoinType.LEFT, JoinType.RIGHT,
                        JoinType.FULL, JoinType.RIGHT_SEMI, JoinType.RIGHT_ANTI)


# the join types that read each flag of K10
_READS_VISITED = (JoinType.LEFT, JoinType.FULL, JoinType.LEFT_SEMI, JoinType.LEFT_ANTI)
_READS_PROBE_MATCHED = (JoinType.RIGHT, JoinType.FULL, JoinType.RIGHT_SEMI,
                        JoinType.RIGHT_ANTI)


def join_output_schema(build: Schema, probe: Schema, join_type: JoinType) -> Schema:
    fields = []
    if join_type.emits_build:
        fields += list(build.fields)
    if join_type.emits_probe:
        fields += list(probe.fields)
    return Schema(fields)


def _keys_valid(t: DeviceTable, keys: List[str]) -> torch.Tensor:
    v = None
    for k in keys:
        _, valid = t.column(k)
        v = valid if v is None else (v & valid)
    return v


def _null_side(schema: Schema, capacity: int, num_rows) -> DeviceTable:
    return DeviceTable(schema, null_columns_like(schema, capacity, device=num_rows.device),
                       num_rows)


def _field_info(layout):
    """name -> (kind, first word slot, word count, validity word row, bit)."""
    info = {}
    for j, (name, kind, slot, n) in enumerate(layout.fields):
        info[name] = (kind, slot, n, layout.valid_base + j // 32, j % 32)
    return info


def _packed_keys(layout, keys):
    """Per key: (float?, word rows, (validity row, bit)) in a packed layout
    (a prepared build's perm rows)."""
    out = []
    for k in keys:
        kind, slot, n, vrow, bit = _field_info(layout)[k]
        out.append((kind in (Kind.FLOAT64, Kind.FLOAT32), list(range(slot, slot + n)),
                    (vrow, bit)))
    return out


def _word_keys(cols, valid: bool = True):
    """Per key: (float?, word rows, (validity row, bit)) in `key_words`'
    rows: each column's words, then its validity as a 0/1 row. valid=False
    names no validity row (None): a build side whose table holds only rows
    with valid keys (K1 sends the rest to slot T), whose rows are then its
    key words alone."""
    return [(kind in (KIND_F32, KIND_F64), list(rows), v if valid else None)
            for kind, rows, v in cols]


def _defer_key_plan(bkeys, pkeys):
    """The recheck plan of the deferred probe path, from each side's keys
    (`_word_keys` or `_packed_keys`): per key the build and probe word rows
    compared bit for bit and each side's validity (row, bit; the build's
    may be None: not tested). None when
    bit-equality of the words is not equivalent to the value recheck
    (float keys: ±0.0; mixed-width keys: value promotion)."""
    compares = []
    for (bf, bw, bv), (pf, pw, pv) in zip(bkeys, pkeys):
        if bf or pf or len(bw) != len(pw) or not bw:
            return None
        compares.append((bw, pw, bv, pv))
    return compares


def _fetch_key(layout, name: str, build: bool):
    """(kind, row, (validity row, bit)) of one key for K9. A float64 key is
    the build's word pair at rows width + 2 i (`_with_f64_pairs`) or the
    probe's sidecar i."""
    kind, slot, n, vrow, vbit = _field_info(layout)[name]
    if kind is Kind.FLOAT64:
        i = layout.f64_fields.index(name)
        return k9.KEY_F64, layout.width + 2 * i if build else i, (vrow, vbit)
    if n == 2:
        return k9.KEY_I64, slot, (vrow, vbit)
    return (k9.KEY_F32 if kind is Kind.FLOAT32 else k9.KEY_I32), slot, (vrow, vbit)


def _fetch_keys(blayout, playout, build_keys, probe_keys):
    keys = []
    for bk, pk in zip(build_keys, probe_keys):
        bkind, brow, bv = _fetch_key(blayout, bk, True)
        pkind, prow, pv = _fetch_key(playout, pk, False)
        keys.append((bkind, brow, pkind, prow, bv, pv))
    return keys


class PreparedBuild(NamedTuple):
    """A frozen build side: the table, its packed rows, its strategy's
    lookup table and its rows in that table's order, built once and probed
    by any number of streamed probe chunks (JAX ops/join.py:85).
    `perm_rows` is the packed words with the float64 sidecars as word pairs
    (`_with_f64_pairs`) and the row id last, in table order (bucket order,
    sorted order, or slot order with S columns under OA): the deferred path
    reads its key rows, the full-fetch path (K9) all of them."""
    build: DeviceTable
    packed: PackedTable
    table: JoinTable
    perm_rows: torch.Tensor


class JoinKernels(NamedTuple):
    """The join's stages, as functions with the kernels' contracts."""
    hash_slot: Callable        # K1
    csr_build: Callable        # K2
    compact_gather: Callable   # K4
    probe_ranges: Callable     # K3's first pass: the CSR ranges and their scan
    pair_fetch: Callable       # K9
    match_flags: Callable      # K10
    concat_rows: Callable      # K11
    expand_ranges: Callable    # K3's second pass: candidates + bitwise recheck
    table_sort: Callable       # K6, the SORT and OA builds' order
    sorted_probe: Callable     # K14
    oa_place: Callable         # K15
    oa_probe: Callable         # K16


# the kernel each entry point belongs to
KERNEL_OF = {"hash_slot": "hash_slot", "csr_build": "csr_build",
             "compact_gather": "compact_gather", "probe_ranges": "probe_expand",
             "pair_fetch": "pair_fetch", "match_flags": "match_flags",
             "concat_rows": "concat_rows", "expand_ranges": "probe_expand",
             "table_sort": "radix_sort", "sorted_probe": "sorted_probe",
             "oa_place": "oa_place", "oa_probe": "oa_probe"}

# the wrappers: kernels on CUDA tensors, plain versions on CPU tensors
KERNELS = JoinKernels(k1.hash_slot, k2.csr_build, k4.compact_gather, k3.probe_ranges,
                      k9.pair_fetch, k10.match_flags, k11.concat_rows, k3.expand_ranges,
                      k6.radix_sort, k14.sorted_probe, k15.oa_place, k16.oa_probe)
# the plain versions on any device: the reference the kernel path is held to
PLAIN = JoinKernels(k1.hash_slot_plain, k2.csr_build_plain, k4.compact_gather_plain,
                    k3.probe_ranges_plain, k9.pair_fetch_plain, k10.match_flags_plain,
                    k11.concat_rows_plain, k3.expand_ranges_plain, k6.radix_sort_plain,
                    k14.sorted_probe_plain, k15.oa_place_plain, k16.oa_probe_plain)


def _with_f64_pairs(pt: PackedTable) -> torch.Tensor:
    """The packed words with each float64 sidecar appended as its (lo, hi)
    word pair: the rows K2 puts into perm order for K9 (`_perm_rows`)."""
    if not pt.f64s:
        return pt.packed
    pairs = [w for v in pt.f64s.values() for w in int64_words(v.view(torch.int64))]
    return torch.cat([pt.packed, torch.stack(pairs)])


def _build_table(strategy: JoinStrategy, kernels: JoinKernels, chain: ChainKernels,
                 words, cols, T: int, num_rows, build_valid, rows, row_major: bool = False):
    """K1 over the build's key words (null keys, padding and rows outside
    `build_valid` to slot T), then the strategy's table with `rows` [R, cap]
    and the row id in its row order: K2 (CSR; row-major rows on request);
    K6 and K5's gather (SORT); K6, K15 and K5's gather (OA). Returns
    (JoinTable, rows in table order)."""
    hashes, slot = kernels.hash_slot(words, cols, T, num_rows, build_valid)
    if strategy is JoinStrategy.CSR:
        _, offsets, perm, start_count, rows_out = kernels.csr_build(slot, T, rows, row_major)
        return JoinTable(offsets, perm, hashes.new_empty(0, dtype=torch.int64),
                         start_count), rows_out
    ok = slot != T
    if strategy is JoinStrategy.SORT:
        return sort_table_rows(hashes, ok, rows, kernels.table_sort, chain.gather_rows)
    return oa_table_rows(hashes, ok, T, rows, kernels.table_sort, kernels.oa_place,
                         chain.gather_rows)


def _probe_table(table: JoinTable, kernels: JoinKernels, words, cols, T: int, ok):
    """K1 over the probe's key words (their buckets only under CSR: K14
    and K16 work from the hashes), then the candidate ranges (start, count,
    base, total): K3's first pass, K14 or K16."""
    hashes, slot = kernels.hash_slot(words, cols,
                                     None if table.is_sort or table.is_oa else T)
    return table_ranges(table, hashes, slot, ok, kernels.probe_ranges, kernels.sorted_probe,
                        kernels.oa_probe)


def prepare_build(build: DeviceTable, build_keys: List[str],
                  strategy: JoinStrategy = JoinStrategy.CSR, kernels: JoinKernels = KERNELS,
                  chain: Optional[ChainKernels] = None) -> PreparedBuild:
    """Freeze `build` for repeated probing: K12 packs it, K1 hashes its key
    values (null keys and padding to slot T) and the strategy's build
    (`_build_table`) makes its table and puts every row in table order."""
    chain = chain or CHAIN_KERNELS
    bp = pack_table(build, chain)
    T = table_size_for(build.capacity)
    words, cols = key_words([build.column(k) for k in build_keys])
    table, perm_rows = _build_table(strategy, kernels, chain, words, cols, T, build.num_rows,
                                    None, _with_f64_pairs(bp))
    return PreparedBuild(build, bp, table, perm_rows)


def inner_csr_join(build: DeviceTable, probe: DeviceTable, build_keys: List[str],
                   probe_keys: List[str], out_cap: int,
                   kernels: JoinKernels = KERNELS, chain: Optional[ChainKernels] = None):
    """The INNER join's deferred chain K1 -> K2 -> K3 -> K4 through
    `kernels` (packing through `chain`'s K12): hash_join(...,
    JoinType.INNER, out_cap) for keys the deferred path takes. Returns
    (table, candidate_total)."""
    return hash_join(build, probe, build_keys, probe_keys, JoinType.INNER, out_cap,
                     kernels=kernels, chain=chain)


def hash_join(build: DeviceTable, probe: DeviceTable,
              build_keys: List[str], probe_keys: List[str],
              join_type: JoinType, out_cap: int,
              strategy: JoinStrategy = JoinStrategy.CSR,
              residual=None, prepared=None, expanded: bool = False,
              build_valid: Optional[torch.Tensor] = None,
              probe_valid: Optional[torch.Tensor] = None,
              return_visited: bool = False,
              kernels: JoinKernels = KERNELS, chain: Optional[ChainKernels] = None,
              visited_into: Optional[torch.Tensor] = None):
    """Join two device tables; the JAX package's signature and results.

    Returns (result, candidate_total); the caller checks candidate_total
    <= out_cap and retries with a larger out_cap otherwise. residual: a
    predicate over the candidate pair table returning (values, validity);
    NULL rejects the pair. expanded (INNER and the semi/anti types):
    (table, mask, candidate_total), for INNER the uncompacted candidate
    slots (capacity out_cap) with the match mask, for semi/anti the input
    side itself with its flag. build_valid / probe_valid: masks of an input
    side that is itself another join's or filter's uncompacted output.
    return_visited: the build-side visited mask is appended to the tuple.
    prepared: a frozen build side (`prepare_build`); `build` is ignored
    then, and build_valid must be None. visited_into: a bool [build
    capacity] buffer the matches are ORed into in place (K10's accumulate
    mode) and returned as the visited mask: the cross-chunk fold of a
    streamed build-emitting join. `kernels` and `chain`
    (kernels/chain.py's table, its KERNELS when None) are the kernels the
    join reaches."""
    if len(build_keys) != len(probe_keys) or not build_keys:
        raise ValueError("join needs the same number (>= 1) of keys on both sides")
    chain = chain or CHAIN_KERNELS
    if prepared is not None:
        if build_valid is not None:
            raise ValueError("a prepared build side cannot carry a mask")
        build = prepared.build
    if set(build.schema.names) & set(probe.schema.names):
        raise ValueError("join inputs must have disjoint column names")
    if expanded and join_type not in (JoinType.INNER, JoinType.LEFT_SEMI, JoinType.LEFT_ANTI,
                                      JoinType.RIGHT_SEMI, JoinType.RIGHT_ANTI):
        raise ValueError(f"expanded unsupported for {join_type}")
    if expanded and join_type is JoinType.INNER and return_visited:
        raise ValueError("an expanded INNER join returns no visited mask")

    T = table_size_for(build.capacity)
    probe_ok = probe.row_mask() & _keys_valid(probe, probe_keys)
    if probe_valid is not None:
        probe_ok = probe_ok & probe_valid
    pwords, pcols = key_words([probe.column(k) for k in probe_keys])
    if prepared is None:
        bwords, bcols = key_words([build.column(k) for k in build_keys])
        bkeys = _word_keys(bcols, valid=False)
    else:   # its key rows are read out of its packed perm rows
        bkeys = _packed_keys(prepared.packed.layout, build_keys)
    compares = None
    if residual is None and not (expanded and join_type is JoinType.INNER):
        compares = _defer_key_plan(bkeys, _word_keys(pcols))

    if compares is not None:
        # deferred: the key words and the row id in table order; the perm
        # rows of a prepared build as they are
        if prepared is not None:
            table, bsorted = prepared.table, prepared.perm_rows
        else:
            key_rows = bwords[:bwords.shape[0] - len(bcols)]   # the validity rows left out
            table, bsorted = _build_table(strategy, kernels, chain, bwords, bcols, T,
                                          build.num_rows, build_valid, key_rows,
                                          key_rows.shape[0] + 1 <= k2.MAX_ROW_WORDS)
        ranges = _probe_table(table, kernels, pwords, pcols, T, probe_ok)
        total = ranges[3]
        match, probe_idx, build_id = kernels.expand_ranges(*ranges, pwords, bsorted, compares,
                                                           out_cap)
        gb = gp = None
    else:
        # full fetch: the build's whole rows (float64 sidecars as word pairs)
        # go into table order (JAX `_perm_rows`), K9 fetches both sides'
        # rows at every candidate slot and rechecks the keys by value
        bp = prepared.packed if prepared is not None else pack_table(build, chain)
        pp = pack_table(probe, chain)
        if prepared is not None:
            table, bperm = prepared.table, prepared.perm_rows
        else:
            table, bperm = _build_table(strategy, kernels, chain, bwords, bcols, T,
                                        build.num_rows, build_valid, _with_f64_pairs(bp))
        start, _, base, total = _probe_table(table, kernels, pwords, pcols, T, probe_ok)
        out_b, out_bf, out_p, out_pf, probe_idx, build_id, match = kernels.pair_fetch(
            start, base, total, pp.packed, f64_matrix(pp), bperm, len(bp.f64s),
            _fetch_keys(bp.layout, pp.layout, build_keys, probe_keys), out_cap)
        gb = PackedTable(out_b, dict(zip(bp.layout.f64_fields, out_bf)), bp.layout)
        gp = PackedTable(out_p, dict(zip(pp.layout.f64_fields, out_pf)), pp.layout)
        inner_expanded = expanded and join_type is JoinType.INNER
        if residual is not None or inner_expanded:
            pairs = hstack_tables(unpack_table(gb, build.schema, out_cap, chain),
                                  unpack_table(gp, probe.schema, out_cap, chain), out_cap)
            if residual is not None:
                rvals, rvalid = residual(pairs)
                match = match & rvalid & rvals.to(torch.bool)
            if inner_expanded:   # late-materialized: the uncompacted pairs
                return pairs, match, total

    # K10 makes only the flags the join type reads (the JAX package makes
    # both, and XLA drops the unread one), from the slots below the total
    visited = probe_matched = None
    reads_visited = join_type in _READS_VISITED or return_visited
    if reads_visited or join_type in _READS_PROBE_MATCHED:
        visited, probe_matched = kernels.match_flags(
            match, build_id, probe_idx, build.capacity if reads_visited else None,
            probe.capacity if join_type in _READS_PROBE_MATCHED else None, visited_into, total)
    # each side's live rows, made only where the join type reads them (an
    # INNER join reads neither: XLA drops them as dead code in JAX)
    def build_in() -> torch.Tensor:
        rows = build.row_mask()
        return rows if build_valid is None else rows & build_valid

    def probe_in() -> torch.Tensor:
        rows = probe.row_mask()
        return rows if probe_valid is None else rows & probe_valid

    if expanded:   # semi/anti, late-materialized: the input side and its flag
        if join_type in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
            side, rows, flag = build, build_in(), visited
        else:
            side, rows, flag = probe, probe_in(), probe_matched
        semi = join_type in (JoinType.LEFT_SEMI, JoinType.RIGHT_SEMI)
        out = (side, rows & (flag if semi else ~flag), total)
        return out + (visited,) if return_visited else out

    def pairs_table() -> DeviceTable:
        if gb is None:   # deferred: compact the pairs, gather both sides' columns (K4)
            out_b, out_p, n_match = kernels.compact_gather(
                match, build_id, probe_idx, [build.columns[c] for c in build.schema.names],
                [probe.columns[c] for c in probe.schema.names], total)
            n = n_match.to(torch.int32)
            return hstack_tables(DeviceTable(build.schema, dict(zip(build.schema.names, out_b)), n),
                                 DeviceTable(probe.schema, dict(zip(probe.schema.names, out_p)), n),
                                 n)
        # full fetch: both sides compact in ONE K5 launch
        (cb, cp), n = compact_rows([gb, gp], match, out_cap, chain)
        return hstack_tables(unpack_table(cb, build.schema, n, chain),
                             unpack_table(cp, probe.schema, n, chain), n)

    def unmatched_build() -> DeviceTable:
        ub = filter_rows(build, build_in() & ~visited, chain)
        return hstack_tables(ub, _null_side(probe.schema, ub.capacity, ub.num_rows),
                             ub.num_rows)

    def unmatched_probe() -> DeviceTable:
        up = filter_rows(probe, probe_in() & ~probe_matched, chain)
        return hstack_tables(_null_side(build.schema, up.capacity, up.num_rows), up,
                             up.num_rows)

    def concat(parts):
        return concat_tables(parts, kernels.concat_rows, chain)

    if join_type is JoinType.INNER:
        result = pairs_table()
    elif join_type is JoinType.LEFT:
        result = concat([pairs_table(), unmatched_build()])
    elif join_type is JoinType.RIGHT:
        result = concat([pairs_table(), unmatched_probe()])
    elif join_type is JoinType.FULL:
        result = concat([pairs_table(), unmatched_build(), unmatched_probe()])
    elif join_type is JoinType.LEFT_SEMI:
        result = filter_rows(build, build_in() & visited, chain)
    elif join_type is JoinType.LEFT_ANTI:
        result = filter_rows(build, build_in() & ~visited, chain)
    elif join_type is JoinType.RIGHT_SEMI:
        result = filter_rows(probe, probe_in() & probe_matched, chain)
    else:
        result = filter_rows(probe, probe_in() & ~probe_matched, chain)
    if return_visited:
        return result, total, visited
    return result, total
