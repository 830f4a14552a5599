"""Vectorized hash join (torch): the INNER join on the CSR strategy.

Counterpart of `datafusion_parallelism_tpu/ops/join.py`, restricted to its
deferred-materialization INNER path (JAX ops/join.py:255-320 and :393-416):
only the key words, the validity word and the row id travel through the
candidate stage, and full rows are gathered once, at the matches. The chain
is four kernels:

  K1 hash_slot       row hash and bucket of both sides
  K2 csr_build       CSR table + the build's narrow rows in bucket order
  K3 probe_expand    candidate ranges, candidate pairs, key recheck
  K4 compact_gather  stable compaction + full packed-row gather

Each wrapper launches its CUDA kernel on CUDA tensors and runs its plain
torch version on CPU tensors. Any input outside the slice raises
NotImplementedError naming the ROADMAP item that will port it.
"""

from __future__ import annotations

import enum
from typing import Callable, List, NamedTuple

import torch

from ..kernels import compact_gather as k4
from ..kernels import csr_build as k2
from ..kernels import hash_slot as k1
from ..kernels import probe_expand as k3
from ..utils.columnar import (DeviceTable, Kind, PackedTable, Schema, f64_matrix,
                              hstack_tables, pack_table, unpack_table)
from .hash_table import JoinStrategy, table_size_for
from .hashing import KIND_I32, KIND_I64


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


def _field_info(layout):
    """name -> (kind, first word slot, word count, validity word row, bit)."""
    info = {}
    for j, (name, kind, slot, n) in enumerate(layout.fields):
        info[name] = (kind, slot, n, layout.valid_base + j // 32, j % 32)
    return info


def _defer_key_plan(blayout, playout, build_keys, probe_keys):
    """Word-row plan for the deferred probe path: which packed rows to
    gather at candidate positions for the key recheck, and how to compare
    them. None when bit-equality of packed words is not equivalent to the
    value recheck (float keys: ±0.0; mixed-width keys: value promotion)."""
    binfo, pinfo = _field_info(blayout), _field_info(playout)
    brows, prows = [], []   # packed row ids to gather, de-duplicated

    def row_of(rows, r):
        if r not in rows:
            rows.append(r)
        return rows.index(r)

    compares = []   # (b word idxs, p word idxs, b vword/bit, p vword/bit)
    for bk, pk in zip(build_keys, probe_keys):
        kb, sb, nb, vwb, bb = binfo[bk]
        kp, sp, np_, vwp, bp = pinfo[pk]
        if (nb != np_ or nb == 0
                or kb in (Kind.FLOAT64, Kind.FLOAT32)
                or kp in (Kind.FLOAT64, Kind.FLOAT32)):
            return None
        bw = [row_of(brows, sb + i) for i in range(nb)]
        pw = [row_of(prows, sp + i) for i in range(nb)]
        compares.append((bw, pw, (row_of(brows, vwb), bb),
                         (row_of(prows, vwp), bp)))
    return brows, prows, compares


class JoinKernels(NamedTuple):
    """The four stages of the slice, as functions with the kernels'
    contracts."""
    hash_slot: Callable
    csr_build: Callable
    probe_expand: Callable
    compact_gather: Callable


# the wrappers: kernels on CUDA tensors, plain versions on CPU tensors
KERNELS = JoinKernels(k1.hash_slot, k2.csr_build, k3.probe_expand, k4.compact_gather)
# the plain versions on any device: the reference the kernel path is held to
PLAIN = JoinKernels(k1.hash_slot_plain, k2.csr_build_plain, k3.probe_expand_plain,
                    k4.compact_gather_plain)


def _hash_cols(compares, side: int):
    """K1's key columns over one side's narrow rows, from the recheck plan:
    a one-word key hashes as int32, a two-word key as int64 (float keys
    never reach the plan)."""
    return [(KIND_I32 if len(c[side]) == 1 else KIND_I64, tuple(c[side]), c[2 + side])
            for c in compares]


def _word_rows(pt: PackedTable, rows: List[int]) -> torch.Tensor:
    """The packed word rows `rows` as one [len(rows), cap] matrix. Row views
    and a stack: indexing with a Python list would copy the index to the
    device and wait for it."""
    return torch.stack([pt.packed[r] for r in rows])


def inner_csr_join(build: DeviceTable, probe: DeviceTable, build_keys: List[str],
                   probe_keys: List[str], out_cap: int,
                   kernels: JoinKernels = KERNELS):
    """The slice's chain K1 -> K2 -> K3 -> K4 through `kernels`.

    Returns (table, candidate_total): the build columns then the probe
    columns, capacity out_cap, num_rows = min(matches, out_cap). The
    caller must check candidate_total <= out_cap and retry with a larger
    out_cap otherwise."""
    if len(build_keys) != len(probe_keys) or not build_keys:
        raise ValueError("join needs the same number (>= 1) of keys on both sides")
    if set(build.schema.names) & set(probe.schema.names):
        raise ValueError("join inputs must have disjoint column names")
    bp, pp = pack_table(build), pack_table(probe)
    plan = _defer_key_plan(bp.layout, pp.layout, build_keys, probe_keys)
    if plan is None:
        raise NotImplementedError(
            "float or mixed-width join keys take the full-fetch path "
            "(ROADMAP queue 1 item 6)")
    brows, prows, compares = plan
    T = table_size_for(build.capacity)

    bnarrow = _word_rows(bp, brows)
    _, bslot = kernels.hash_slot(bnarrow, _hash_cols(compares, 0), T, build.num_rows)
    _, _, _, start_count, bsorted = kernels.csr_build(bslot, T, bnarrow)

    pnarrow = _word_rows(pp, prows)
    _, pslot = kernels.hash_slot(pnarrow, _hash_cols(compares, 1), T)
    ok = probe.row_mask() & _keys_valid(probe, probe_keys)
    *_, total, match, probe_idx, build_id = kernels.probe_expand(
        pslot, ok, start_count, pnarrow, bsorted, compares, out_cap)

    out_b, out_bf, out_p, out_pf, n_match = kernels.compact_gather(
        match, build_id, probe_idx, bp.packed, f64_matrix(bp), pp.packed, f64_matrix(pp))
    n = n_match.to(torch.int32)
    bt = unpack_table(PackedTable(out_b, dict(zip(bp.layout.f64_fields, out_bf)), bp.layout),
                      build.schema, n)
    pt = unpack_table(PackedTable(out_p, dict(zip(pp.layout.f64_fields, out_pf)), pp.layout),
                      probe.schema, n)
    return hstack_tables(bt, pt, n), total


def hash_join(build: DeviceTable, probe: DeviceTable,
              build_keys: List[str], probe_keys: List[str],
              join_type: JoinType, out_cap: int,
              strategy: JoinStrategy = JoinStrategy.CSR,
              residual=None, prepared=None, expanded: bool = False,
              build_valid=None, probe_valid=None, return_visited: bool = False):
    """Join two device tables; the JAX package's signature.

    Ported: INNER on the CSR strategy with non-float keys of the same width
    on both sides (int32, date32, string codes, int64, decimal). Returns
    (result, candidate_total); the caller checks candidate_total <= out_cap
    and retries with a larger out_cap otherwise."""
    if join_type is not JoinType.INNER:
        raise NotImplementedError(
            f"{join_type.name} joins are not ported (ROADMAP queue 1 item 6)")
    if strategy is not JoinStrategy.CSR:
        raise NotImplementedError(
            f"the {strategy.name} strategy is not ported (ROADMAP queue 1 item 11)")
    for name, value in (("residual", residual), ("prepared", prepared),
                        ("build_valid", build_valid), ("probe_valid", probe_valid)):
        if value is not None:
            raise NotImplementedError(f"{name}= is not ported (ROADMAP queue 1 item 6)")
    for name, value in (("expanded", expanded), ("return_visited", return_visited)):
        if value:
            raise NotImplementedError(f"{name}=True is not ported (ROADMAP queue 1 item 6)")
    return inner_csr_join(build, probe, build_keys, probe_keys, out_cap)
