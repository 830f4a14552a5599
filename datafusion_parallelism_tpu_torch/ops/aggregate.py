"""Hash aggregate (torch): grouping + per-group reductions.

Counterpart of `datafusion_parallelism_tpu/ops/aggregate.py`, with its
three paths and their outputs:

  * global (no group key): K8 direct_agg with one group;
  * direct (every key a dictionary code or bool, at most 64 groups): K8
    computes the group id from the codes and reduces per group;
  * sorted (anything else): rows sorted into group order by K6 radix_sort
    (on the key value for a one-word key; on the clamped K1 row hash plus
    the exact key words otherwise), gathered in that order by K5, then
    K7 segment_agg finds the group boundaries and reduces each group.

Every kernel is reached through `kernels` (kernels/chain.py). Groups
come out in the JAX package's order (code order on the direct
path, sorted-key order on the sorted path). `decompose_for_partial` and
`finish_partial` split an aggregate into per-chunk partials, their merge
and a finish (streamed and grace-partitioned execution fold chunks this
way): host-side spec rewriting around the operators above.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from ..kernels.chain import KERNELS, ChainKernels
from ..utils.columnar import (FLOAT64, INT64, DeviceTable, DType, Field, Kind, Schema,
                              filter_rows, int64_words, pack_table, unpack_table)
from .hashing import key_words


@dataclass(frozen=True)
class AggSpec:
    func: str                 # 'sum' | 'count' | 'count_star' | 'min' | 'max' | 'avg'
    input: Optional[str]      # input column name (None for count_star)
    output: str               # output column name


def _agg_output_dtype(func: str, in_dtype: Optional[DType]) -> DType:
    if func in ("count", "count_star"):
        return INT64
    if func == "avg":
        return FLOAT64
    if func == "sum":
        if in_dtype.kind in (Kind.INT32, Kind.INT64):
            return INT64
        if in_dtype.kind is Kind.DECIMAL:
            return in_dtype
        return FLOAT64 if in_dtype.kind is Kind.FLOAT64 else in_dtype
    return in_dtype  # min/max


def agg_output_schema(t_schema: Schema, group_keys: List[str],
                      aggs: List[AggSpec]) -> Schema:
    fields = [t_schema.field(k) for k in group_keys]
    for a in aggs:
        in_dt = t_schema.field(a.input).dtype if a.input else None
        nullable = a.func not in ("count", "count_star")
        fields.append(Field(a.output, _agg_output_dtype(a.func, in_dt), nullable))
    return Schema(fields)


def hash_aggregate(t: DeviceTable, group_keys: List[str], aggs: List[AggSpec],
                   out_cap: Optional[int] = None,
                   kernels: ChainKernels = KERNELS) -> DeviceTable:
    """Group + aggregate; the output capacity defaults to the input
    capacity, and `out_cap` shrinks it (the caller checks the count)."""
    return hash_aggregate_counted(t, group_keys, aggs, out_cap, None, kernels)[0]


# the direct path takes keys whose code domains multiply to at most this
_DIRECT_MAX_GROUPS = 64


def _direct_domains(schema: Schema, group_keys: List[str]) -> Optional[List[int]]:
    """Per-key code domains when EVERY group key is dictionary- or
    bool-encoded and the group-id space stays tiny; None otherwise. Domain d
    means codes in [0, d); slot d encodes NULL."""
    doms = []
    total = 1
    for k in group_keys:
        f = schema.field(k)
        if f.dtype.kind is Kind.STRING and f.dictionary is not None:
            doms.append(len(f.dictionary.values))
        elif f.dtype.kind is Kind.BOOL:
            doms.append(2)
        else:
            return None
        total *= doms[-1] + 1
        if total > _DIRECT_MAX_GROUPS:
            return None
    return doms


def _resize_cols(cols, out_schema: Schema, G: int, out_cap: int):
    """Pad or slice [G] columns to the caller's out_cap capacity."""
    out = {}
    for f in out_schema.fields:
        v, valid = cols[f.name]
        if out_cap > G:
            v = torch.cat([v, v.new_zeros(out_cap - G)])
            valid = torch.cat([valid, valid.new_zeros(out_cap - G)])
        elif out_cap < G:
            v, valid = v[:out_cap], valid[:out_cap]
        out[f.name] = (v, valid)
    return out


def _requests(aggs: List[AggSpec], column):
    """The kernels' aggregate requests for `aggs` over `column(name)`: one
    count of valid rows per input column, and one sum/min/max per
    aggregate that needs it. Returns (requests, [(main, count) index pair
    or None for count_star, per aggregate])."""
    reqs, count_of, plan = [], {}, []
    for a in aggs:
        if a.func == "count_star":
            plan.append(None)
            continue
        if a.func not in ("count", "sum", "avg", "min", "max"):
            raise ValueError(a.func)
        sv, svalid = column(a.input)
        if a.input not in count_of:
            count_of[a.input] = len(reqs)
            reqs.append(("count", sv, svalid))
        main = None
        if a.func != "count":
            main = len(reqs)
            reqs.append(("sum" if a.func == "avg" else a.func, sv, svalid))
        plan.append((main, count_of[a.input]))
    return reqs, plan


def _agg_columns(t_schema: Schema, out_schema: Schema, aggs: List[AggSpec], plan,
                 results, rowcount: torch.Tensor, exists: torch.Tensor):
    """Output columns of the aggregates from the kernels' results, as the
    JAX package builds them: counts valid where the group exists, the rest
    where it also has a valid input row; AVG divides in float64 (and by
    10**scale for decimals)."""
    cols = {}
    for a, p in zip(aggs, plan):
        if p is None:
            cols[a.output] = (rowcount, exists)
            continue
        main, cnt_i = p
        cnt = results[cnt_i]
        if a.func == "count":
            cols[a.output] = (cnt, exists)
            continue
        ok = exists & (cnt > 0)
        out_dt = out_schema.field(a.output).dtype
        if a.func == "avg":
            v = results[main].to(torch.float64) / torch.clamp(cnt, min=1)
            in_dt = t_schema.field(a.input).dtype
            if in_dt.kind is Kind.DECIMAL:
                v = v / (10.0 ** in_dt.scale)
            cols[a.output] = (v, ok)
        else:
            cols[a.output] = (results[main].to(out_dt.device_dtype), ok)
    return cols


def _direct_aggregate(t: DeviceTable, group_keys: List[str], aggs: List[AggSpec],
                      doms: List[int], out_cap: int, out_schema: Schema, row_filter,
                      kernels: ChainKernels):
    """Perfect grouping over static code domains through K8; group order is
    gid order == dictionary code order."""
    G = 1
    for d in doms:
        G *= d + 1
    reqs, plan = _requests(aggs, t.column)
    rowcount, results = kernels.direct_agg([t.column(k) for k in group_keys], doms,
                                           t.num_rows, row_filter, reqs, t.capacity)
    exists = rowcount > 0
    n_groups = exists.sum(dtype=torch.int32)

    cols = {}
    # group key values decode arithmetically from the group id
    rem = torch.arange(G, dtype=torch.int32, device=t.device)
    for k, d in zip(reversed(group_keys), reversed(doms)):
        code = rem % (d + 1)
        rem = rem // (d + 1)
        kvalid = exists & (code != d)
        if t.schema.field(k).dtype.kind is Kind.BOOL:
            cols[k] = (code == 1, kvalid)
        else:  # dictionary codes; clamp the NULL slot so host decode is safe
            cols[k] = (torch.clamp(code, 0, max(d - 1, 0)), kvalid)
    cols.update(_agg_columns(t.schema, out_schema, aggs, plan, results, rowcount, exists))

    # compact existing groups to the front (G is tiny), then match the
    # caller's output capacity
    out = filter_rows(DeviceTable(out_schema, cols, torch.tensor(G, dtype=torch.int32,
                                                                 device=t.device)), exists,
                      kernels)
    kept = torch.clamp(n_groups, max=out_cap)
    return DeviceTable(out_schema, _resize_cols(out.columns, out_schema, G, out_cap),
                       kept), n_groups


def _single_word_key(t: DeviceTable, group_keys: List[str]):
    """(int32 word, validity) when the whole group key is ONE int32 word
    (int32/date32/dictionary code/bool), else None: such keys sort by value,
    exact by definition."""
    if len(group_keys) != 1:
        return None
    kind = t.schema.field(group_keys[0]).dtype.kind
    if kind not in (Kind.INT32, Kind.DATE32, Kind.STRING, Kind.BOOL):
        return None
    v, valid = t.column(group_keys[0])
    return v.to(torch.int32), valid


def _exact_key_operands(t: DeviceTable, group_keys: List[str]) -> List[torch.Tensor]:
    """Extra sort operands that make the grouping sort exact under 32-bit
    hash collisions: the key's canonical value words (-0.0 as 0.0, zero
    where NULL) plus ONE validity word over the key columns."""
    ops = []
    kv_word = torch.zeros(t.capacity, dtype=torch.int64, device=t.device)
    for i, k in enumerate(group_keys):
        v, valid = t.column(k)
        kind = t.schema.field(k).dtype.kind
        if kind is Kind.FLOAT32:
            words = [torch.where(v == 0, 0.0, v).to(torch.float32).view(torch.int32)]
        elif kind is Kind.FLOAT64:
            words = list(int64_words(torch.where(v == 0, 0.0, v).view(torch.int64)))
        elif kind in (Kind.INT64, Kind.DECIMAL):
            words = list(int64_words(v))
        else:
            words = [v.to(torch.int32)]
        ops += [torch.where(valid, w, 0) for w in words]
        kv_word = kv_word | (valid.to(torch.int64) << (i % 32))
    ops.append(kv_word.to(torch.int32))
    return ops


def _grouping_perm(t: DeviceTable, group_keys: List[str], in_row: torch.Tensor,
                   kernels: ChainKernels):
    """The stable permutation that brings the rows into group order (rows
    outside in_row last), through K6, as the JAX package's lax.sort."""
    single = _single_word_key(t, group_keys)
    if single is not None:
        # valid / NULL / outside zones, then the value
        word, kvalid = single
        zone = torch.where(in_row, torch.where(kvalid, 0, 1), 2).to(torch.int32)
        return kernels.radix_sort(torch.stack([zone, word]), [True, True])
    # the uint32 row hash (hashing.hash_rows, by K1) clamped to 0xFFFFFFFE,
    # biased to a signed int32, INT32_MAX for rows outside; then the exact
    # key words
    h = kernels.hash_slot(*key_words([t.column(k) for k in group_keys]))[0].long() & 0xFFFFFFFF
    biased = (torch.clamp(h, max=0xFFFFFFFE) ^ 0x80000000).to(torch.int32)
    sort_key = torch.where(in_row, biased, 0x7FFFFFFF).to(torch.int32)
    ops = [sort_key] + _exact_key_operands(t, group_keys)
    return kernels.radix_sort(torch.stack(ops), [True] * len(ops))


def hash_aggregate_counted(t: DeviceTable, group_keys: List[str], aggs: List[AggSpec],
                           out_cap: Optional[int] = None, row_filter=None,
                           kernels: ChainKernels = KERNELS):
    """-> (table, true group count); the count may exceed the output
    capacity. row_filter: optional bool[cap] mask fused into the aggregate
    (a filter under an aggregate needs no compaction of its own)."""
    cap = t.capacity
    out_schema = agg_output_schema(t.schema, group_keys, aggs)
    if not group_keys:
        g = _global_aggregate(t, aggs, out_schema, row_filter, kernels)
        return g, g.num_rows
    if out_cap is None or out_cap > cap:
        out_cap = cap
    doms = _direct_domains(t.schema, group_keys)
    if doms is not None:
        return _direct_aggregate(t, group_keys, aggs, doms, out_cap, out_schema, row_filter,
                                 kernels)

    in_row = t.row_mask()
    if row_filter is not None:
        # rows outside the filter sort past the valid prefix
        in_row = in_row & row_filter
    perm = _grouping_perm(t, group_keys, in_row, kernels)
    n_valid = in_row.sum(dtype=torch.int32)
    # the table in group order, by ONE packed row gather (K5); rows at or
    # past n_valid (outside the filter) become zeros unread: K7 reads the
    # first n_valid rows and the representatives' gather below them
    g_ = pack_table(t, kernels).take_rows(perm, n_valid, kernels)
    st = unpack_table(g_, t.schema, t.num_rows, kernels)
    words, key_cols = key_words([st.column(k) for k in group_keys])
    reqs, plan = _requests(aggs, st.column)
    starts, sizes, results, n_groups = kernels.segment_agg(words, key_cols, n_valid, reqs,
                                                           out_cap)
    kept = torch.clamp(n_groups, max=out_cap)
    ok = torch.arange(out_cap, dtype=torch.int32, device=t.device) < kept
    # group key values: the first sorted row of each group, by ONE K5 gather
    rep = unpack_table(g_.take_rows(starts, kept, kernels), t.schema, kept, kernels)
    cols = {k: (rep.columns[k][0], rep.columns[k][1] & ok) for k in group_keys}
    cols.update(_agg_columns(t.schema, out_schema, aggs, plan, results, sizes, ok))
    return DeviceTable(out_schema, cols, kept), n_groups


def _global_aggregate(t: DeviceTable, aggs: List[AggSpec], out_schema: Schema,
                      row_filter, kernels: ChainKernels) -> DeviceTable:
    """One output row through K8 with no group key (G = 1); counts are
    always valid, the rest valid where a valid input row exists."""
    reqs, plan = _requests(aggs, t.column)
    rowcount, results = kernels.direct_agg([], [], t.num_rows, row_filter, reqs, t.capacity)
    always = torch.ones(1, dtype=torch.bool, device=t.device)
    cols = _agg_columns(t.schema, out_schema, aggs, plan, results, rowcount, always)
    return DeviceTable(out_schema, cols, torch.tensor(1, dtype=torch.int32, device=t.device))


def decompose_for_partial(aggs: List[AggSpec]):
    """Two-phase aggregation plan: AVG is not mergeable, so it decomposes
    into SUM + COUNT partials merged by SUM and finished by a divide.
    Returns (partial_specs, merge_specs, finishers) where finishers maps
    each original output to how the merged columns finish it."""
    partial: List[AggSpec] = []
    merge: List[AggSpec] = []
    finishers = []
    for i, a in enumerate(aggs):
        if a.func == "avg":
            s, c = f"__ps{i}", f"__pc{i}"
            partial += [AggSpec("sum", a.input, s), AggSpec("count", a.input, c)]
            merge += [AggSpec("sum", s, s), AggSpec("sum", c, c)]
            finishers.append((a, ("avg", s, c)))
        elif a.func in ("count", "count_star"):
            p = f"__p{i}"
            partial.append(AggSpec(a.func, a.input, p))
            merge.append(AggSpec("sum", p, p))
            finishers.append((a, ("col", p)))
        elif a.func in ("sum", "min", "max"):
            p = f"__p{i}"
            partial.append(AggSpec(a.func, a.input, p))
            merge.append(AggSpec(a.func, p, p))
            finishers.append((a, ("col", p)))
        else:
            raise ValueError(a.func)
    return partial, merge, finishers


def finish_partial(t: DeviceTable, group_keys: List[str], aggs: List[AggSpec],
                   finishers, in_schema: Schema) -> DeviceTable:
    """Apply finishers after the merge aggregate, restoring the exact
    single-pass output schema."""
    out_schema = agg_output_schema(in_schema, group_keys, aggs)
    cols = {k: t.columns[k] for k in group_keys}
    for a, fin in finishers:
        out_dt = out_schema.field(a.output).dtype
        if fin[0] == "col":
            v, valid = t.columns[fin[1]]
            cols[a.output] = (v.to(out_dt.device_dtype), valid)
        else:  # avg = sum / count
            _, s_name, c_name = fin
            s, svalid = t.columns[s_name]
            c, _ = t.columns[c_name]
            v = s.to(torch.float64) / torch.clamp(c, min=1)
            if a.input is not None and in_schema.field(a.input).dtype.kind is Kind.DECIMAL:
                v = v / (10.0 ** in_schema.field(a.input).dtype.scale)
            cols[a.output] = (v, svalid & (c > 0))
    return DeviceTable(out_schema, cols, t.num_rows)
