"""Distributed query executor (torch): the physical plan over P partitions.

Counterpart of the JAX package's `runtime/distributed_executor.py`, which
runs the plan as one SPMD program under `shard_map`. The port runs it
eagerly over the local shards of an Exchange (parallel/exchange.py; all P
in process, or several in each process of a group): every operator loops
over the shards this process holds, one DeviceTable each,
and the collectives go through the Exchange (`lax.psum(1)` is `ex.P`,
`lax.axis_index` `ex.ranks[k]`, `lax.pmax` / `lax.psum` its all_reduce,
`_all_gather_table` parallel.shuffle.all_gather_table):

  * scans read per-partition row shards of the registered tables (their
    live columns, as the single-device executor uploads them);
  * every hash join shuffles both children by key hash, then runs the
    single-device join on its key range, in one of the optimizer's modes
    (models/optimizer.py ChooseDistModeRule): partitioned, broadcast (the
    build all-gathered) or skew_salted (heavy build rows replicated, heavy
    probe rows kept). A build-emitting join (LEFT, FULL, LEFT_SEMI,
    LEFT_ANTI) over a replicated build dedups it: the visited masks
    OR-reduced over the partitions, each deferred build row emitted by one
    owner (row index mod P);
  * aggregates run two-phase: a local partial, the partials shuffled by
    group key and merged, then finished (AVG as SUM + COUNT); a pure
    DISTINCT dedups locally first;
  * a root ORDER BY sorts each shard and merges on the host at collection;
    ORDER BY + LIMIT k gathers only each shard's top k; any other ORDER BY
    all-gathers and keeps the rows on partition 0.

Capacities follow the JAX package's rules number for number: the
per-destination send blocks (4x the balanced share, seeded from the
probe's hot-key share when salting is off, doubled while rows drop), the
join and aggregate capacities seeded from the planner's estimates, grown
to fit and shrunk (deferred, 64x a step) after a run. Each run reads all
its totals and the per-partition candidate totals in one host sync.
Multi-join plans over large inputs run staged, one join a stage, each
stage's output kept on the devices for the next. Where the biggest scan
passes the out-of-core thresholds and every partition is in this
process, the scan streams through the partitions in chunks against
frozen per-partition builds (runtime/distributed_streaming.py): the hooks
here are a join's frozen build (`ctx.prepared`: only the probe moves),
a streamed build-emitting join's per-partition visited fold
(`_dist_stream_chunk_join`) and the merge point's finished aggregate
(`ctx.materialized`).

In process, an all-gather hands every local shard the same tensors: the
replicated sides are read, never written in place (a write on one replica
would reach every shard).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..models.physical import (ExecContext, PAggregate, PFilter, PHashJoin, PLimit,
                               PProject, PScan, PSort, PhysicalPlan, _expandable_join,
                               find_joins)
from ..ops.aggregate import (decompose_for_partial, finish_partial, hash_aggregate,
                             hash_aggregate_counted)
from ..ops.expressions import evaluate, predicate_mask
from ..ops.filter import filter_table
from ..ops.join import JoinType, hash_join
from ..ops.project import project_table
from ..ops.sort import host_sort_table, limit_table, sort_table
from ..parallel.exchange import Exchange, get_comm_bytes, reset_comm_bytes
from ..parallel.mesh import make_mesh
from ..parallel.shuffle import (_hashes, all_gather_table, gather_shards, local_shards,
                                partition_table, replicating_shuffle, shuffle_by_hash)
from ..parallel.skew import build_replication_mask, heavy_buckets, key_histogram
from ..utils.columnar import (DeviceTable, HostTable, Schema, compact_rows, concat_tables,
                              filter_rows, hstack_tables, null_columns_like, pack_table,
                              round_capacity, unpack_table)
from .executor import QueryHandle, _debug_retry
from .streaming import plan_stream

Shards = List[DeviceTable]
Masks = Optional[List[torch.Tensor]]

# build-emitting joins whose build side is replicated run their probe-linear
# part as these types and emit the deferred build rows by owner
_PAIRS_TYPE = {JoinType.LEFT: JoinType.INNER, JoinType.FULL: JoinType.RIGHT}
_BUILD_EMITTING = (JoinType.LEFT, JoinType.FULL, JoinType.LEFT_SEMI, JoinType.LEFT_ANTI)


def _pmax(ex: Exchange, xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The max over the partitions of one int scalar a shard."""
    return ex.all_reduce([x.reshape(()).to(torch.int64) for x in xs], "max")[0]


def _on_rank_0(ex: Exchange, shards: Shards) -> Shards:
    """Replicated results kept once: every shard but partition 0's reads
    empty (a new row count; the columns stay shared and unwritten)."""
    return [t if r == 0 else DeviceTable(t.schema, t.columns, torch.zeros_like(t.num_rows))
            for r, t in zip(ex.ranks, shards)]


def _owner(ex: Exchange, k: int, cap: int, device) -> torch.Tensor:
    """bool [cap]: the rows of a replicated block local shard k emits
    (row index mod P == its partition)."""
    return (torch.arange(cap, dtype=torch.int32, device=device) % ex.P) == ex.ranks[k]


def _visited_anywhere(ex: Exchange, vis: Sequence[torch.Tensor]) -> torch.Tensor:
    """The OR over the partitions of the visited masks of identical
    replicas (a sum of their ints)."""
    return ex.all_reduce([v.to(torch.int32) for v in vis], "sum")[0] > 0


def _shrink_table(t: DeviceTable, cap: int) -> DeviceTable:
    """The table's leading `cap` rows as a smaller capacity (views; rows
    past num_rows are padding either way)."""
    if cap >= t.capacity:
        return t
    cols = {n: (v[:cap], valid[:cap]) for n, (v, valid) in t.columns.items()}
    return DeviceTable(t.schema, cols, torch.clamp(t.num_rows, max=cap))


def _compact_masked(t: DeviceTable, mask, chain) -> DeviceTable:
    """A late-materialized (table, mask) pair compacted (K5), where the
    consumer cannot fold the mask (the broadcast all-gather)."""
    if mask is None:
        return t
    return filter_rows(t, t.row_mask() & mask, chain)


def _project(shards: Shards, projs, ctx) -> Shards:
    for pr in reversed(projs):
        shards = [project_table(t, pr.exprs, pr.out_fields, ctx.chain) for t in shards]
    return shards


def _dist_maybe_expanded(node: PhysicalPlan, tables, ctx, ex) -> Tuple[Shards, Masks]:
    """(shards, masks | None): `node` late-materialized where it is an
    expandable join, through any PProject chain (projections are row-aligned,
    so they commute with the mask)."""
    projs = []
    n = node
    while isinstance(n, PProject):
        projs.append(n)
        n = n.child
    if _expandable_join(n, ctx):
        t, mask = _dist_join(n, tables, ctx, ex, expanded=True)
        return _project(t, projs, ctx), mask
    return execute_dist(node, tables, ctx, ex), None


def _join_cap(node: PHashJoin, ctx, P: int, b2: DeviceTable, p2: DeviceTable) -> int:
    """The local join's candidate capacity: the planner's estimate, a
    partition's share with 4x skew headroom, clamped to 4x the inputs (else
    twice the larger input)."""
    cap = ctx.join_caps.get(node.join_id)
    if cap is None:
        if node.est_rows > 0:
            per_dev = max(1, int(4 * node.est_rows) // max(P, 1))
            cap = min(round_capacity(per_dev, minimum=1024),
                      4 * max(256, b2.capacity, p2.capacity))
        else:
            cap = max(256, 2 * max(b2.capacity, p2.capacity))
        ctx.join_caps[node.join_id] = cap
    return cap


def _residual_fn(node: PHashJoin, ctx):
    if node.residual is None:
        return None
    res = node.residual

    def residual_fn(pair_tbl):
        return evaluate([res], pair_tbl, ctx.chain)[0][:2]
    return residual_fn


def _local_joins(node: PHashJoin, b2: Shards, p2: Shards, cap: int, ctx, join_type=None,
                 **kw) -> list:
    """The single-device hash_join on every local shard's key range."""
    build_valid = kw.pop("build_valid", None) or [None] * len(p2)
    probe_valid = kw.pop("probe_valid", None) or [None] * len(p2)
    prepared = kw.pop("prepared", None) or [None] * len(p2)
    return [hash_join(bk, pk, node.build_keys, node.probe_keys, join_type or node.join_type, cap,
                      strategy=node.strategy, residual=_residual_fn(node, ctx),
                      build_valid=bv, probe_valid=pv, prepared=pb, kernels=ctx.kernels,
                      chain=ctx.chain, **kw)
            for bk, pk, bv, pv, pb in zip(b2, p2, build_valid, probe_valid, prepared)]


def _send_cap(node: PHashJoin, ctx, P: int, tag: str, t: DeviceTable,
              salted_share: bool = False) -> int:
    """The (join_id, tag) per-destination send block: ~4x the balanced
    share, raised to the planner's probe hot-key share (a hot key lands its
    rows on one destination) unless the join is salted and `salted_share`
    is off; dropped rows double it on retry, and a shard's capacity can
    never drop one. The streamed chunk join raises it under salting too,
    as the JAX package's does."""
    key = (node.join_id, tag)
    cap = ctx.join_caps.get(key)
    if cap is None:
        cap = max(1024, 4 * (t.capacity // max(P, 1)))
        share = (node.probe_mcv_share
                 if tag == "ps" and (salted_share or node.dist_mode != "skew_salted") else 0.0)
        if share > 0:
            cap = max(cap, round_capacity(int(1.3 * share * t.capacity), minimum=1024))
        cap = min(t.capacity, cap)
        ctx.join_caps[key] = cap
    return cap


def _dist_join(node: PHashJoin, tables, ctx, ex, expanded: bool = False):
    """Distributed hash join: both children shuffled (any late-materialized
    mask folded into the routing: masked rows are never sent), then the
    single-device join on the local key range. expanded=True returns
    (uncompacted shards, masks) for the consumer to fold.

    Streaming: a frozen build (`ctx.prepared[join_id]`, one PreparedBuild a
    local shard, already on its key range) is neither run nor shuffled,
    whatever the join's mode: only the probe moves. A join under
    `ctx.stream_visited` runs chunk-wise (`_dist_stream_chunk_join`)."""
    prepared = ctx.prepared.get(node.join_id)
    if node.join_id in ctx.stream_visited:
        assert prepared is not None, "a streamed join needs a frozen build"
        return _dist_stream_chunk_join(node, prepared, tables, ctx, ex, expanded)
    b = b_mask = None
    if prepared is None:
        b, b_mask = _dist_maybe_expanded(node.build, tables, ctx, ex)
    p, p_mask = _dist_maybe_expanded(node.probe, tables, ctx, ex)
    P = ex.P

    def send_cap(tag, t):
        return _send_cap(node, ctx, P, tag, t)

    if (node.dist_mode == "skew_salted" and prepared is None
            and node.join_type in _BUILD_EMITTING):
        return _salted_build_emitting(node, b, b_mask, p, p_mask, send_cap, ctx, ex, expanded)
    bdrop = pdrop = torch.zeros((), dtype=torch.int64, device=ex.device)
    p_valid = None   # the probe mask surviving INTO the local join
    if prepared is not None:
        b2 = [pb.build for pb in prepared]
        p2, pdrop = shuffle_by_hash(ex, p, node.probe_keys, send_cap("ps", p[0]), valid=p_mask)
    elif node.dist_mode == "broadcast":
        b2 = all_gather_table(ex, [_compact_masked(t, m, ctx.chain)
                                   for t, m in zip(b, b_mask or [None] * len(b))])
        p2, p_valid = p, p_mask
    elif node.dist_mode == "skew_salted":
        # each probe shard hashed once, for the histogram and the shuffle
        hashes = [_hashes(t, node.probe_keys) for t in p]
        heavy = heavy_buckets(key_histogram(ex, p, node.probe_keys, valid=p_mask,
                                            hashes=hashes))
        # replicated rows can land everywhere: the shard capacity, no drop
        b2, _ = replicating_shuffle(ex, b, node.build_keys, b[0].capacity, valid=b_mask,
                                    heavy=heavy)
        p2, pdrop = shuffle_by_hash(ex, p, node.probe_keys, send_cap("ps", p[0]), heavy=heavy,
                                    valid=p_mask, hashes=hashes)
    else:
        b2, bdrop = shuffle_by_hash(ex, b, node.build_keys, send_cap("bs", b[0]), valid=b_mask)
        p2, pdrop = shuffle_by_hash(ex, p, node.probe_keys, send_cap("ps", p[0]), valid=p_mask)
    del b, p, b_mask
    ctx.join_totals[(node.join_id, "bs")] = bdrop
    ctx.join_totals[(node.join_id, "ps")] = pdrop
    cap = _join_cap(node, ctx, P, b2[0], p2[0])
    if (node.dist_mode == "broadcast" and prepared is None
            and node.join_type in _BUILD_EMITTING):
        return _broadcast_build_emitting(node, b2, p2, p_valid, cap, expanded, ctx, ex)
    results = _local_joins(node, b2, p2, cap, ctx, expanded=expanded, probe_valid=p_valid,
                           prepared=prepared)
    totals = [r[-1] for r in results]
    ctx.join_totals[node.join_id] = _pmax(ex, totals)
    # the LOCAL candidate totals: the work-balance proxy
    ctx.join_balance[node.join_id] = totals
    if expanded:
        return [r[0] for r in results], [r[1] for r in results]
    return [r[0] for r in results]


def _emit_build_side(node: PHashJoin, b2: Shards, emit_in, vis_all, pairs, p2: Shards,
                     expanded: bool, ctx):
    """The deferred build-side output of a build-emitting join over
    replicated build rows: per shard, the rows it owns (`emit_in`) that
    were visited anywhere (`vis_all`; LEFT_SEMI) or nowhere (LEFT_ANTI, and
    the unmatched rows appended to the pairs of LEFT and FULL)."""
    if node.join_type in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
        semi = node.join_type is JoinType.LEFT_SEMI
        masks = [e & (v if semi else ~v) for e, v in zip(emit_in, vis_all)]
        if expanded:
            return b2, masks
        return [filter_rows(t, m, ctx.chain) for t, m in zip(b2, masks)]
    assert not expanded                      # LEFT/FULL are not expandable
    out = []
    for t, e, v, pr, pk in zip(b2, emit_in, vis_all, pairs, p2):
        ub = filter_rows(t, e & ~v, ctx.chain)
        nulls = DeviceTable(pk.schema, null_columns_like(pk.schema, ub.capacity,
                                                         device=ub.device), ub.num_rows)
        out.append(concat_tables([pr, hstack_tables(ub, nulls, ub.num_rows)],
                                 ctx.kernels.concat_rows, ctx.chain))
    return out


def _replicated_join(node: PHashJoin, b2: Shards, p2: Shards, cap: int, ctx, **kw):
    """The local joins of a build-emitting join over a replicated build:
    (the pairs per shard (None for LEFT_SEMI / LEFT_ANTI), the local
    candidate totals, the visited masks). LEFT and FULL emit their
    probe-linear part (INNER / RIGHT), the semi and anti types only fold
    their visited masks (expanded, gather-free)."""
    pairs_type = _PAIRS_TYPE.get(node.join_type)
    if pairs_type is not None:
        results = _local_joins(node, b2, p2, cap, ctx, pairs_type, return_visited=True, **kw)
        return [r[0] for r in results], [r[1] for r in results], [r[2] for r in results]
    results = _local_joins(node, b2, p2, cap, ctx, expanded=True, return_visited=True, **kw)
    return [None] * len(results), [r[2] for r in results], [r[3] for r in results]


def _salted_build_emitting(node: PHashJoin, b: Shards, b_mask: Masks, p: Shards,
                           p_mask: Masks, send_cap, ctx, ex, expanded: bool):
    """skew_salted for build-emitting joins (LEFT, FULL, LEFT_SEMI,
    LEFT_ANTI). Light build rows (outside the heavy hash buckets) shuffle to
    their key's partition, as every probe row of their keys does, so their
    visited flags are exact locally. Heavy build rows are compacted and
    all-gathered into one block, identical on every partition and appended
    at a fixed offset after the light shard, so the visited masks of the
    block OR-reduce position by position over the partitions and each of
    its deferred rows is emitted by one owner (index mod P). Heavy probe
    rows stay on their partition."""
    P = ex.P
    hashes = [_hashes(t, node.probe_keys) for t in p]
    heavy = heavy_buckets(key_histogram(ex, p, node.probe_keys, valid=p_mask, hashes=hashes))
    rep = build_replication_mask(b, node.build_keys, heavy, valid=b_mask)
    in_b = [t.row_mask() if m is None else t.row_mask() & m
            for t, m in zip(b, b_mask or [None] * len(b))]
    b_light, bdrop = shuffle_by_hash(ex, b, node.build_keys, send_cap("bs", b[0]),
                                     valid=[i & ~r for i, r in zip(in_b, rep)])
    hv_key = (node.join_id, "hv")
    hcap = ctx.join_caps.get(hv_key)
    if hcap is None:
        # heavy rows are the hot-key subset: small unless the build is itself
        # skewed; the dropped-row retry owns the rest
        hcap = max(1024, round_capacity(b[0].capacity // 64, minimum=1024))
        ctx.join_caps[hv_key] = hcap
    hcap = min(hcap, b[0].capacity)   # a shard can't hold more than its rows
    heavy_local, hdrop = [], []
    for t, i, r in zip(b, in_b, rep):
        (hpt,), hn = compact_rows([pack_table(t, ctx.chain)], i & r, hcap, ctx.chain)
        heavy_local.append(unpack_table(hpt, t.schema, torch.clamp(hn, max=hcap), ctx.chain))
        hdrop.append(torch.clamp(hn - hcap, min=0))
    b_heavy = all_gather_table(ex, heavy_local)   # identical on every partition
    del b, rep, in_b, heavy_local
    light_cap, heavy_cap = b_light[0].capacity, b_heavy[0].capacity
    b2, b2_valid = [], []
    for lt, ht in zip(b_light, b_heavy):
        cols = {f.name: (torch.cat([lt.columns[f.name][0], ht.columns[f.name][0]]),
                         torch.cat([lt.columns[f.name][1], ht.columns[f.name][1]]))
                for f in lt.schema.fields}
        b2.append(DeviceTable(lt.schema, cols, torch.tensor(light_cap + heavy_cap,
                                                            dtype=torch.int32,
                                                            device=lt.device)))
        b2_valid.append(torch.cat([lt.row_mask(), ht.row_mask()]))
    p2, pdrop = shuffle_by_hash(ex, p, node.probe_keys, send_cap("ps", p[0]), heavy=heavy,
                                valid=p_mask, hashes=hashes)
    del p, p_mask, hashes
    ctx.join_totals[(node.join_id, "bs")] = bdrop
    ctx.join_totals[(node.join_id, "ps")] = pdrop
    ctx.join_totals[hv_key] = _pmax(ex, hdrop)

    cap = _join_cap(node, ctx, P, b2[0], p2[0])
    pairs, totals, vis = _replicated_join(node, b2, p2, cap, ctx, build_valid=b2_valid)
    vis_h = _visited_anywhere(ex, [v[light_cap:] for v in vis])
    emit_in, vis_all = [], []
    for k, (lt, ht, v) in enumerate(zip(b_light, b_heavy, vis)):
        emit_in.append(torch.cat([lt.row_mask(),
                                  ht.row_mask() & _owner(ex, k, heavy_cap, ht.device)]))
        vis_all.append(torch.cat([v[:light_cap], vis_h]))   # light: exact, local
    ctx.join_totals[node.join_id] = _pmax(ex, totals)
    ctx.join_balance[node.join_id] = totals
    return _emit_build_side(node, b2, emit_in, vis_all, pairs, p2, expanded, ctx)


def _broadcast_build_emitting(node: PHashJoin, b2: Shards, p2: Shards, p_valid: Masks,
                              cap: int, expanded: bool, ctx, ex):
    """broadcast for build-emitting joins: the replicated build probes each
    partition's own (unshuffled) probe shard, so a skewed probe key loads
    no one partition; the visited masks of the identical replicas OR-reduce
    over the partitions (the global visited bitset), and each deferred
    build row is emitted by one owner (row index mod P)."""
    pairs, totals, vis = _replicated_join(node, b2, p2, cap, ctx, probe_valid=p_valid)
    vis_global = _visited_anywhere(ex, vis)
    emit_in = [t.row_mask() & _owner(ex, k, t.capacity, t.device) for k, t in enumerate(b2)]
    ctx.join_totals[node.join_id] = _pmax(ex, totals)
    ctx.join_balance[node.join_id] = totals
    return _emit_build_side(node, b2, emit_in, [vis_global] * len(b2), pairs, p2, expanded,
                            ctx)


def _dist_stream_chunk_join(node: PHashJoin, prepared, tables, ctx, ex, expanded: bool) -> Shards:
    """One probe chunk of a build-emitting join (LEFT, FULL, LEFT_SEMI,
    LEFT_ANTI) streamed through the partitions: the chunk shuffled to the
    frozen build's key range, its probe-linear rows emitted (as
    PHashJoin._STREAM_CHUNK_TYPE maps the type; none for the semi and anti
    types), and each partition's matches ORed into its visited mask over
    its LOCAL build shard (hash partitioning puts each build row on one
    partition, so the local masks compose exactly). K10 accumulates into a
    copy of the incoming mask: a retried chunk starts again from the one it
    was given. The deferred build rows are the flush pass's
    (runtime/distributed_streaming.py)."""
    assert not expanded   # _expandable_join excludes streamed joins
    p, p_mask = _dist_maybe_expanded(node.probe, tables, ctx, ex)
    skey = (node.join_id, "ps")
    send_cap = _send_cap(node, ctx, ex.P, "ps", p[0], salted_share=True)
    p2, pdrop = shuffle_by_hash(ex, p, node.probe_keys, send_cap, valid=p_mask)
    del p, p_mask
    ctx.join_totals[skey] = pdrop
    cap = ctx.join_caps.get(node.join_id)
    if cap is None:
        cap = max(256, 2 * max(prepared[0].build.capacity, p2[0].capacity))
        ctx.join_caps[node.join_id] = cap
    chunk_type = PHashJoin._STREAM_CHUNK_TYPE.get(node.join_type)
    kw = dict(strategy=node.strategy, residual=_residual_fn(node, ctx), return_visited=True,
              kernels=ctx.kernels, chain=ctx.chain)
    outs, totals, vis_out = [], [], []
    for pb, pk, incoming in zip(prepared, p2, ctx.stream_visited[node.join_id]):
        vis = incoming.clone()
        if chunk_type is not None:            # LEFT / FULL: this chunk's pairs
            out, total, _ = hash_join(pb.build, pk, node.build_keys, node.probe_keys, chunk_type,
                                      cap, prepared=pb, visited_into=vis, **kw)
        else:                                 # LEFT_SEMI / LEFT_ANTI: the fold alone
            _, _, total, _ = hash_join(pb.build, pk, node.build_keys, node.probe_keys,
                                       node.join_type, cap, prepared=pb, expanded=True,
                                       visited_into=vis, **kw)
            out = DeviceTable(node.schema, null_columns_like(node.schema, 128, device=ex.device),
                              torch.zeros((), dtype=torch.int32, device=ex.device))
        outs.append(out)
        totals.append(total)
        vis_out.append(vis)
    ctx.visited_out[node.join_id] = vis_out
    ctx.join_totals[node.join_id] = _pmax(ex, totals)
    ctx.join_balance[node.join_id] = totals
    return outs


def _dist_fused_child(node: PAggregate, tables, ctx, ex) -> Tuple[Shards, Masks]:
    """(child shards, row filters | None): a filter or an expandable join
    under the aggregate (through projections) becomes a row mask on the
    partial aggregate instead of a compaction."""
    projs = []
    n = node.child
    while isinstance(n, PProject):
        projs.append(n)
        n = n.child
    child = row_filter = None
    if _expandable_join(n, ctx):
        child, row_filter = _dist_join(n, tables, ctx, ex, expanded=True)
    elif isinstance(n, PFilter) and not isinstance(n.child, PFilter):
        if _expandable_join(n.child, ctx):
            child, match = _dist_join(n.child, tables, ctx, ex, expanded=True)
        else:
            child = execute_dist(n.child, tables, ctx, ex)
            match = [None] * len(child)
        row_filter = [predicate_mask(n.predicate, t, ctx.chain, and_mask=m)
                      for t, m in zip(child, match)]
    if child is not None:
        return _project(child, projs, ctx), row_filter
    return execute_dist(node.child, tables, ctx, ex), None


def _aggregate(node: PAggregate, tables, ctx, ex) -> Shards:
    child, row_filter = _dist_fused_child(node, tables, ctx, ex)
    row_filter = row_filter or [None] * len(child)
    c0 = child[0]
    # per-partition group capacity, seeded from the planner's group
    # estimate (the merge receives P x this many rows a partition);
    # overflow retries like every other capacity
    acap = ctx.join_caps.get(node.node_id)
    if acap is None:
        if not node.group_keys:
            acap = 128      # global aggregate: one output row
        elif node.est_groups > 0:
            acap = max(128, min(round_capacity(int(2 * node.est_groups), minimum=128),
                                c0.capacity))
        else:
            acap = min(c0.capacity, max(1024, c0.capacity // 4))
        ctx.join_caps[node.node_id] = acap
    if not node.aggs and node.group_keys:
        # pure dedup (DISTINCT): dedup locally first (the shuffle moves at
        # most acap rows a shard), then co-partition and dedup again
        local = [hash_aggregate_counted(t, node.group_keys, [], acap, f, ctx.chain)
                 for t, f in zip(child, row_filter)]
        ctx.join_totals[node.node_id] = _pmax(ex, [n for _, n in local])
        del child
        shuffled, _ = shuffle_by_hash(ex, [t for t, _ in local], node.group_keys, acap)
        return [hash_aggregate(t, node.group_keys, [], kernels=ctx.chain) for t in shuffled]
    partial_specs, merge_specs, finishers = decompose_for_partial(node.aggs)
    partial = [hash_aggregate_counted(t, node.group_keys, partial_specs, acap, f, ctx.chain)
               for t, f in zip(child, row_filter)]
    ctx.join_totals[node.node_id] = _pmax(ex, [n for _, n in partial])
    in_schema = c0.schema
    partial = [t for t, _ in partial]
    del child, row_filter, c0
    if node.group_keys:
        shuffled, _ = shuffle_by_hash(ex, partial, node.group_keys, partial[0].capacity)
        del partial
        merged = []
        while shuffled:   # each received shard freed once merged
            merged.append(hash_aggregate(shuffled.pop(0), node.group_keys, merge_specs,
                                         kernels=ctx.chain))
    else:
        gathered = all_gather_table(ex, partial)
        # every partition holds the same global row: kept once
        merged = _on_rank_0(ex, [hash_aggregate(t, [], merge_specs, kernels=ctx.chain)
                                 for t in gathered])
    return [finish_partial(t, node.group_keys, node.aggs, finishers, in_schema) for t in merged]


def execute_dist(node: PhysicalPlan, tables: Dict[str, Shards], ctx: ExecContext,
                 ex: Exchange) -> Shards:
    """A plan node over the local shards: its output shards."""
    if isinstance(node, PScan):
        return tables[node.label]
    if isinstance(node, PFilter):
        return [filter_table(t, node.predicate, None, ctx.chain)[0]
                for t in execute_dist(node.child, tables, ctx, ex)]
    if isinstance(node, PProject):
        return _project(execute_dist(node.child, tables, ctx, ex), [node], ctx)
    if isinstance(node, PHashJoin):
        if node.join_id in ctx.materialized:   # staged execution boundary
            return ctx.materialized[node.join_id]
        return _dist_join(node, tables, ctx, ex)
    if isinstance(node, PAggregate):
        if node.node_id in ctx.materialized:
            # streaming's finish: the merge point's completed result
            # (sharded by group key) in place of its subtree
            return ctx.materialized[node.node_id]
        return _aggregate(node, tables, ctx, ex)
    if isinstance(node, PSort):
        child = execute_dist(node.child, tables, ctx, ex)
        if id(node) in ctx.local_sort_ids:
            # root ORDER BY without LIMIT: each shard sorts locally, the host
            # merges at collection; no collective moves the rows
            return [sort_table(t, node.keys, ctx.chain) for t in child]
        full = all_gather_table(ex, child)
        return _on_rank_0(ex, [sort_table(t, node.keys, ctx.chain) for t in full])
    if isinstance(node, PLimit):
        if isinstance(node.child, PSort):
            # distributed top-k: the global top k rows are among the union of
            # the shards' top k, so each shard sorts locally and only k rows
            # a shard are gathered and merged
            srt = node.child
            child = execute_dist(srt.child, tables, ctx, ex)
            kcap = min(child[0].capacity, round_capacity(max(node.n, 1), minimum=128))
            topk = [_shrink_table(limit_table(sort_table(t, srt.keys, ctx.chain), node.n), kcap)
                    for t in child]
            del child
            full = all_gather_table(ex, topk)
            return _on_rank_0(ex, [limit_table(sort_table(t, srt.keys, ctx.chain), node.n)
                                   for t in full])
        return [limit_table(t, node.n) for t in execute_dist(node.child, tables, ctx, ex)]
    raise NotImplementedError(type(node))


def _overflow_keys(nodes: Sequence[PhysicalPlan]) -> list:
    """The capacity keys a run of `nodes` reports: per join its candidate
    total and its build / probe / heavy-block dropped rows; per grouped
    aggregate its group count (a global aggregate's one row needs none)."""
    keys = []
    for n in nodes:
        if isinstance(n, PHashJoin):
            keys += [n.join_id, (n.join_id, "bs"), (n.join_id, "ps"), (n.join_id, "hv")]
    return keys + [n.node_id for n in nodes if isinstance(n, PAggregate) and n.group_keys]


def _stage_nodes(node: PhysicalPlan, done) -> List[PhysicalPlan]:
    """The nodes a run of `node` executes: its subtree down to the joins
    already materialized (join_ids in `done`), which it reads."""
    out = [node]
    for c in node.children():
        if not (isinstance(c, PHashJoin) and c.join_id in done):
            out += _stage_nodes(c, done)
    return out


def _shards_bytes(shards: Sequence[DeviceTable]) -> int:
    return sum(v.numel() * v.element_size() + valid.numel() + t.num_rows.element_size()
               for t in shards for v, valid in t.columns.values())


class DistributedQueryHandle(QueryHandle):
    """A query run over the partitions of `mesh` (an Exchange); the same
    surface as QueryHandle, its result through collect(). It never loads
    or saves the learned capacities (its scalar subqueries' single-device
    handles do)."""

    def __init__(self, plan, catalog, scalar_subqueries=(), config=None, mesh=None,
                 **kernel_tables):
        super().__init__(plan, catalog, scalar_subqueries, config, **kernel_tables)
        self.mesh = mesh or make_mesh(config.target_partitions, catalog.device)
        self._sharded_inputs = None   # (label -> local shards, their bytes under JAX)
        self._streamed_inputs = None  # the same without the streamed scan

    def run(self):
        raise NotImplementedError("the distributed handle returns host tables; use collect()")

    def _shard_inputs(self, skip_labels=()):
        """Each scan's host table split into P contiguous row shards and
        this process's shards uploaded: its live columns, renamed
        "label.col". Also the bytes the JAX package's shards of every scan
        column hold ([P, cap] values and validity), which its staging rule
        reads. `skip_labels`: scans left out (streamed in chunks)."""
        ex = self.mesh
        per_table = self._live_columns()
        tables, jax_bytes = {}, 0
        for node in self.plan.walk():
            if not isinstance(node, PScan) or node.label in tables \
                    or node.label in skip_labels:
                continue
            host = self.catalog.get(node.table_name).host
            cap = round_capacity(max(-(-host.num_rows // ex.P), 1))
            jax_bytes += sum(ex.P * cap * (v.dtype.itemsize + 1)
                             for v, _ in host.columns.values())
            live = per_table[node.table_name] & set(host.schema.names) \
                or {host.schema.names[0]}
            pre = node.label + "."
            fields = [f for f in node.schema.fields if f.name[len(pre):] in live]
            renamed = HostTable(Schema(fields),
                                {f.name: host.columns[f.name[len(pre):]] for f in fields},
                                host.num_rows)
            cols, num, schema, _ = partition_table(renamed, ex.P)
            tables[node.label] = local_shards(ex, schema, cols, num)
        return tables, jax_bytes

    def _root_local_sort(self) -> Optional[PSort]:
        """The root ORDER BY (through projections) when its key columns
        reach the output: sorted shard by shard, merged on the host."""
        node, projs = self.plan, False
        while isinstance(node, PProject):
            projs, node = True, node.child
        if not isinstance(node, PSort):
            return None
        if projs:
            out_names = {f.name for f in self.plan.schema.fields}
            if not all(k.column in out_names for k in node.keys):
                return None
        return node

    def _use_staged(self, joins, leaf_bytes: int) -> bool:
        env = os.environ.get("DFP_DIST_STAGED")
        if env is not None:
            return bool(int(env)) and len(joins) > 1
        cfgd = getattr(self.config, "distributed_staged", None)
        if cfgd is not None:
            return cfgd and len(joins) > 1
        threshold = int(os.environ.get("DFP_DIST_STAGE_THRESHOLD_BYTES", 1 << 30))
        return len(joins) > 1 and leaf_bytes > threshold

    def _finish(self, out: Shards, root_sort) -> HostTable:
        host = gather_shards(self.mesh, out)
        host = HostTable(self.plan.schema, {f.name: host.columns[f.name]
                                            for f in self.plan.schema.fields}, host.num_rows)
        if root_sort is not None:
            host = host_sort_table(host, root_sort.keys)
        return host

    def _check_overflow(self, keys, totals) -> bool:
        overflow = False
        for k, total in zip(keys, totals):
            if isinstance(k, tuple):
                if total > 0:  # dropped shuffle rows: double the block
                    _debug_retry("send", k, None, self._caps[k], total, 2 * self._caps[k])
                    self._caps[k] = 2 * self._caps[k]
                    overflow = True
                continue
            cap = self._caps.get(k)
            if cap is None:
                continue
            fit = round_capacity(max(total, 1), minimum=1024)
            if total > cap:
                _debug_retry("grow", k, None, cap, total, fit)
                self._caps[k] = fit
                overflow = True
            elif cap > 4 * fit:
                # deferred shrink, bounded 64x a step (capacities couple and
                # a full collapse can ping-pong); this run's result is right
                self._caps[k] = max(fit, cap >> 6)
        self.metrics.join_caps = dict(self._caps)
        return overflow

    def _step(self, node, tables, keys, jids, local_ids, mats):
        """One run of `node` over the shards: (its output shards, the totals
        of `keys`, the comm bytes of the run); the candidate totals per
        partition of `jids` go into metrics.balance. Every total comes back
        in one host sync."""
        ex = self.mesh
        caps = dict(self._caps)
        ctx = ExecContext(caps, mats, self.kernels, self.chain)
        ctx.local_sort_ids = local_ids
        reset_comm_bytes()
        t0 = time.perf_counter()
        self.metrics.launches += 1
        out = execute_dist(node, tables, ctx, ex)
        comm = get_comm_bytes()
        self._caps.update(caps)
        totals = [ctx.join_totals.get(k) for k in keys]
        ran = [t.reshape(()).to(torch.int64) for t in totals if t is not None]
        if jids:
            zero = torch.zeros((), dtype=torch.int64, device=ex.device)
            local = [torch.stack([ctx.join_balance[j][i].reshape(()).to(torch.int64)
                                  if j in ctx.join_balance else zero for j in jids])
                     for i in range(len(ex.ranks))]
            ran.append(ex.all_gather(local, 0)[0])   # [P * n_joins], partition-major
        values = torch.cat([r.reshape(-1) for r in ran]).tolist() if ran else []
        it = iter(values)
        totals = [0 if t is None else int(next(it)) for t in totals]
        bal = list(it)
        for i, j in enumerate(jids):
            self.metrics.balance[j] = [int(x) for x in bal[i::len(jids)]]
        self.metrics.run_time_s += time.perf_counter() - t0
        return out, totals, comm

    def _run_subqueries(self):
        """Uncorrelated scalar subqueries on the single-device handle, once
        per handle (registered tables are immutable)."""
        if self._sub_handles is None:
            self._sub_handles = [
                QueryHandle(sub.plan, self.catalog, sub.scalar_subqueries, self.config,
                            kernels=self.kernels, chain=self.chain)
                for _, sub in self.scalar_subqueries]
        for (sv, _), handle in zip(self.scalar_subqueries, self._sub_handles):
            if getattr(sv, "_settled", False):
                continue
            result = handle.run().to_host()
            rows = result.to_pylist()
            if len(rows) != 1:
                raise ValueError(f"scalar subquery returned {len(rows)} rows")
            sv.holder[0] = rows[0][result.schema.fields[0].name]
            sv._settled = True

    def stream_plan(self):
        """The StreamPlan collect() streams through the partitions, or None
        (it runs resident): under the JAX package's conditions, with
        DFP_NO_STREAM unset, every partition in this process, the biggest
        scan past the out-of-core thresholds (`_need_stream`) and the plan
        stream-decomposable, after a side-swap where needed."""
        if os.environ.get("DFP_NO_STREAM") or len(self.mesh.ranks) != self.mesh.P:
            return None
        need_stream = self._need_stream()
        sp = plan_stream(self.plan, self.catalog)
        if sp is None and need_stream:
            # the side-swap rule (runtime/executor.py): only when streaming
            # is required, since it undoes the cost-based build-side choice
            sp = plan_stream(self.plan, self.catalog, allow_swap=True)
            self._swapped = self._swapped or sp is not None
        return sp if need_stream else None

    def collect(self) -> HostTable:
        self._run_subqueries()
        sp = self.stream_plan()
        if sp is not None:
            from ..models.physical import find_adaptive
            from .distributed_streaming import run_streamed_dist
            self.metrics.route = "streamed after a side-swap" if self._swapped else "streamed"
            return run_streamed_dist(self, sp, self._live_columns().get(sp.scan.table_name),
                                     find_adaptive(self.plan))
        self.metrics.route = "resident"
        if self._sharded_inputs is None:
            self._sharded_inputs = self._shard_inputs()
        tables, leaf_bytes = self._sharded_inputs
        root_sort = self._root_local_sort()
        local_ids = frozenset({id(root_sort)}) if root_sort is not None else frozenset()
        joins = find_joins(self.plan)
        self.metrics.staged = self._use_staged(joins, leaf_bytes)
        if self.metrics.staged:
            return self._collect_staged(tables, joins, root_sort, local_ids)
        keys = _overflow_keys(list(self.plan.walk()))
        jids = [j.join_id for j in joins]
        while True:
            self.metrics.balance = {}
            out, totals, self.metrics.comm_bytes = self._step(self.plan, tables, keys, jids,
                                                              local_ids, None)
            if not self._check_overflow(keys, totals):
                return self._finish(out, root_sort)
            self.metrics.retries += 1
            del out

    def _collect_staged(self, tables, joins, root_sort, local_ids) -> HostTable:
        """Each join subtree as its own run, bottom up, its output shards
        kept on the devices for the stages above (the distributed
        QueryHandle._run_staged): a run holds one join's shuffles and
        gathers, not the whole plan's, and retries alone. A stage's
        materialized inputs are freed once its output is made."""
        plan = self.plan
        order: list = []
        seen = set()
        join_ids = {id(j) for j in joins}

        def post(n):
            for c in n.children():
                post(c)
            if id(n) in join_ids and id(n) not in seen:
                seen.add(id(n))
                order.append(n)

        post(plan)
        stages = [(True, j) for j in order if j is not plan]
        stages.append((False, plan))
        mats: Dict[int, Shards] = {}   # the materialized outputs not yet read
        done = set()                     # every join materialized so far
        self.metrics.stage_bytes = []
        stage_comm: Dict[int, int] = {}
        n_local = len(self.mesh.ranks)
        leaf_bytes = sum(_shards_bytes(s) for s in tables.values()) // n_local
        for stage_idx, (materialize, node) in enumerate(stages):
            # the nodes this stage runs report their totals; those of earlier
            # stages do not run (the JAX package reads them as 0 and shrinks
            # their capacities, so each collect() at scale retries once)
            nodes = _stage_nodes(node, done)
            keys = _overflow_keys(nodes)
            jids = [n.join_id for n in nodes if isinstance(n, PHashJoin)]
            while True:
                out, totals, stage_comm[stage_idx] = self._step(
                    node, tables, keys, jids, local_ids if not materialize else frozenset(),
                    mats)
                if not self._check_overflow(keys, totals):
                    break
                self.metrics.retries += 1
                del out
            # bytes a partition holds: leaf shards, the materialized inputs,
            # this stage's output
            self.metrics.stage_bytes.append({
                "stage": stage_idx, "node": node.describe(),
                "leaf_bytes_per_device": leaf_bytes,
                "mat_bytes_per_device": sum(_shards_bytes(s) for s in mats.values()) // n_local,
                "out_bytes_per_device": _shards_bytes(out) // n_local,
            })
            for n in nodes:   # the materialized inputs this stage read
                for c in n.children():
                    mats.pop(getattr(c, "join_id", None), None)
            if materialize:
                mats[node.join_id] = out
                done.add(node.join_id)
                del out
        self.metrics.comm_bytes = sum(stage_comm.values())
        return self._finish(out, root_sort)
