"""Physical plan nodes (torch): the JAX package's `models/physical.py`
run eagerly.

Each node carries its output schema, computed at plan time, and an
`execute(tables, ctx) -> DeviceTable` that runs its operator at once on the
tables' device. The kernels come from the context: `ctx.kernels` (the
join's JoinKernels) and `ctx.chain` (the single-table operators'
ChainKernels), so one plan runs on the kernels or on their plain versions.
Capacities, chain fusion and late materialization follow the JAX package
rule for rule; every node's overflow total stays a device tensor for the
executor to read once per run. Out-of-core execution (runtime/streaming.py,
runtime/grace.py) reaches the plan through the JAX package's hooks: a
join's frozen build side (`ctx.prepared`), a streamed build-emitting
join's visited fold across probe chunks (`ctx.stream_visited` /
`ctx.visited_out`), and the merge point's finished result
(`ctx.materialized`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from ..kernels.chain import KERNELS as CHAIN_KERNELS
from ..kernels.chain import ChainKernels
from ..ops.aggregate import AggSpec, agg_output_schema, hash_aggregate_counted
from ..ops.expressions import Expr, evaluate, predicate_mask
from ..ops.filter import filter_table
from ..ops.hash_table import JoinStrategy
from ..ops.join import KERNELS as JOIN_KERNELS
from ..ops.join import JoinKernels, JoinType, hash_join, join_output_schema
from ..ops.project import project_table
from ..ops.sort import SortKey, limit_table, sort_table
from ..utils.columnar import DeviceTable, Field, Schema, null_columns_like, round_capacity
from ..utils.tracing import operator_range


class PhysicalPlan:
    schema: Schema

    def children(self) -> List["PhysicalPlan"]:
        return []

    def execute(self, tables: Dict[str, DeviceTable],
                ctx: "ExecContext") -> DeviceTable:
        raise NotImplementedError

    def tree(self, indent: int = 0) -> str:
        s = "  " * indent + self.describe()
        for c in self.children():
            s += "\n" + c.tree(indent + 1)
        return s

    def describe(self) -> str:
        return self.__class__.__name__

    def walk(self):
        yield self
        for c in self.children():
            yield from c.walk()


class ExecContext:
    """Per-execution mutable state: adaptive output capacities (grown on
    overflow retry), the overflow totals reported by each node (device
    tensors), under staged execution the materialized join results of
    earlier stages, and the kernel tables the operators reach.
    Distributed execution (runtime/distributed_executor.py) adds each
    join's per-shard candidate totals (`join_balance`) and the sorts that
    run shard-local (`local_sort_ids`).

    Out of core: `prepared` maps join_id -> PreparedBuild, the frozen
    build sides probed by every chunk; `stream_visited` maps the join_id
    of a build-emitting join whose probe side is streamed to its visited
    buffer (bool over the frozen build's capacity), which the join ORs
    this chunk's matches into in place (K10's accumulate mode) and
    records in `visited_out` (the cross-chunk ConcurrentBitSet analog,
    reference full.rs:77-201)."""

    def __init__(self, join_caps: Dict[int, int], materialized=None,
                 kernels: JoinKernels = JOIN_KERNELS,
                 chain: ChainKernels = CHAIN_KERNELS, prepared=None):
        self.join_caps = join_caps
        self.join_totals: Dict[int, torch.Tensor] = {}
        self.materialized = materialized or {}
        self.kernels = kernels
        self.chain = chain
        self.prepared = prepared or {}
        self.stream_visited: Dict[int, torch.Tensor] = {}
        self.visited_out: Dict[int, torch.Tensor] = {}
        # distributed only: join_id -> the local candidate total of each
        # local shard (the work-balance proxy), and the sort nodes that run
        # shard-local (a root ORDER BY merged at collection)
        self.join_balance: Dict[int, List[torch.Tensor]] = {}
        self.local_sort_ids = frozenset()


def _zero(t: DeviceTable) -> torch.Tensor:
    """The total a fused-away node reports."""
    return torch.zeros((), dtype=torch.int32, device=t.device)


@dataclass
class PScan(PhysicalPlan):
    table_name: str
    label: str
    schema: Schema

    def describe(self):
        return f"Scan({self.table_name} as {self.label})"

    @operator_range
    def execute(self, tables, ctx):
        return tables[self.label]


@dataclass
class PFilter(PhysicalPlan):
    child: PhysicalPlan
    predicate: Expr
    # planner's output-row estimate (range/NDV selectivity over catalog
    # stats); 0 = unknown. Seeds the initial capacity.
    est_rows: float = 0.0
    node_id: int = field(default_factory=lambda: _next_node_id())
    schema: Schema = None

    def __post_init__(self):
        self.schema = self.child.schema

    def children(self):
        return [self.child]

    def describe(self):
        return f"Filter({self.predicate})"

    @operator_range
    def execute(self, tables, ctx):
        child = self.child.execute(tables, ctx)
        # adaptive output capacity, seeded by the planner's selectivity
        # estimate with 2x headroom (default: selectivity <= 1/4); grows on
        # overflow
        cap = ctx.join_caps.get(self.node_id)
        if cap is None:
            if self.est_rows > 0:
                cap = min(child.capacity,
                          round_capacity(int(2 * self.est_rows),
                                         minimum=1024))
            else:
                cap = min(child.capacity, max(1024, child.capacity // 4))
            ctx.join_caps[self.node_id] = cap
        out, total = filter_table(child, self.predicate, cap, ctx.chain)
        ctx.join_totals[self.node_id] = total
        return out


@dataclass
class PProject(PhysicalPlan):
    child: PhysicalPlan
    exprs: List[Tuple[Expr, str]]
    out_fields: List[Field]      # plan-time schema (dtype/dictionary info)
    schema: Schema = None

    def __post_init__(self):
        self.schema = Schema(self.out_fields)

    def children(self):
        return [self.child]

    def describe(self):
        return f"Project({', '.join(n for _, n in self.exprs)})"

    @operator_range
    def execute(self, tables, ctx):
        return project_table(self.child.execute(tables, ctx), self.exprs,
                             self.out_fields, ctx.chain)


_JOIN_ID = [0]


def _next_node_id() -> int:
    _JOIN_ID[0] += 1
    return _JOIN_ID[0]


@dataclass
class PHashJoin(PhysicalPlan):
    """The ParallelHashJoin analog. build == left child (reference keeps
    DataFusion's convention: left child is the build side)."""
    build: PhysicalPlan
    probe: PhysicalPlan
    build_keys: List[str]
    probe_keys: List[str]
    join_type: JoinType
    strategy: JoinStrategy = JoinStrategy.CSR
    residual: Optional[Expr] = None
    # distributed execution mode: partitioned | broadcast | skew_salted
    # (set by the optimizer from statistics; single-device execution ignores it)
    dist_mode: str = "partitioned"
    # planner's output-cardinality estimate; seeds the initial capacity
    est_rows: float = 0.0
    # probe-side hot-key share (catalog mcv_share_of), recorded by
    # ChooseDistModeRule; with salting off, the distributed shuffle seeds
    # its per-destination send capacity from it
    probe_mcv_share: float = 0.0
    join_id: int = field(default_factory=lambda: _JOIN_ID.__setitem__(0, _JOIN_ID[0] + 1) or _JOIN_ID[0])
    schema: Schema = None

    def __post_init__(self):
        self.schema = join_output_schema(self.build.schema, self.probe.schema,
                                         self.join_type)

    def children(self):
        return [self.build, self.probe]

    def describe(self):
        r = f" filter={self.residual}" if self.residual is not None else ""
        return (f"HashJoin[{self.join_type.value}/{self.strategy.value}] "
                f"on {list(zip(self.build_keys, self.probe_keys))}{r}")

    # join types whose execution can be returned late-materialized as
    # (uncompacted table, mask) — see ops/join.py hash_join `expanded`
    EXPANDABLE = (JoinType.INNER, JoinType.LEFT_SEMI, JoinType.LEFT_ANTI,
                  JoinType.RIGHT_SEMI, JoinType.RIGHT_ANTI)

    def _inputs_and_cap(self, tables, ctx):
        """Chain fusion: an input that is itself an expandable join executes
        late-materialized — (uncompacted table, mask) — and the mask rides
        into hash_join as build_valid/probe_valid, erasing the child's
        compaction."""
        prepared = ctx.prepared.get(self.join_id)
        b_valid = None
        if prepared is not None:
            b = prepared.build
        else:
            b, b_valid = _execute_maybe_expanded(self.build, tables, ctx)
        p, p_valid = _execute_maybe_expanded(self.probe, tables, ctx)
        cap = ctx.join_caps.get(self.join_id)
        if cap is None:
            # ceiling on SEED capacities (learned/grown caps may exceed it):
            # an undershoot costs one grow retry, an overshoot can exhaust
            # device memory on the first run
            ceiling = int(os.environ.get("DFP_MAX_JOIN_SEED_CAP", 1 << 25))
            if self.est_rows > 0:
                # planner cardinality estimate with 1.3x headroom, clamped to
                # 4x the inputs
                cap = min(round_capacity(int(1.3 * self.est_rows),
                                         minimum=1024),
                          4 * max(256, b.capacity, p.capacity), ceiling)
            else:
                # ~1 match per probe row is the common FK-join shape
                cap = min(max(256, b.capacity, p.capacity), ceiling)
            ctx.join_caps[self.join_id] = cap
        residual_fn = None
        if self.residual is not None:
            res = self.residual
            def residual_fn(pair_tbl):
                return evaluate([res], pair_tbl, ctx.chain)[0][:2]
        return b, p, cap, residual_fn, prepared, b_valid, p_valid

    def _join(self, tables, ctx, expanded: bool):
        b, p, cap, residual_fn, prepared, b_valid, p_valid = self._inputs_and_cap(tables, ctx)
        out = hash_join(b, p, self.build_keys, self.probe_keys, self.join_type, cap,
                        strategy=self.strategy, residual=residual_fn, prepared=prepared,
                        expanded=expanded, build_valid=b_valid, probe_valid=p_valid,
                        kernels=ctx.kernels, chain=ctx.chain)
        ctx.join_totals[self.join_id] = out[-1]
        return out[:-1]

    @operator_range
    def execute(self, tables, ctx):
        if self.join_id in ctx.materialized:   # staged execution boundary
            return ctx.materialized[self.join_id]
        if self.join_id in ctx.stream_visited:
            return self._execute_stream_chunk(tables, ctx)
        return self._join(tables, ctx, False)[0]

    # streamed-probe rewrites: per-chunk emission of a build-emitting join
    # is its probe-linear part (pairs; plus the chunk's own unmatched probe
    # rows for FULL); the build-side emission is deferred to the stream's
    # flush pass via the folded visited mask
    _STREAM_CHUNK_TYPE = {JoinType.LEFT: JoinType.INNER,
                          JoinType.FULL: JoinType.RIGHT}

    def _execute_stream_chunk(self, tables, ctx):
        """One probe chunk of a build-emitting join under morsel streaming:
        emit the chunk's probe-linear rows now and OR this chunk's build-row
        matches into the visited buffer (ctx.visited_out). The deferred
        build-side rows (unmatched for LEFT/FULL/LEFT_ANTI, matched for
        LEFT_SEMI) are emitted once by runtime/streaming.py's flush pass
        after the last chunk — the reference's last-stream finalizer
        (full.rs:181-201) with the barrier replaced by the end of the chunk
        loop."""
        b, p, cap, residual_fn, prepared, b_valid, p_valid = self._inputs_and_cap(tables, ctx)
        vis = ctx.stream_visited[self.join_id]
        kw = dict(strategy=self.strategy, residual=residual_fn, prepared=prepared,
                  build_valid=b_valid, probe_valid=p_valid, return_visited=True,
                  kernels=ctx.kernels, chain=ctx.chain, visited_into=vis)
        chunk_type = self._STREAM_CHUNK_TYPE.get(self.join_type)
        if chunk_type is not None:            # LEFT / FULL: pairs this chunk
            # output schemas line up: INNER's == LEFT's, RIGHT's == FULL's
            out, total, _ = hash_join(b, p, self.build_keys, self.probe_keys, chunk_type,
                                      cap, **kw)
        else:                                 # LEFT_SEMI / LEFT_ANTI
            # per-chunk emission is EMPTY (the output is build rows, all
            # deferred); only the visited fold runs, gather-free (expanded)
            _, _, total, _ = hash_join(b, p, self.build_keys, self.probe_keys,
                                       self.join_type, cap, expanded=True, **kw)
            out = DeviceTable(self.schema,
                              null_columns_like(self.schema, 128, device=b.device),
                              torch.zeros((), dtype=torch.int32, device=b.device))
        ctx.visited_out[self.join_id] = vis
        ctx.join_totals[self.join_id] = total
        return out

    @operator_range
    def execute_expanded(self, tables, ctx):
        """Late-materialized execution for aggregate fusion: (table, mask) —
        the caller fuses the mask as an aggregate row filter instead of
        compacting. INNER returns the uncompacted pair table + match;
        semi/anti return the surviving input side + its flag."""
        return self._join(tables, ctx, True)


def _expandable_join(n, ctx) -> bool:
    """Can `n` execute late-materialized (execute_expanded) here? Joins
    already materialized at a staged boundary must be consumed as-is.
    DFP_NO_LATE_MAT=1 disables join late materialization entirely."""
    if os.environ.get("DFP_NO_LATE_MAT"):
        return False
    return (isinstance(n, PHashJoin)
            and n.join_type in PHashJoin.EXPANDABLE
            and n.join_id not in ctx.materialized
            # streamed-probe joins must take execute()'s chunk-wise branch
            # (visited fold + deferred emission), not late materialization
            and n.join_id not in ctx.stream_visited)


def _execute_maybe_expanded(node, tables, ctx):
    """(table, mask|None): execute `node` late-materialized if it is an
    expandable join OR a filter, looking through any PProject chain
    (projections are elementwise and row-aligned, so they commute with the
    mask). A weakly selective filter over a big scan feeding a join side
    becomes a validity mask on that side instead of a compaction."""
    projs = []
    n = node
    while isinstance(n, PProject):
        projs.append(n)
        n = n.child
    t = mask = None
    if _expandable_join(n, ctx):
        t, mask = n.execute_expanded(tables, ctx)
    elif isinstance(n, PFilter) and not isinstance(n.child, PFilter):
        if _expandable_join(n.child, ctx):
            t, match = n.child.execute_expanded(tables, ctx)
            mask = predicate_mask(n.predicate, t, ctx.chain, and_mask=match)
            ctx.join_totals[n.node_id] = _zero(t)
        else:
            # gate: only weakly-selective filters (est keeps >= 1/4 of the
            # rows) over BIG scans fuse — a selective filter's compaction
            # shrinks every downstream capacity and must still run
            c = n.child
            while isinstance(c, PProject):
                c = c.child
            if isinstance(c, PScan) and c.label in tables:
                cap_c = tables[c.label].capacity
                if cap_c > (1 << 22) and n.est_rows * 4 >= cap_c:
                    t = n.child.execute(tables, ctx)
                    mask = predicate_mask(n.predicate, t, ctx.chain)
                    ctx.join_totals[n.node_id] = _zero(t)
    if t is not None:
        for pr in reversed(projs):
            t = project_table(t, pr.exprs, pr.out_fields, ctx.chain)
        return t, mask
    return node.execute(tables, ctx), None


@dataclass
class PAggregate(PhysicalPlan):
    child: PhysicalPlan
    group_keys: List[str]
    aggs: List[AggSpec]
    # planner's group-count estimate (catalog distinct counts); 0 = unknown
    est_groups: float = 0.0
    node_id: int = field(default_factory=lambda: _next_node_id())
    schema: Schema = None

    def __post_init__(self):
        self.schema = agg_output_schema(self.child.schema, self.group_keys,
                                        self.aggs)

    def children(self):
        return [self.child]

    def describe(self):
        a = ", ".join(f"{x.func}({x.input or '*'})" for x in self.aggs)
        return f"Aggregate(group={self.group_keys}, aggs=[{a}])"

    def fused_child(self, tables, ctx):
        """(child, row_filter): aggregate over a filter (under any projection
        chain) fuses the predicate as a row mask, and an expandable join
        directly under the chain fuses its match mask (late
        materialization): the filter's and the join's compactions
        disappear."""
        projs = []
        node = self.child
        while isinstance(node, PProject):
            projs.append(node)
            node = node.child

        child = row_filter = None
        if _expandable_join(node, ctx):
            child, row_filter = node.execute_expanded(tables, ctx)
        elif isinstance(node, PFilter) and not isinstance(node.child, PFilter):
            if _expandable_join(node.child, ctx):
                child, match = node.child.execute_expanded(tables, ctx)
                row_filter = predicate_mask(node.predicate, child, ctx.chain, and_mask=match)
            else:
                child = node.child.execute(tables, ctx)
                row_filter = predicate_mask(node.predicate, child, ctx.chain)
            ctx.join_totals[node.node_id] = _zero(child)
        if child is not None:
            for p in reversed(projs):
                child = project_table(child, p.exprs, p.out_fields, ctx.chain)
            return child, row_filter
        return self.child.execute(tables, ctx), None

    @operator_range
    def execute(self, tables, ctx):
        if self.node_id in ctx.materialized:
            # out-of-core execution materializes the merge-point
            # aggregate's finished result and runs the rest of the plan
            # above it (outer aggregates, joins, sorts: Q13's second
            # aggregate) on it
            return ctx.materialized[self.node_id]
        child, row_filter = self.fused_child(tables, ctx)
        cap = ctx.join_caps.get(self.node_id)
        if cap is None:
            if self.est_groups > 0:
                # 2x headroom over the catalog estimate
                cap = max(128, min(round_capacity(int(2 * self.est_groups)),
                                   child.capacity))
            else:
                cap = min(child.capacity, max(1024, child.capacity // 4))
            ctx.join_caps[self.node_id] = cap
        out, total = hash_aggregate_counted(child, self.group_keys, self.aggs,
                                            cap, row_filter, ctx.chain)
        ctx.join_totals[self.node_id] = total
        return out


@dataclass
class PSort(PhysicalPlan):
    child: PhysicalPlan
    keys: List[SortKey]
    schema: Schema = None

    def __post_init__(self):
        self.schema = self.child.schema

    def children(self):
        return [self.child]

    def describe(self):
        return f"Sort({[(k.column, 'asc' if k.ascending else 'desc') for k in self.keys]})"

    @operator_range
    def execute(self, tables, ctx):
        return sort_table(self.child.execute(tables, ctx), self.keys, ctx.chain)


@dataclass
class PLimit(PhysicalPlan):
    child: PhysicalPlan
    n: int
    schema: Schema = None

    def __post_init__(self):
        self.schema = self.child.schema

    def children(self):
        return [self.child]

    def describe(self):
        return f"Limit({self.n})"

    @operator_range
    def execute(self, tables, ctx):
        return limit_table(self.child.execute(tables, ctx), self.n)


def find_joins(plan: PhysicalPlan) -> List[PHashJoin]:
    return [n for n in plan.walk() if isinstance(n, PHashJoin)]


def find_adaptive(plan: PhysicalPlan) -> List[Tuple[int, PhysicalPlan]]:
    """(capacity key, node) for every node with an adaptive output capacity."""
    out = []
    for n in plan.walk():
        if isinstance(n, PHashJoin):
            out.append((n.join_id, n))
        elif isinstance(n, (PFilter, PAggregate)):
            out.append((n.node_id, n))
    return out
