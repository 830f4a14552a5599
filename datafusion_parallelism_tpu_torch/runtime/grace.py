"""Grace-partitioned out-of-core execution (torch): key-hash partitioned
streaming.

Counterpart of `datafusion_parallelism_tpu/runtime/grace.py`, with its
rules and rejection reasons word for word. Row-range morsel streaming
(runtime/streaming.py) needs the out-of-core table scanned ONCE and on the
probe side of every join on its path. Plans that self-join the big table
(TPC-H Q2/Q17/Q18/Q21) or join two huge tables (Q7) have no such
decomposition; key-hash partitioning restores independence. Every
over-threshold scan is partitioned on the host by the HASH OF ITS JOIN
COLUMN (the reference's dashmap shard function, src/utils/
partitioned_concurrent_self_hash_join_map.rs:13-16, lifted to the
host/device boundary), so rows with equal key values land in the same
partition index across ALL scans, and each partition runs the whole
sub-plan under the merge point exactly. Per-partition results fold into
the partial-aggregate accumulator streaming uses (kind "agg"), append into
a packed row-union accumulator through K13 (kind "union", Q2's shape), or
OR into a resident semi/anti join's visited buffer through K10's
accumulate mode (kind "mask", Q20's shape).

Eligibility (`plan_grace`) is requirement propagation: the merge subtree is
walked top-down carrying the column each subtree's output must be
partitioned by.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.physical import (PAggregate, PFilter, PHashJoin, PLimit, PProject,
                               PScan, PSort, PhysicalPlan)
from ..ops.aggregate import agg_output_schema, decompose_for_partial, finish_partial
from ..ops.expressions import Col
from ..ops.join import JoinType
from ..utils.columnar import (DeviceTable, Kind, PackedTable, f64_matrix,
                              null_columns_like, pack_table, packed_layout, round_capacity,
                              unpack_table)
from .streaming import (_contains, _flush_input, _path_to, context, device_chunk, finish,
                        grow, merge_partial, prepare_builds, read_totals)

_DECOMPOSABLE = ("sum", "count", "count_star", "min", "max", "avg")
# join types that are correct per-partition when only ONE side carries the
# partitioned flow (the other side is a small table replicated into every
# partition): emissions driven by the replicated side would repeat per
# partition and are rejected
_BIG_PROBE_OK = (JoinType.INNER, JoinType.RIGHT, JoinType.RIGHT_SEMI,
                 JoinType.RIGHT_ANTI)
_BIG_BUILD_OK = (JoinType.INNER, JoinType.LEFT, JoinType.LEFT_SEMI,
                 JoinType.LEFT_ANTI)
_PART_KINDS = (Kind.INT32, Kind.INT64, Kind.DATE32, Kind.DECIMAL)


@dataclass
class GracePlan:
    root: PhysicalPlan
    # merge point: PAggregate (kind "agg" — partial fold), PHashJoin (kind
    # "union" — row append), or a semi/anti PHashJoin with a RESIDENT build
    # (kind "mask" — the build's visited mask ORs across partitions and the
    # deferred emission runs once at finish, the streaming flush re-used)
    merge: PhysicalPlan
    kind: str
    # scan label -> (scan node, BASE column name it is hash-partitioned by);
    # labels shared by several scans of the same table appear once
    parts: Dict[str, Tuple[PScan, str]]

    @property
    def merge_is_agg(self) -> bool:
        return self.kind == "agg"


def _hash_mod(v: np.ndarray, K: int) -> np.ndarray:
    """splitmix64 finalizer mod K — a pure function of the VALUE, so equal
    join-key values land in the same partition across different tables and
    integer widths. numpy uint64 (torch on the CPU has no unsigned
    shifts)."""
    x = np.asarray(v).astype(np.int64).astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return (x % np.uint64(K)).astype(np.int32)


def plan_grace(plan: PhysicalPlan, catalog, row_threshold: int):
    """-> (GracePlan | None, rejection_reason | None).

    When the full big-scan set cannot agree on one partitioning (Q9:
    lineitem meets partsupp on partkey+suppkey but orders on orderkey),
    DEMOTE the smallest big tables back to residency — up to a ceiling a
    card can hold — and retry with the rest."""
    all_big = sorted(
        {n.table_name for n in plan.walk() if isinstance(n, PScan)
         and catalog.get(n.table_name).host.num_rows > row_threshold},
        key=lambda t: catalog.get(t).host.num_rows)
    if not all_big:
        return None, "no scan above the residency threshold"
    ceiling = int(os.environ.get("DFP_GRACE_RESIDENT_CEILING", 96 << 20))
    first_reason = None
    for demote in range(len(all_big)):
        if demote and catalog.get(all_big[demote - 1]).host.num_rows \
                > ceiling:
            break      # too big to sit resident; no point demoting further
        gp, reason = _plan_grace_one(plan, catalog,
                                     set(all_big[demote:]))
        if gp is not None:
            return gp, None
        first_reason = first_reason or reason
    return None, first_reason


def _plan_grace_one(plan: PhysicalPlan, catalog, big_tables):
    big_scans = [n for n in plan.walk() if isinstance(n, PScan)
                 and n.table_name in big_tables]
    if not big_scans:
        return None, "no scan above the residency threshold"
    big_ids = {id(s) for s in big_scans}

    # merge point: the LOWEST decomposable aggregate dominating all big
    # scans; failing that, the root join under the Sort/Limit/Project head
    # (row-union merge, Q2's shape)
    path0 = _path_to(plan, big_scans[0])
    cand = [n for n in path0 if isinstance(n, PAggregate)
            and all(_contains(n, s) for s in big_scans)]
    merge = kind = walk_root = None
    if cand:
        merge = cand[-1]
        bad = [x.func for x in merge.aggs if x.func not in _DECOMPOSABLE]
        if bad:
            return None, f"non-decomposable aggregates at merge point: {bad}"
        kind, walk_root = "agg", merge.child
    else:
        node = plan
        while isinstance(node, (PSort, PLimit, PProject)):
            node = node.child
        if isinstance(node, PHashJoin) \
                and all(_contains(node, s) for s in big_scans):
            merge, kind, walk_root = node, "union", node

    def try_walk(root_node):
        parts: Dict[str, Tuple[PScan, str]] = {}
        covered: set = set()
        reason = _walk(root_node, None, big_ids, parts, catalog, covered)
        if reason is not None:
            return None, reason
        if covered != big_ids:
            return None, ("a big scan has no keyed meet join above it "
                          "(row-range streaming applies, not grace)")
        return parts, None

    parts = reason = None
    if merge is not None:
        parts, reason = try_walk(walk_root)
    else:
        reason = ("no aggregate dominates every big scan and the plan root "
                  "is not Sort/Limit/Project over a single join: no bounded "
                  "merge point")
    if parts is None:
        # MASK merge fallback (Q20's shape): a semi/anti join whose BUILD is
        # resident and whose PROBE subtree holds every big scan selects
        # resident rows — its visited mask is the bounded cross-partition
        # state, the streaming flush machinery emits once at the end
        for j in plan.walk():
            if isinstance(j, PHashJoin) \
                    and j.join_type in (JoinType.LEFT_SEMI,
                                        JoinType.LEFT_ANTI) \
                    and not any(id(m) in big_ids for m in j.build.walk()) \
                    and all(_contains(j.probe, s) for s in big_scans):
                mparts, mreason = try_walk(j.probe)
                if mparts is not None:
                    merge, kind, parts = j, "mask", mparts
                    break
        if parts is None:
            return None, reason
    # partition-column dtypes must hash consistently across tables: require
    # integer-family kinds (dictionary codes are table-local)
    for label, (scan, col) in parts.items():
        f = catalog.get(scan.table_name).host.schema.field(col)
        if f.dtype.kind not in _PART_KINDS:
            return None, (f"partition column {label}.{col} has kind "
                          f"{f.dtype.kind}: codes are table-local and do "
                          "not hash consistently across scans")
    # one partitioning per table
    by_table: Dict[str, set] = {}
    for label, (scan, col) in parts.items():
        by_table.setdefault(scan.table_name, set()).add(col)
    for t, cols in by_table.items():
        if len(cols) > 1:
            return None, (f"{t} would need two different partitionings "
                          f"({sorted(cols)})")
    return GracePlan(plan, merge, kind, parts), None


def _walk(node, req: Optional[str], big_ids, parts, catalog,
          covered: set) -> Optional[str]:
    """Validate `node`'s subtree for per-partition execution; its output
    must be key-partitioned by column `req` (None = unconstrained).
    Returns a rejection reason, or None and fills `parts`."""
    if isinstance(node, PScan):
        if id(node) not in big_ids:
            return None                      # resident leaf on the flow
        if req is None:
            return (f"big scan {node.label} reached with no key requirement "
                    "(row-range streaming applies)")
        if req not in node.schema.names:
            return f"partition column {req} not produced by scan {node.label}"
        base = req.split(".", 1)[1] if "." in req else req
        prev = parts.get(node.label)
        if prev is not None and prev[1] != base:
            return (f"label {node.label} needs two partition columns "
                    f"({prev[1]}, {base})")
        parts[node.label] = (node, base)
        covered.add(id(node))
        return None
    if isinstance(node, PFilter):
        return _walk(node.child, req, big_ids, parts, catalog, covered)
    if isinstance(node, PProject):
        if req is not None:
            e = next((e for e, nm in node.exprs if nm == req), None)
            if not isinstance(e, Col):
                return (f"partition column {req} is computed (not a rename) "
                        "at a projection")
            req = e.name
        return _walk(node.child, req, big_ids, parts, catalog, covered)
    if isinstance(node, PAggregate):
        if req is None:
            return ("an aggregate sits on the partition flow with no key "
                    "requirement")
        if req not in node.group_keys:
            return (f"nested aggregate does not group by partition column "
                    f"{req} — its groups would straddle partitions")
        # group-key output columns keep the child column name; any agg
        # function is fine (the aggregate is EXACT per partition)
        return _walk(node.child, req, big_ids, parts, catalog, covered)
    if isinstance(node, PHashJoin):
        bbig = any(id(m) in big_ids for m in node.build.walk())
        pbig = any(id(m) in big_ids for m in node.probe.walk())
        pairs = list(zip(node.build_keys, node.probe_keys))
        if bbig and pbig:
            # MEET join: both inputs must be partitioned by a key pair —
            # then every key's rows are fully within one partition and ALL
            # 8 join types (+ residual filters) are exact per partition
            if req is None:
                reasons = []
                for bk, pk in pairs:
                    trial: Dict[str, Tuple[PScan, str]] = dict(parts)
                    r = (_walk(node.build, bk, big_ids, trial, catalog, covered)
                         or _walk(node.probe, pk, big_ids, trial, catalog, covered))
                    if r is None:
                        parts.clear()
                        parts.update(trial)
                        return None
                    reasons.append(r)
                return ("no key pair of the meet join supports "
                        f"partitioning: {reasons[0]}")
            if req in node.build.schema.names:
                for bk, pk in pairs:
                    if bk == req:
                        return (_walk(node.build, req, big_ids, parts,
                                      catalog, covered)
                                or _walk(node.probe, pk, big_ids, parts,
                                         catalog, covered))
                return f"meet join not keyed by required column {req}"
            for bk, pk in pairs:
                if pk == req:
                    return (_walk(node.probe, req, big_ids, parts, catalog, covered)
                            or _walk(node.build, bk, big_ids, parts,
                                     catalog, covered))
            return f"meet join not keyed by required column {req}"
        if not (bbig or pbig):
            return None                       # fully resident subtree
        big_side, ok = ((node.build, _BIG_BUILD_OK) if bbig
                        else (node.probe, _BIG_PROBE_OK))
        if node.join_type not in ok:
            side = "build" if bbig else "probe"
            return (f"{node.join_type.value} join with the partitioned flow "
                    f"on the {side} side would emit replicated-side rows "
                    "once per partition")
        if req is not None and req not in big_side.schema.names:
            # the requirement names a resident column: transfer it across an
            # INNER equi-pair (output rows have equal values on both sides)
            if node.join_type is not JoinType.INNER:
                return (f"partition column {req} lives on the resident side "
                        "of a non-inner join")
            for bk, pk in pairs:
                if bbig and pk == req:
                    req = bk
                    break
                if pbig and bk == req:
                    req = pk
                    break
            else:
                return (f"partition column {req} is not equi-joined to the "
                        "partitioned side")
        return _walk(big_side, req, big_ids, parts, catalog, covered)
    return (f"{type(node).__name__} on the partition flow is not "
            "partition-decomposable")


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def _partitions(reg, col: str, K: int, debug: bool):
    """The host partition pass of one table: hash(col) % K, a stable
    argsort (indices stay ascending within each partition) and exact
    per-partition bounds, cached per (column, K) on the registration:
    consecutive queries partitioning a table the same way (lineitem by
    l_orderkey for Q7/8/9/12/18/21) skip the hash and the argsort."""
    cached = reg.grace_parts.get((col, K))
    if cached is not None:
        return cached
    t0 = time.time()
    v, _ = reg.host.columns[col]
    part = _hash_mod(v, K)
    order = np.argsort(part, kind="stable")
    counts = np.bincount(part, minlength=K)
    bounds = np.concatenate([np.zeros(1, np.int64), np.cumsum(counts)])
    reg.grace_parts[(col, K)] = info = (order, bounds, int(counts.max()))
    if debug:
        print(f"[grace] partitioned {reg.name} by {col} into {K} "
              f"(max {int(counts.max())} rows) in {time.time() - t0:.1f}s", flush=True)
    return info


def run_grace(handle, gp: GracePlan, adaptive) -> DeviceTable:
    """Drive the partition loop: runtime/streaming.run_streamed's
    double-buffered dispatch/validate structure, with row-range chunks
    replaced by key-hash partitions of EVERY big scan and no cross-chunk
    visited machinery (partition locality makes the joins exact)."""
    catalog = handle.catalog
    root = gp.root
    chain = handle.chain
    debug = bool(os.environ.get("DFP_STREAM_DEBUG"))
    from ..models.optimizer import required_leaf_columns
    live = required_leaf_columns(root)
    uploader = handle.uploader()
    device = uploader.device

    chunk_rows = int(os.environ.get("DFP_STREAM_CHUNK_ROWS", 1 << 22))
    K = 1
    for label, (scan, col) in gp.parts.items():
        n = catalog.get(scan.table_name).host.num_rows
        K = max(K, -(-n // chunk_rows))

    # host partition pass, once per TABLE
    partinfo: Dict[str, tuple] = {}
    for label, (scan, col) in gp.parts.items():
        if scan.table_name not in partinfo:
            partinfo[scan.table_name] = _partitions(catalog.get(scan.table_name), col, K,
                                                    debug)

    caps, cols_of = {}, {}
    for label, (scan, _) in gp.parts.items():
        reg = catalog.get(scan.table_name)
        caps[label] = round_capacity(max(1024, partinfo[scan.table_name][2]))
        cols = (live.get(label) or set()) & set(reg.host.schema.names)
        cols_of[label] = cols or {reg.host.schema.names[0]}
    labels = sorted(gp.parts)

    resident = handle._leaf_tables(skip_labels=tuple(gp.parts))
    # EVERY scan of a partitioned label is big (parts keeps one
    # representative node per label, but a self-join without aliases scans
    # the same label twice — Q18/Q2)
    big_ids = {id(n) for n in root.walk()
               if isinstance(n, PScan) and n.label in gp.parts}

    def has_big(n) -> bool:
        return any(id(m) in big_ids for m in n.walk())

    merge = gp.merge
    merge_sub = {"agg": getattr(merge, "child", None), "union": merge,
                 "mask": getattr(merge, "probe", None)}[gp.kind]

    # frozen builds: joins on the partition flow whose build subtree is
    # fully resident are prepared ONCE outside the loop
    path_joins = [j for j in merge_sub.walk() if isinstance(j, PHashJoin)
                  and not has_big(j.build) and has_big(j.probe)]
    if gp.kind == "mask":
        # the mask-merge join's own resident build is frozen once too; its
        # visited mask IS the cross-partition accumulator
        path_joins.append(merge)
    prep_nodes = {id(m) for j in path_joins for m in j.build.walk()}
    prep_adaptive = [(k, n) for k, n in adaptive if id(n) in prep_nodes]
    # the union-merge JOIN stays adaptive (its output truncation must grow
    # its join cap); only the agg merge point is excluded (acc_cap owns it)
    sub_adaptive = [(k, n) for k, n in adaptive
                    if not (gp.merge_is_agg and n is merge)
                    and id(n) not in prep_nodes
                    and (any(m is n for m in merge_sub.walk())
                         # the mask-merge join runs inside the partition
                         # program: its candidate capacity stays adaptive
                         or (gp.kind == "mask" and n is merge))]
    head_adaptive = [(k, n) for k, n in adaptive
                     if not any(m is n for m in merge.walk())]

    # seed in-partition capacities at est/K: the planner's full-table
    # estimates are K times too big inside one partition
    for k, n in sub_adaptive:
        if k in handle._caps:
            continue
        est = 0.0
        if isinstance(n, (PFilter, PHashJoin)):
            est = n.est_rows
        elif isinstance(n, PAggregate):
            est = n.est_groups
        if est > 0:
            handle._caps[k] = round_capacity(int(2 * est / K), minimum=1024)

    prepared = prepare_builds(handle, path_joins, prep_adaptive, resident)

    if gp.kind == "agg":
        partial_specs, merge_specs, finishers = \
            decompose_for_partial(merge.aggs)
        acc_schema = agg_output_schema(merge.child.schema, merge.group_keys,
                                       partial_specs)
        acc_key = merge.node_id
    else:
        partial_specs = merge_specs = finishers = None
        acc_schema = merge.schema
        acc_key = ("gu", merge.join_id)
    acc_layout = packed_layout(acc_schema)

    def load(k: int):
        """Partition k of every partitioned label packed on the host and
        its upload issued: {label: (schema, layout, words, f64, rows)}."""
        t0 = time.perf_counter()
        packed = {}
        for label in labels:
            scan, _ = gp.parts[label]
            order, bounds, _mx = partinfo[scan.table_name]
            rows = order[bounds[k]:bounds[k + 1]]
            packed[label] = (len(rows),) + uploader.pack(
                catalog.get(scan.table_name).host, cols_of[label], 0, len(rows),
                caps[label], label, rows=rows)
        handle.metrics.host_pack_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        out = {}
        for label, (n, schema, layout, buf) in packed.items():
            words, f64 = uploader.upload(buf)
            out[label] = (schema, layout, words, f64, n)
        handle.metrics.upload_s += time.perf_counter() - t0
        if debug:
            print(f"[grace] partition {k} packed in {time.perf_counter() - t0:.2f}s",
                  flush=True)
        return out

    while True:   # accumulator-capacity restarts
        acc_cap = handle._caps.get(acc_key)
        if acc_cap is None:
            if gp.kind == "agg":
                est = (round_capacity(int(2 * merge.est_groups))
                       if merge.est_groups > 0 else 1 << 16)
                acc_cap = max(128, min(est, 1 << 24))
            elif gp.kind == "union":
                est = (round_capacity(int(2 * merge.est_rows))
                       if merge.est_rows > 0 else 1 << 20)
                acc_cap = max(1024, min(est, 1 << 24))
            else:     # mask: the accumulator is the build-sized bool mask
                acc_cap = prepared[merge.join_id].build.capacity
            handle._caps[acc_key] = acc_cap
        acc_real_cap = acc_cap if (gp.kind != "agg" or merge.group_keys) else 1
        zero = torch.zeros((), dtype=torch.int32, device=device)
        if gp.kind == "mask":
            # ORed in place by every partition (K10's accumulate mode)
            acc = torch.zeros(prepared[merge.join_id].build.capacity, dtype=torch.bool,
                              device=device)
        elif gp.kind == "union":
            # held packed and appended to in place by K13
            acc = (torch.zeros((acc_layout.width, acc_real_cap), dtype=torch.int32,
                               device=device),
                   torch.zeros((len(acc_layout.f64_fields), acc_real_cap),
                               dtype=torch.float64, device=device))
        else:
            acc = DeviceTable(acc_schema, null_columns_like(acc_schema, acc_real_cap, device=device),
                              zero)
        acc_rows = zero
        restart = False
        handle.metrics.streamed_chunks = 0
        mtotal = 0

        def step(parts, acc, acc_rows):
            """One partition through the merge subtree: (new accumulator,
            new row count, [merge total] + the adaptive totals)."""
            ctx = context(handle, prepared)
            tables = dict(resident)
            for label, chunk in parts.items():
                tables[label] = device_chunk(handle, *chunk)
            if gp.kind == "agg":
                child, row_filter = merge.fused_child(tables, ctx)
                out, mt = merge_partial(handle, merge, partial_specs, merge_specs, acc,
                                        child, row_filter, acc_cap)
                out_rows = out.num_rows
            elif gp.kind == "mask":
                # chunk-wise semi/anti against the frozen resident build:
                # emission is deferred, only the visited buffer folds
                ctx.stream_visited = {merge.join_id: acc}
                merge.execute(tables, ctx)
                out, out_rows, mt = acc, acc_rows, None
            else:
                # row-union append: this partition's rows after the
                # accumulated ones (K13; rows past acc_cap drop)
                res = merge.execute(tables, ctx)
                pt = pack_table(res, chain)
                if pt.layout != acc_layout:
                    raise ValueError("the union merge's output does not match its plan schema")
                out_rows = chain.append_rows(acc[0], acc[1], acc_rows, pt.packed,
                                             f64_matrix(pt), res.num_rows)
                out, mt = acc, out_rows
            handle.metrics.launches += 1
            return out, out_rows, [mt] + [ctx.join_totals.get(kk) for kk, _ in sub_adaptive]

        def validate(k, totals) -> bool:
            nonlocal restart, mtotal
            mt, *tot = read_totals(handle, totals)
            if debug:
                print(f"[grace] partition {k} mtotal={mt} totals={tot}", flush=True)
            if grow(handle, sub_adaptive, tot):
                handle.metrics.retries += 1
                return False
            if mt > acc_cap:
                handle._caps[acc_key] = round_capacity(max(mt, 2 * acc_cap), minimum=1024)
                handle.metrics.retries += 1
                restart = True
                return False
            handle.metrics.streamed_chunks += 1
            mtotal = mt
            return True

        pending = None   # (k, (acc_in, acc_rows_in), out, out_rows, totals)
        k = 0
        while not restart and (k < K or pending is not None):
            parts = load(k) if k < K else None
            if pending is not None:
                kk, acc_in, out, out_rows, totals = pending
                pending = None
                if not validate(kk, totals):
                    if restart:
                        break
                    k, (acc, acc_rows) = kk, acc_in
                    continue
                acc, acc_rows = out, out_rows
            if parts is None:
                break
            out, out_rows, totals = step(parts, acc, acc_rows)
            pending = (k, (acc, acc_rows), out, out_rows, totals)
            k += 1
        if restart:
            continue

        # persist settled capacities (accumulator shrunk to its true size;
        # the mask accumulator is build-sized and never shrinks)
        fit = round_capacity(max(mtotal, 1), minimum=1024)
        if gp.kind != "mask" and acc_cap > 4 * fit:
            handle._caps[acc_key] = fit
        handle.metrics.join_caps = dict(handle._caps)
        handle._save_caps(adaptive)

        # finish: complete the merge point, then run the head above it
        if gp.kind == "agg":
            out = finish_partial(acc, merge.group_keys, merge.aggs, finishers,
                                 merge.child.schema)
            key = merge.node_id
        elif gp.kind == "mask":
            out = _flush_input(merge, prepared[merge.join_id].build, acc, chain)
            key = merge.join_id
        else:   # the packed union accumulator, unpacked once
            words, f64 = acc
            out = unpack_table(PackedTable(words, dict(zip(acc_layout.f64_fields, f64)),
                                           acc_layout), acc_schema, acc_rows, chain)
            key = merge.join_id
        return finish(handle, root, merge, key, out, resident, head_adaptive, adaptive)
