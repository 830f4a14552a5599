"""Physical-plan optimizer rules.

Analog of reference L4 (src/operator/use_parallel_hash_join_rule.rs appends
rules to DataFusion's default set, parse_sql.rs:37-54). The planner already
performs join ordering and build-side selection inline; this module holds the
plan-to-plan rewrite rules that run afterwards:

  * `PruneColumnsRule` — column pruning above scans and through joins: the
    reference leans on DataFusion's projection pushdown and re-wraps joins in
    ProjectionExec (use_parallel_hash_join_rule.rs:108-131). Here width
    matters doubly: the join's packed row-gathers move whole rows, so every
    dead column costs HBM bandwidth in the hot path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Set

from ..ops.expressions import BinOp, Col, Expr
from ..ops.join import JoinType
from ..utils.columnar import Schema
from .physical import (PAggregate, PFilter, PHashJoin, PLimit, PProject,
                       PScan, PSort, PhysicalPlan)


def expr_columns(e: Expr, out: Set[str]) -> None:
    """Collect all Col names referenced by an expression tree."""
    if isinstance(e, Col):
        out.add(e.name)
        return
    if dataclasses.is_dataclass(e):
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            _walk_value(v, out)


def _walk_value(v, out: Set[str]) -> None:
    if isinstance(v, Expr):
        expr_columns(v, out)
    elif isinstance(v, (list, tuple)):
        for item in v:
            _walk_value(item, out)


class PruneColumnsRule:
    """Narrow every subtree to the columns its consumers actually read."""

    def optimize(self, plan: PhysicalPlan) -> PhysicalPlan:
        return self._prune(plan, set(plan.schema.names))

    def _project_to(self, node: PhysicalPlan, required: Set[str]) -> PhysicalPlan:
        names = [n for n in node.schema.names if n in required]
        if len(names) == len(node.schema.names):
            return node
        fields = [node.schema.field(n) for n in names]
        return PProject(node, [(Col(n), n) for n in names], fields)

    def _prune(self, node: PhysicalPlan, required: Set[str]) -> PhysicalPlan:
        required = required & set(node.schema.names)
        if not required:  # consumer only counts rows: keep one column
            required = {node.schema.names[0]}

        if isinstance(node, PScan):
            return self._project_to(node, required)

        if isinstance(node, PProject):
            kept = [(e, n) for (e, n), f in zip(node.exprs, node.out_fields)
                    if n in required]
            kept_fields = [f for f in node.out_fields if f.name in required]
            if not kept:  # degenerate; keep everything
                kept, kept_fields = node.exprs, node.out_fields
            child_req: Set[str] = set()
            for e, _ in kept:
                expr_columns(e, child_req)
            child = self._prune(node.child, child_req)
            return PProject(child, kept, kept_fields)

        if isinstance(node, PFilter):
            child_req = set(required)
            expr_columns(node.predicate, child_req)
            child = self._prune(node.child, child_req)
            # carry est_rows: losing it silently demoted every optimized
            # filter to the capacity//4 default (SF1 Q3's two range filters
            # each paid an overflow-retry recompile from exactly this)
            out = PFilter(child, node.predicate, est_rows=node.est_rows)
            out.node_id = node.node_id  # executor capacities key on this
            return self._project_to(out, required)

        if isinstance(node, PHashJoin):
            res_cols: Set[str] = set()
            if node.residual is not None:
                expr_columns(node.residual, res_cols)
            breq = ((required | res_cols) & set(node.build.schema.names)) \
                | set(node.build_keys)
            preq = ((required | res_cols) & set(node.probe.schema.names)) \
                | set(node.probe_keys)
            build = self._prune(node.build, breq)
            probe = self._prune(node.probe, preq)
            out = PHashJoin(build, probe, node.build_keys, node.probe_keys,
                            node.join_type, node.strategy, node.residual,
                            node.dist_mode, node.est_rows)
            out.join_id = node.join_id  # executor capacities key on this
            out.__post_init__()
            return self._project_to(out, required)

        if isinstance(node, PAggregate):
            child_req = set(node.group_keys)
            for a in node.aggs:
                if a.input:
                    child_req.add(a.input)
            child = self._prune(node.child, child_req)
            out = PAggregate(child, node.group_keys, node.aggs,
                             node.est_groups)
            out.node_id = node.node_id
            return out

        if isinstance(node, PSort):
            child_req = required | {k.column for k in node.keys}
            child = self._prune(node.child, child_req)
            return PSort(child, node.keys)

        if isinstance(node, PLimit):
            return PLimit(self._prune(node.child, required), node.n)

        return node


class CoalesceFiltersRule:
    """Merge chains of PFilter into one AND predicate: each filter pays a
    full row compaction (pack + row-gather), so N stacked single-column
    predicates cost N compactions where one suffices."""

    def optimize(self, plan: PhysicalPlan) -> PhysicalPlan:
        return self._rewrite(plan)

    def _rewrite(self, node: PhysicalPlan) -> PhysicalPlan:
        if isinstance(node, PFilter):
            preds = [node.predicate]
            child = node.child
            while isinstance(child, PFilter):
                preds.append(child.predicate)
                child = child.child
            child = self._rewrite(child)
            combined = preds[0]
            for p in preds[1:]:
                combined = BinOp("and", combined, p)
            # the OUTERMOST filter's estimate already multiplies every
            # conjunct's selectivity (the planner updates rel.est_rows as it
            # stacks filters), so it is the right estimate for the merge
            out = PFilter(child, combined, est_rows=node.est_rows)
            out.node_id = node.node_id
            return out
        for attr in ("child", "build", "probe"):
            if hasattr(node, attr):
                setattr(node, attr, self._rewrite(getattr(node, attr)))
        if hasattr(node, "__post_init__"):
            node.__post_init__()
        return node


class PushSemiJoinRule:
    """Push semi/anti joins below inner joins toward the side that owns the
    semi keys. Decorrelated IN/EXISTS subqueries attach at the WHERE level —
    above the whole FROM-clause join tree — so Q18's HAVING-subquery filter
    otherwise probes the full customer⨝orders⨝lineitem (60M rows at SF10,
    an 8 GB candidate capacity that OOMs a v5e) instead of filtering the
    15M-row orders scan down to a few hundred rows first. Filtering a side
    of an inner join before or after the join is equivalent (semi/anti
    never duplicate rows and test only key membership), so the rewrite is
    safe through PProject (identity columns), PFilter, and INNER joins.
    Residual-carrying semi joins (correlated predicates) are left alone.

    The reference reaches the same shape via DataFusion's
    decorrelate_predicate_subquery, which plants the semi join at the
    subquery's own filter level rather than above the join tree."""

    SEMI = (JoinType.LEFT_SEMI, JoinType.RIGHT_SEMI)
    ANTI = (JoinType.LEFT_ANTI, JoinType.RIGHT_ANTI)

    def __init__(self, catalog):
        self.catalog = catalog

    def optimize(self, plan: PhysicalPlan) -> PhysicalPlan:
        return self._rewrite(plan)

    def _rewrite(self, node: PhysicalPlan) -> PhysicalPlan:
        for attr in ("child", "build", "probe"):
            if hasattr(node, attr):
                setattr(node, attr, self._rewrite(getattr(node, attr)))
        if (isinstance(node, PHashJoin)
                and node.join_type in self.SEMI + self.ANTI):
            node = self._try_push(node)
        if hasattr(node, "__post_init__"):
            node.__post_init__()
        return node

    def _try_push(self, sj: PHashJoin) -> PHashJoin:
        from .planner import _estimate_rows, _join_candidates_est
        if sj.residual is not None:
            return sj
        right_side = sj.join_type in (JoinType.RIGHT_SEMI,
                                      JoinType.RIGHT_ANTI)
        filtered = sj.probe if right_side else sj.build
        keys = list(sj.probe_keys if right_side else sj.build_keys)

        # descend through projects/filters/inner joins to the deepest
        # subtree that still carries every semi key as a bare column
        spine: List = []  # (node, attr we descended through)
        cur = filtered
        passed_join = False
        while True:
            if isinstance(cur, PProject):
                mapped = []
                for k in keys:
                    e = next((e for e, n in cur.exprs if n == k), None)
                    if not isinstance(e, Col):
                        mapped = None
                        break
                    mapped.append(e.name)
                if mapped is None:
                    break
                spine.append((cur, "child"))
                keys = mapped
                cur = cur.child
            elif isinstance(cur, PFilter):
                spine.append((cur, "child"))
                cur = cur.child
            elif (isinstance(cur, PHashJoin)
                  and cur.join_type is JoinType.INNER):
                if all(k in cur.build.schema.names for k in keys):
                    spine.append((cur, "build"))
                    cur = cur.build
                elif all(k in cur.probe.schema.names for k in keys):
                    spine.append((cur, "probe"))
                    cur = cur.probe
                else:
                    break
                passed_join = True
            else:
                break
        if not passed_join:
            return sj

        target = cur
        keep = sj.build if right_side else sj.probe  # the key-set side
        t_est = _estimate_rows(target, self.catalog)
        k_est = _estimate_rows(keep, self.catalog)
        if right_side:
            cand = _join_candidates_est(keep, target, sj.build_keys, keys,
                                        k_est, t_est, self.catalog)
            new_sj = PHashJoin(keep, target, sj.build_keys, keys,
                               sj.join_type, sj.strategy, None,
                               sj.dist_mode, cand)
        else:
            cand = _join_candidates_est(target, keep, keys, sj.probe_keys,
                                        t_est, k_est, self.catalog)
            new_sj = PHashJoin(target, keep, keys, sj.probe_keys,
                               sj.join_type, sj.strategy, None,
                               sj.dist_mode, cand)
        new_sj.join_id = sj.join_id  # executor capacities key on this
        new_sj.__post_init__()

        # scale every estimate on the spine by the semi's reduction factor
        # (anti joins keep factor 1: no reliable reduction estimate)
        factor = 1.0
        if sj.join_type in self.SEMI and t_est > 0:
            factor = max(1e-6, min(1.0, min(t_est, cand) / t_est))

        child: PhysicalPlan = new_sj
        for node, attr in reversed(spine):
            if isinstance(node, PHashJoin):
                b = child if attr == "build" else node.build
                p = child if attr == "probe" else node.probe
                nn = PHashJoin(b, p, node.build_keys, node.probe_keys,
                               node.join_type, node.strategy, node.residual,
                               node.dist_mode,
                               max(1.0, node.est_rows * factor))
                nn.join_id = node.join_id
                nn.__post_init__()
            elif isinstance(node, PFilter):
                nn = PFilter(child, node.predicate,
                             max(0.0, node.est_rows * factor))
                nn.node_id = node.node_id
            else:  # PProject
                nn = PProject(child, node.exprs, node.out_fields)
            child = nn
        return child


class ChooseDistModeRule:
    """Pick each join's distributed execution mode from statistics — the
    analog of the reference's broadcast-join threshold (its benchmark sizes
    tables 'above the maximum threshold for broadcast joins',
    benches/my_benchmark.rs:159) plus the salted-skew substitute for work
    stealing. BROADCAST and SALTED both cover all 8 join types — the
    reference's work stealing wraps every join type too
    (use_work_stealing_repartition_rule.rs:14-37). Build-emitting types
    (LEFT*/FULL) dedup their replicated build rows via a mesh-reduced
    visited mask + owner-partition emission: over the whole build under
    broadcast (distributed_executor._broadcast_build_emitting), over
    exactly the heavy-key block under salting
    (_salted_build_emitting)."""

    PROBE_DRIVEN = ("inner", "right", "right_semi", "right_anti")

    def __init__(self, catalog, config):
        self.catalog = catalog
        self.config = config

    def optimize(self, plan: PhysicalPlan) -> PhysicalPlan:
        from .planner import _estimate_rows
        for node in plan.walk():
            if not isinstance(node, PHashJoin):
                continue
            # record the probe hot-key share for EVERY join (LEFT*/FULL
            # shuffle their probe sides too): when salting is off, the
            # executor seeds send capacities from it instead of paying a
            # dropped-row retry under skew
            node.probe_mcv_share = self._probe_share(node) or 0.0
            best = _estimate_rows(node.build, self.catalog)
            if best <= getattr(self.config, "broadcast_threshold", 0):
                node.dist_mode = "broadcast"
                continue
            salting = getattr(self.config, "skew_salting", None)
            if salting or (salting is None and self._probe_is_skewed(node)):
                node.dist_mode = "skew_salted"
        return plan

    def _probe_share(self, node: PHashJoin):
        """Probe-side hot-key share from the catalog's cheap per-column
        histogram (mcv_share_of); None when a probe key does not resolve to
        a base scan column (renamed through expressions)."""
        scans = {n.label: n for n in node.probe.walk() if isinstance(n, PScan)}
        share = None
        for key in node.probe_keys:
            label, _, col = key.partition(".")
            scan = scans.get(label)
            # scan schemas carry qualified "label.col" names; the key must
            # resolve to one of them (not a projection-computed column)
            if scan is None or key not in {f.name for f in scan.schema.fields}:
                return None
            s = self.catalog.get(scan.table_name).mcv_share_of(col)
            # composite keys: the hot (k1,k2) pair share <= each column's own
            share = s if share is None else min(share, s)
        return share

    def _probe_is_skewed(self, node: PHashJoin) -> bool:
        """Automatic salting: fire when hash-routing the probe side would
        land one key's rows on a single device at >= skew_threshold x the
        balanced share (hot share * P)."""
        P = getattr(self.config, "target_partitions", 1)
        if P <= 1:
            return False
        threshold = getattr(self.config, "skew_threshold", 4.0)
        share = self._probe_share(node)
        return share is not None and share * P >= threshold


def optimize_plan(plan: PhysicalPlan, catalog=None, config=None) -> PhysicalPlan:
    plan = CoalesceFiltersRule().optimize(plan)
    if catalog is not None:
        plan = PushSemiJoinRule(catalog).optimize(plan)
    plan = PruneColumnsRule().optimize(plan)
    if catalog is not None and config is not None:
        plan = ChooseDistModeRule(catalog, config).optimize(plan)
    return plan


def required_leaf_columns(plan) -> Dict[str, Set[str]]:
    """Per scan label, the set of BASE column names any node in the plan can
    read. Everything an operator touches goes through an expression, a join
    key, a group/agg input, or a sort key; a column referenced by none of
    those (and not in the final output) is dead weight — the executor uses
    this to upload only live columns (a full SF10 lineitem is ~6 GB in HBM,
    its 7 live columns ~2.5 GB)."""
    refs: Set[str] = set(plan.schema.names)
    labels = set()
    for node in plan.walk():
        if isinstance(node, PScan):
            labels.add(node.label)
        elif isinstance(node, PProject):
            for e, _ in node.exprs:
                expr_columns(e, refs)
        elif isinstance(node, PFilter):
            expr_columns(node.predicate, refs)
        elif isinstance(node, PHashJoin):
            refs.update(node.build_keys)
            refs.update(node.probe_keys)
            if node.residual is not None:
                expr_columns(node.residual, refs)
        elif isinstance(node, PAggregate):
            refs.update(node.group_keys)
            refs.update(a.input for a in node.aggs if a.input)
        elif isinstance(node, PSort):
            refs.update(k.column for k in node.keys)
    out: Dict[str, Set[str]] = {}
    for label in labels:
        pre = label + "."
        cols = {r.split(".", 1)[1] for r in refs if r.startswith(pre)}
        out[label] = cols
    return out
