"""Per-query out-of-core (morsel-streaming) eligibility report.

For every TPC-H query, plan it against a catalog and report whether the
plan streams its biggest scan (runtime/streaming.plan_stream), which scan,
through which join types, and the REASON when it cannot — the committed
eligibility table VERDICT r3 asked for ("a per-query SF100 eligibility
table with a reason for every exclusion").

Copied from the JAX package's `tpch/eligibility.py`, over the port's
`runtime/streaming.py` and `runtime/grace.py`. Planning touches no device;
`--device` names the session's, as the CLI's does.

Run: python -m datafusion_parallelism_tpu_torch.tpch.eligibility \
         --data-path data/sf100_bin --out results/sf100/eligibility.json
"""

from __future__ import annotations

import argparse
import json


def classify(plan, catalog):
    """-> dict describing stream eligibility of `plan`.

    plan_stream_ex is the single source of truth for both the decision and
    the rejection reason (the two previously drifted — round-4 advisor);
    this only renders its answer, trying the build/probe side-swap before
    declaring a plan ineligible (the same order the executor uses)."""
    from ..models.physical import PHashJoin, PScan
    from ..runtime.streaming import _contains, plan_stream_ex

    scans = [n for n in plan.walk() if isinstance(n, PScan)]
    if not scans:
        return {"eligible": False, "reason": "no scans"}
    scan = max(scans, key=lambda s: catalog.get(s.table_name).host.num_rows)
    info = {"streamed_table": scan.table_name,
            "streamed_rows": catalog.get(scan.table_name).host.num_rows}
    sp, reason = plan_stream_ex(plan, catalog)
    swapped = False
    if sp is None:
        sp, _ = plan_stream_ex(plan, catalog, allow_swap=True)
        swapped = sp is not None
    if sp is not None:
        info["eligible"] = True
        if swapped:
            info["via_side_swap"] = True
        info["visited_joins"] = [j.join_type.value for j in sp.visited_joins]
        info["path_join_types"] = [
            n.join_type.value for n in sp.agg.child.walk()
            if isinstance(n, PHashJoin) and _contains(n.probe, sp.scan)]
        return info
    # no row-range stream: grace-partitioning (key-hash partition every big
    # scan) covers the self-join / two-huge-table shapes
    import os
    from ..runtime.grace import plan_grace
    row_threshold = int(os.environ.get("DFP_STREAM_ROW_THRESHOLD", 1 << 26))
    gp, greason = plan_grace(plan, catalog, row_threshold)
    if gp is not None:
        info["eligible"] = True
        info["via_grace"] = True
        info["merge"] = "aggregate" if gp.merge_is_agg else "row-union"
        info["partition_columns"] = {
            label: f"{s.table_name}.{c}" for label, (s, c) in gp.parts.items()}
        return info
    info["eligible"] = False
    info["reason"] = reason
    info["grace_reason"] = greason
    return info


def main(argv=None):
    from .. import SessionContext
    from .cli import load_data_path
    from .queries import QUERIES

    ap = argparse.ArgumentParser()
    ap.add_argument("--data-path", required=True)
    ap.add_argument("--scale-factor", type=float, default=100.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    tables = load_data_path(args.data_path)
    ctx = SessionContext(device=args.device)
    for name, host in tables.items():
        # the binary tables' exact distinct counts, as the CLI registers them
        ctx.register_table(name, host, getattr(host, "statistics_hint", None))
    report = {}
    for q in sorted(QUERIES):
        try:
            h = ctx.sql(QUERIES[q])
            report[str(q)] = classify(h.plan, ctx.catalog)
        except Exception as e:  # pragma: no cover - report, don't die
            report[str(q)] = {"eligible": False,
                              "reason": f"planning error: {e!r}"}
        r = report[str(q)]
        print(f"Q{q:>2}: {'STREAMS' if r.get('eligible') else 'resident':8s} "
              f"{r.get('streamed_table', '')} "
              f"{r.get('visited_joins', '') or r.get('reason', '')}",
              flush=True)
    out = {"scale_factor": args.scale_factor, "queries": report}
    if args.out:
        import os
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
