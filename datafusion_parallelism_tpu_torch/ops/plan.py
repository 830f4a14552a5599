"""A single-table plan run operator by operator (torch).

`run_steps` runs a hand-built chain filter -> project -> aggregate ->
sort -> limit as `models/physical.py`'s operators run it, for plans that
are not SQL (the Q18- and Q20-shaped lineitem chains of `chip_smoke.py`
and `tools/profile_ops.py`; SQL goes through `runtime/executor.py`): a
filter under an aggregate becomes the aggregate's row filter
(PAggregate.fused_child), and a filter or grouped aggregate whose seeded
capacity overflows runs again at the grown one (run -> check -> grow).
"""

from __future__ import annotations

from ..kernels.chain import KERNELS, ChainKernels
from ..utils.columnar import DeviceTable, round_capacity
from .aggregate import hash_aggregate_counted
from .expressions import predicate_mask
from .filter import filter_table
from .project import project_table
from .sort import limit_table, sort_table


def seed_cap(capacity: int) -> int:
    """models/physical.py's seed capacity of a filter or grouped aggregate
    without a planner estimate (:127-128, :480-481)."""
    return min(capacity, max(1024, capacity // 4))


def run_steps(t: DeviceTable, steps, caps=None, kernels: ChainKernels = KERNELS):
    """Run plan steps over table t, bottom up: ("project", exprs[,
    out_fields]), ("filter", predicate), ("aggregate", group_keys, aggs),
    ("sort", keys), ("limit", n). A filter under an aggregate with only
    projections between them becomes the aggregate's row filter; a filter
    or grouped aggregate whose capacity overflows runs again at the grown
    one. `caps` keeps the learned capacities by step index across runs, as
    the executor's store does. Returns (table, grow retries)."""
    caps = {} if caps is None else caps
    retries, row_filter = 0, None

    def grown(i, run, limit):
        nonlocal retries
        while True:
            cap = caps.setdefault(i, seed_cap(limit))
            out, total = run(cap)
            if int(total) <= cap:
                return out
            caps[i] = min(limit, round_capacity(int(total), minimum=1024))
            retries += 1

    for i, step in enumerate(steps):
        kind = step[0]
        if kind == "project":
            t = project_table(t, step[1], step[2] if len(step) > 2 else None, kernels)
        elif kind == "filter":
            rest = [s[0] for s in steps[i + 1:] if s[0] != "project"]
            if rest and rest[0] == "aggregate":
                row_filter = predicate_mask(step[1], t, kernels)
            else:
                t = grown(i, lambda cap, t=t: filter_table(t, step[1], cap, kernels),
                          t.capacity)
        elif kind == "aggregate":
            keys, aggs, rf = step[1], step[2], row_filter
            if keys:
                t = grown(i, lambda cap, t=t: hash_aggregate_counted(t, keys, aggs, cap, rf,
                                                                     kernels), t.capacity)
            else:
                t = hash_aggregate_counted(t, keys, aggs, None, rf, kernels)[0]
            row_filter = None
        elif kind == "sort":
            t = sort_table(t, step[1], kernels)
        elif kind == "limit":
            t = limit_table(t, step[1])
        else:
            raise ValueError(f"step {kind!r}")
    return t, retries
