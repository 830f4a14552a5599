"""Query executor (torch): runs the physical plan eagerly on one device.

Counterpart of `datafusion_parallelism_tpu/runtime/executor.py`. Where the
JAX executor traces the plan into one XLA program, this one runs its
operators one after another on the tables' device, each through the kernel
tables it is given (`kernels`: the join's JoinKernels, `chain`: the
single-table operators' ChainKernels). Output capacities are
data-dependent: each run reports every adaptive node's true total as a
device tensor, the executor reads them all in one host sync, grows the
capacities that overflowed and runs again (run -> check -> grow), and
shrinks oversized ones for the next run (deferred, bounded to 64x a step).
Large multi-join plans run staged, join by join, under the JAX package's
rule.

Out of core, under the JAX package's rules and env variables
(runtime/executor.py:231-367 there): when the biggest scan's live upload
passes DFP_STREAM_THRESHOLD_BYTES (6 GiB) or its rows
DFP_STREAM_ROW_THRESHOLD (2^26), the plan streams that scan in chunks
(runtime/streaming.py, after a build/probe side-swap where needed) or,
where no row-range stream exists, partitions every big scan by join-key
hash (runtime/grace.py; DFP_FORCE_GRACE tries it first). A device
out-of-memory error (`torch.OutOfMemoryError`, and only that) on the
resident path, or in the streamed one, retries out of core after the
cached device tables are released and `torch.cuda.empty_cache()`; every
other error propagates. DFP_NO_STREAM and DFP_NO_GRACE switch the two
paths off.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, List, Optional

import torch

from ..kernels.chain import KERNELS as CHAIN_KERNELS
from ..kernels.chain import ChainKernels
from ..models.physical import (ExecContext, PhysicalPlan, PScan, find_adaptive,
                               find_joins)
from ..ops.join import KERNELS as JOIN_KERNELS
from ..ops.join import JoinKernels
from ..utils.catalog import Catalog
from ..utils.columnar import DeviceTable, HostTable, round_capacity
from .grace import plan_grace, run_grace
from .streaming import ChunkUploader, plan_stream, run_streamed, stream_upload_bytes

# don't shrink small overshoots: below this capacity the memory freed is
# not worth a changed capacity
_SHRINK_FLOOR = 1 << 20


class ExecutorMetrics:
    """Per-query metrics: runs (`launches`, one per plan, stage, chunk or
    partition run), grow retries, the settled capacities, seconds spent
    running, whether the last run was staged, the route it took
    ("resident", "streamed", "streamed after a side-swap", "grace agg",
    "grace union", "grace mask"), and out of core the chunks or partitions
    run (`streamed_chunks`), the seconds of host packing (`host_pack_s`)
    and of issuing the uploads (`upload_s`). Distributed
    (runtime/distributed_executor.py): the bytes the collectives of the
    last run delivered to one partition (`comm_bytes`; staged, summed over
    the stages' last runs), each join's local candidate total per
    partition (`balance`, join_id -> [P]), and per stage the bytes a
    partition holds (`stage_bytes`); streamed through the partitions
    (runtime/distributed_streaming.py), each chunk's events
    (`stream_timeline`: "pack_upload" with t0 and t1, "dispatch" and
    "validated" with t, seconds from the loop's start)."""

    def __init__(self):
        self.launches = 0
        self.retries = 0
        self.run_time_s = 0.0
        self.join_caps: Dict[int, int] = {}
        self.staged = False
        self.route = "resident"
        self.streamed_chunks = 0
        self.host_pack_s = 0.0
        self.upload_s = 0.0
        self.comm_bytes = 0
        self.balance: Dict[int, list] = {}
        self.stage_bytes: list = []
        self.stream_timeline: list = []


def _debug_retry(kind, key, node, cap, total, fit):
    """DFP_DEBUG_RETRIES=1: print each capacity correction (which node, how
    far off the estimate was)."""
    if os.environ.get("DFP_DEBUG_RETRIES"):
        desc = node.describe() if node is not None else "?"
        print(f"[retry:{kind}] cap[{key}] {cap} -> {fit} (true total {total})"
              f" at {desc}", flush=True)


def _read_totals(totals: List[Optional[torch.Tensor]]) -> List[int]:
    """Every adaptive total in ONE device-to-host copy (one sync); None (a
    node under a materialized stage, which did not run) reads 0."""
    ran = [t.reshape(()).to(torch.int64) for t in totals if t is not None]
    values = iter(torch.stack(ran).tolist() if ran else [])
    return [0 if t is None else int(next(values)) for t in totals]


class QueryHandle:
    """A planned, re-runnable query."""

    def __init__(self, plan: PhysicalPlan, catalog: Catalog,
                 scalar_subqueries=(), config=None, *,
                 kernels: JoinKernels = JOIN_KERNELS, chain: ChainKernels = CHAIN_KERNELS):
        self.plan = plan
        self.catalog = catalog
        self.scalar_subqueries = list(scalar_subqueries)
        self.config = config
        self.kernels = kernels
        self.chain = chain
        self.metrics = ExecutorMetrics()
        self._caps: Dict[int, int] = {}
        self._caps_loaded = False
        self._sub_handles = None   # cached scalar-subquery QueryHandles
        self._uploader = None      # out-of-core host buffers, made at first use
        self._swapped = False      # a side-swap made the plan streamable

    # -- learned-capacity persistence ----------------------------------------
    # the settled capacities per (plan, input sizes), so that later processes
    # run the final capacities at once instead of paying grow retries
    def _caps_store_path(self):
        return os.path.join(os.path.expanduser("~"), ".cache", "dfp_torch",
                            "learned_caps.json")

    def _caps_signature(self):
        leaf = sorted((n.label, self.catalog.get(n.table_name).host.num_rows)
                      for n in self.plan.walk() if isinstance(n, PScan))
        raw = self.plan.tree() + repr(leaf)
        return hashlib.sha1(raw.encode()).hexdigest()

    def _load_caps(self, adaptive):
        self._caps_loaded = True
        if os.environ.get("DFP_NO_CAP_STORE"):
            return
        try:
            with open(self._caps_store_path()) as f:
                stored = json.load(f).get(self._caps_signature())
            if stored and len(stored) == len(adaptive):
                for (k, _), cap in zip(adaptive, stored):
                    if cap is not None:  # None = node was fused away
                        self._caps[k] = cap
        except (OSError, ValueError):
            pass

    def _save_caps(self, adaptive):
        if os.environ.get("DFP_NO_CAP_STORE"):
            return
        path = self._caps_store_path()
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            try:
                with open(path) as f:
                    data = json.load(f)
            except (OSError, ValueError):
                data = {}
            data[self._caps_signature()] = [self._caps.get(k) for k, _ in adaptive]
            with open(path, "w") as f:
                json.dump(data, f)
        except OSError:
            pass

    # -- inputs ---------------------------------------------------------------
    def _live_columns(self) -> Dict[str, set]:
        """Plan-live column set per TABLE (union over its scan labels)."""
        from ..models.optimizer import required_leaf_columns
        live = required_leaf_columns(self.plan)
        per_table: Dict[str, set] = {}
        for node in self.plan.walk():
            if isinstance(node, PScan):
                per_table.setdefault(node.table_name, set()).update(
                    live.get(node.label) or set())
        return per_table

    def _leaf_tables(self, skip_labels=()) -> Dict[str, DeviceTable]:
        """Upload each scan's LIVE columns only, one upload per table (the
        union over its labels), cached on the registration.
        `skip_labels`: scans left out (streamed in chunks instead)."""
        per_table = self._live_columns()
        tables = {}
        for node in self.plan.walk():
            if isinstance(node, PScan) and node.label not in tables \
                    and node.label not in skip_labels:
                reg = self.catalog.get(node.table_name)
                cols = per_table[node.table_name] & set(reg.host.schema.names)
                if not cols:
                    cols = {reg.host.schema.names[0]}
                dev = reg.device_subset(frozenset(cols))
                tables[node.label] = dev.rename(
                    {c: f"{node.label}.{c}" for c in dev.schema.names})
        return tables

    # -- execution --------------------------------------------------------------
    def run(self) -> DeviceTable:
        # uncorrelated scalar subqueries run first; their values are baked
        # in, once per handle (registered tables are immutable)
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

        adaptive = find_adaptive(self.plan)
        if not self._caps_loaded:
            self._load_caps(adaptive)
        self.metrics.route = "resident"

        # Morsel streaming: when the biggest scan's upload alone breaks the
        # device budget and it reaches the top aggregate row-linearly,
        # chunk it through the plan instead of materializing it
        sp = None
        if not os.environ.get("DFP_NO_STREAM"):
            need_stream = self._need_stream()
            if need_stream and os.environ.get("DFP_FORCE_GRACE"):
                # skip the streamed attempt outright (plans whose resident
                # stream set is known to break the device)
                gp = self._plan_grace()
                if gp is not None:
                    return self._run_grace(gp, adaptive)
            sp = plan_stream(self.plan, self.catalog)
            if sp is None and need_stream:
                # side-swap rule: flip joins whose BUILD side carries the
                # stream candidate so the big table probes
                sp = plan_stream(self.plan, self.catalog, allow_swap=True)
                self._swapped = self._swapped or sp is not None
            if sp is not None and need_stream:
                return self._stream_or_grace(sp, adaptive)
            if sp is None and need_stream:
                # self-joins of the big table (Q2/Q17/Q18/Q21): no row-range
                # stream exists; grace-partition every big scan by join key
                gp = self._plan_grace()
                if gp is not None:
                    return self._run_grace(gp, adaptive)

        gp = None
        try:
            return self._run_resident(adaptive)
        except torch.OutOfMemoryError:
            # a device out-of-memory error downgrades to the out-of-core
            # path when one exists
            if sp is None and not os.environ.get("DFP_NO_STREAM"):
                # resident ran out of memory: the side-swap is now justified
                # even if the size trigger didn't fire
                sp = plan_stream(self.plan, self.catalog, allow_swap=True)
                self._swapped = self._swapped or sp is not None
                if sp is None:
                    gp = self._plan_grace()
            if sp is None and gp is None:
                raise
        # out of the except block, so the failed run's tensors are freed
        self._drop_device_caches()
        if gp is not None:
            return self._run_grace(gp, adaptive)
        return self._stream_or_grace(sp, adaptive)

    def _stream_or_grace(self, sp, adaptive) -> DeviceTable:
        """The streamed run; if its RESIDENT set (the frozen builds) breaks
        the device, key-hash partitioning, which bounds every side."""
        try:
            # the leaf upload itself can run out of memory, so it sits
            # inside the fallback scope
            return self._run_streamed(sp, adaptive)
        except torch.OutOfMemoryError:
            gp = self._plan_grace()
            if gp is None:
                raise
        self._drop_device_caches()
        return self._run_grace(gp, adaptive)

    def _need_stream(self) -> bool:
        """The stream trigger, decided from the biggest scan directly (the
        candidate plan_stream picks): its live upload past
        DFP_STREAM_THRESHOLD_BYTES or its rows past
        DFP_STREAM_ROW_THRESHOLD."""
        scans = [n for n in self.plan.walk() if isinstance(n, PScan)]
        if not scans:
            return False
        big = max(scans, key=lambda s: self.catalog.get(s.table_name).host.num_rows)
        live_big = self._live_columns().get(big.table_name)
        threshold = int(os.environ.get("DFP_STREAM_THRESHOLD_BYTES", 6 << 30))
        row_threshold = int(os.environ.get("DFP_STREAM_ROW_THRESHOLD", 1 << 26))
        return (stream_upload_bytes(self.catalog, big.table_name, live_big) > threshold
                or self.catalog.get(big.table_name).host.num_rows > row_threshold)

    def uploader(self) -> ChunkUploader:
        """The handle's out-of-core host buffers and copy stream."""
        if self._uploader is None:
            self._uploader = ChunkUploader(self.catalog.device)
        return self._uploader

    def _run_streamed(self, sp, adaptive) -> DeviceTable:
        self.metrics.route = "streamed after a side-swap" if self._swapped else "streamed"
        live = self._live_columns().get(sp.scan.table_name)
        resident = self._leaf_tables(skip_labels=(sp.scan.label,))
        return run_streamed(self, sp, resident, live, adaptive)

    def _drop_device_caches(self):
        """Release every registration's cached device tables so an
        out-of-core retry starts with free device memory."""
        for node in self.plan.walk():
            if isinstance(node, PScan):
                self.catalog.get(node.table_name).release_device()
        if self.catalog.device.type == "cuda":
            torch.cuda.empty_cache()

    def _plan_grace(self):
        if os.environ.get("DFP_NO_GRACE"):
            return None
        row_threshold = int(os.environ.get("DFP_STREAM_ROW_THRESHOLD", 1 << 26))
        gp, _ = plan_grace(self.plan, self.catalog, row_threshold)
        return gp

    def _run_grace(self, gp, adaptive) -> DeviceTable:
        self.metrics.route = f"grace {gp.kind}"
        return run_grace(self, gp, adaptive)

    def _settle(self, pairs, totals) -> bool:
        """Grow every capacity whose total overflowed (True if any did);
        shrink oversized ones for the next run."""
        overflow = False
        for (k, n), total in zip(pairs, totals):
            # nodes fused away report 0 and never own a capacity
            cap = self._caps.get(k, total)
            fit = round_capacity(max(total, 1), minimum=1024)
            if total > cap:
                self._caps[k] = fit
                overflow = True
                _debug_retry("grow", k, n, cap, total, fit)
            elif total > 0 and cap > 4 * fit and cap > _SHRINK_FLOOR:
                # deferred, bounded to 64x a step: capacities couple (a
                # smaller build shrinks its bucket table, raising downstream
                # false-hit candidates), so a full collapse can ping-pong
                self._caps[k] = max(fit, cap >> 6)
                _debug_retry("shrink", k, n, cap, total, self._caps[k])
        self.metrics.join_caps = dict(self._caps)
        return overflow

    def _execute(self, node, tables, pairs, materialized=None):
        """One run of `node`: (output, the totals of `pairs`' nodes)."""
        ctx = ExecContext(self._caps, materialized, self.kernels, self.chain)
        t0 = time.perf_counter()
        self.metrics.launches += 1
        out = node.execute(tables, ctx)
        totals = _read_totals([ctx.join_totals.get(k) for k, _ in pairs])
        self.metrics.run_time_s += time.perf_counter() - t0
        return out, totals

    def _run_resident(self, adaptive) -> DeviceTable:
        tables = self._leaf_tables()
        # staged execution for large plans: materializing at join
        # boundaries bounds each stage's working set and makes overflow
        # retries per stage (threshold: big inputs and more than one join)
        total_cap = sum(t.capacity * len(t.schema.fields) for t in tables.values())
        threshold = int(os.environ.get("DFP_STAGE_THRESHOLD_BYTES", 1 << 30))
        joins = find_joins(self.plan)
        self.metrics.staged = total_cap * 8 > threshold and len(joins) > 1
        if self.metrics.staged:
            return self._run_staged(tables, adaptive, joins)
        while True:
            out, totals = self._execute(self.plan, tables, adaptive)
            if not self._settle(adaptive, totals):
                self._save_caps(adaptive)
                return out
            self.metrics.retries += 1
            del out

    def _run_staged(self, tables, adaptive, joins) -> DeviceTable:
        """Run join subtrees bottom-up, each to a materialized result that
        later stages read (ctx.materialized); overflow retries per stage."""
        order: List = []
        seen = set()
        join_ids = {id(j) for j in joins}

        def post(n):
            for c in n.children():
                post(c)
            if id(n) in join_ids and id(n) not in seen:
                seen.add(id(n))
                order.append(n)

        post(self.plan)
        mats: Dict[int, DeviceTable] = {}
        stages = [(True, j) for j in order if j is not self.plan]
        stages.append((False, self.plan))
        for materialize, node in stages:
            sub_adaptive = [(k, n) for k, n in adaptive if any(m is n for m in node.walk())]
            while True:
                out, totals = self._execute(node, tables, sub_adaptive, dict(mats))
                if not self._settle(sub_adaptive, totals):
                    break
                self.metrics.retries += 1
                del out
            if materialize:
                mats[node.join_id] = out
        self._save_caps(adaptive)
        return out

    def collect(self) -> HostTable:
        return self.run().to_host()

    def explain(self) -> str:
        return self.plan.tree()

    def analyze(self) -> str:
        """EXPLAIN ANALYZE: per-operator output rows and time, each subtree
        run on its own (cumulative, like postgres EXPLAIN ANALYZE), timed
        from a synchronize to a synchronize when the tables are on a CUDA
        device."""
        self.run()  # settle capacities / fill scalar subqueries
        tables = self._leaf_tables()
        dev = next(iter(tables.values())).device if tables else torch.device("cpu")

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        lines = []

        def visit(node, depth):
            ctx = ExecContext(dict(self._caps), None, self.kernels, self.chain)
            sync()
            t0 = time.perf_counter()
            out = node.execute(tables, ctx)
            sync()
            dt = time.perf_counter() - t0
            lines.append("  " * depth + f"{node.describe()}  [rows={int(out.num_rows)} "
                         f"cumulative={dt * 1e3:.2f}ms]")
            for c in node.children():
                visit(c, depth + 1)

        visit(self.plan, 0)
        return "\n".join(lines)
