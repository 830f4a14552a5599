"""Morsel-streaming execution (torch): chunk the biggest scan through the plan.

Counterpart of `datafusion_parallelism_tpu/runtime/streaming.py`, with its
rules and its rejection reasons word for word. ONE designated scan (the
largest, TPC-H lineitem) streams through the plan in fixed-size row-range
chunks: per chunk, host pack -> upload -> unpack (K12) -> filter / project /
probe -> PARTIAL aggregate; a merge aggregate folds each chunk's partials
into an accumulator (decompose_for_partial). The device holds the resident
(non-streamed) tables, one or two chunks and the accumulator.

The streamed scan must reach the MERGE-POINT aggregate (the lowest
aggregate above it) through per-chunk-decomposable operators: Filter and
Project; a join whose PROBE side carries the stream (INNER / RIGHT /
RIGHT_SEMI / RIGHT_ANTI emit per probe row; LEFT / FULL / LEFT_SEMI /
LEFT_ANTI fold a device-resident visited buffer over the frozen build side
across chunks, K10's accumulate mode, and a FLUSH pass per such join emits
the deferred build rows after the last chunk). Anything may sit above the
merge point; it runs once on the merged result.

Eager where the JAX package compiles the chunk step once: each chunk's
operators are dispatched in turn. The loop is double-buffered as in the
JAX package: chunk i+1 is packed on the host and its upload issued before
the loop blocks on chunk i's totals (all read in one copy). Host buffers
are pinned and used again (two per label, layout and capacity), and the
upload runs on a side stream that the compute stream waits on. Join and
filter overflows retry the CURRENT chunk only; an accumulator overflow
restarts the stream with the grown capacity.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from ..models.physical import (ExecContext, PAggregate, PFilter, PHashJoin,
                               PProject, PScan, PhysicalPlan)
from ..ops.aggregate import (agg_output_schema, decompose_for_partial,
                             finish_partial, hash_aggregate_counted)
from ..ops.join import JoinType, prepare_build
from ..utils.columnar import (DeviceTable, PackedTable, Schema, concat_tables,
                              filter_rows, hstack_tables, null_columns_like,
                              pack_host_slice, packed_layout, round_capacity,
                              unpack_table)

_LINEAR_JOIN_TYPES = (JoinType.INNER, JoinType.RIGHT, JoinType.RIGHT_SEMI,
                      JoinType.RIGHT_ANTI)
# build-emitting types: stream-eligible via the cross-chunk visited mask
_VISITED_JOIN_TYPES = (JoinType.LEFT, JoinType.FULL, JoinType.LEFT_SEMI,
                       JoinType.LEFT_ANTI)


@dataclass
class StreamPlan:
    agg: PAggregate              # the cross-chunk merge point (lowest agg)
    root: PhysicalPlan           # full plan; nodes above agg run at finish
    scan: PScan                  # the streamed scan
    # build-emitting joins on the stream path, INNERMOST (closest to the
    # scan) first — the flush order: a lower join's deferred rows probe the
    # higher joins and mark their visited masks before those flush
    visited_joins: List[PHashJoin]


def _contains(node: PhysicalPlan, scan: PScan) -> bool:
    return any(n is scan for n in node.walk())


def _path_to(node: PhysicalPlan, scan: PScan) -> Optional[List[PhysicalPlan]]:
    if node is scan:
        return [node]
    for c in node.children():
        p = _path_to(c, scan)
        if p is not None:
            return [node] + p
    return None


def _swap_join(j: PHashJoin) -> None:
    """In-place build/probe side swap. Every join type remaps under a swap
    (INNER/FULL are symmetric; LEFT<->RIGHT families mirror — the flip the
    planner's statistics-driven build-side choice uses). join_id is
    preserved (the handle's capacities key on it); the side-specific
    distributed settings are reset, as the JAX package does."""
    from ..models.planner import _flip_join_type
    j.build, j.probe = j.probe, j.build
    j.build_keys, j.probe_keys = j.probe_keys, j.build_keys
    j.join_type = _flip_join_type(j.join_type)
    j.probe_mcv_share = 0.0
    j.dist_mode = "partitioned"
    j.__post_init__()


def plan_stream(plan: PhysicalPlan, catalog,
                allow_swap: bool = False) -> Optional[StreamPlan]:
    return plan_stream_ex(plan, catalog, allow_swap)[0]


def plan_stream_ex(plan: PhysicalPlan, catalog, allow_swap: bool = False):
    """-> (StreamPlan | None, rejection_reason | None).

    The single source of truth for out-of-core eligibility. With
    `allow_swap=True`, a join on the stream path whose BUILD subtree
    carries the stream candidate is side-swapped IN PLACE (`_swap_join`) so
    the big table probes a frozen build — only call it when streaming has
    been decided (the swap undoes the planner's cost-based build-side
    choice, which is right for resident execution). Swaps are rolled back
    if a later check rejects the plan."""
    scans = [n for n in plan.walk() if isinstance(n, PScan)]
    if not scans:
        return None, "no scans"
    scan = max(scans, key=lambda s: catalog.get(s.table_name).host.num_rows)
    # the streamed TABLE must be scanned exactly once in the whole plan:
    # a second scan of it (self-join) would still have to be resident
    n_scans = sum(1 for n in plan.walk()
                  if isinstance(n, PScan) and n.table_name == scan.table_name)
    if n_scans != 1:
        return None, (f"{scan.table_name} scanned {n_scans}x (self-join): "
                      "every scan would have to be resident; chunking one "
                      "leaves the others whole")
    path = _path_to(plan, scan)
    aggs_on_path = [n for n in path if isinstance(n, PAggregate)]
    if not aggs_on_path:
        return None, ("no aggregate above the scan: the output is row-shaped "
                      "in the streamed table, so there is no bounded merge "
                      "point to fold chunks into")
    agg = aggs_on_path[-1]      # LOWEST aggregate above the scan: the merge
    bad = [a.func for a in agg.aggs
           if a.func not in ("sum", "count", "count_star", "min", "max",
                             "avg")]
    if bad:
        return None, f"non-decomposable aggregates at merge point: {bad}"
    # identity scan, not path.index(agg): dataclass __eq__ recurses over
    # whole subtrees
    agg_pos = next(i for i, n in enumerate(path) if n is agg)
    sub = path[agg_pos + 1:]               # agg.child .. scan, outermost 1st
    visited_joins: List[PHashJoin] = []
    swapped: List[PHashJoin] = []

    def reject(reason):
        for j in swapped:       # _swap_join is an involution
            _swap_join(j)
        return None, reason

    for i, node in enumerate(sub[:-1]):
        if isinstance(node, (PFilter, PProject)):
            continue
        if isinstance(node, PHashJoin):
            nxt = sub[i + 1]
            if not any(m is nxt for m in node.probe.walk()):
                # stream side must be the probe side (the lookup table must
                # be frozen before any probe batch flows)
                if not allow_swap:
                    return reject(
                        f"{scan.table_name} is the BUILD side of a "
                        f"{node.join_type.value} join: the lookup table "
                        "must be frozen before any probe batch flows")
                _swap_join(node)
                swapped.append(node)
            if node.join_type in _VISITED_JOIN_TYPES:
                visited_joins.append(node)
            elif node.join_type not in _LINEAR_JOIN_TYPES:
                return reject(f"join type {node.join_type.value} on the "
                              "stream path is neither probe-linear nor "
                              "visited-streamable")
            continue
        if isinstance(node, PAggregate):
            return reject("a second aggregate sits between the scan and the "
                          "merge point")
        # PSort / PLimit between the scan and the merge point
        return reject(f"{node.__class__.__name__} between the scan and the "
                      "merge point is not row-decomposable")
    if swapped:
        # a swap reorders the join's output columns; recompute every
        # ancestor schema bottom-up
        for anc in reversed(path[:-1]):
            if hasattr(anc, "__post_init__"):
                anc.__post_init__()
    visited_joins.reverse()                # innermost first = flush order
    return StreamPlan(agg, plan, scan, visited_joins), None


def stream_upload_bytes(catalog, table_name: str, live_cols) -> int:
    reg = catalog.get(table_name)
    cols = live_cols or set(reg.host.schema.names)
    return sum(v.nbytes + valid.nbytes
               for n, (v, valid) in reg.host.columns.items() if n in cols)


class ChunkUploader:
    """Host rows -> packed host buffers -> the device.

    On a CUDA device the host buffers are pinned and used again: two per
    (label, layout, capacity), one filled while the other's copy may still
    run; a buffer is refilled only after its last copy's event completed.
    The copy runs on a side stream (`copy_(non_blocking=True)` from pinned
    memory) and the compute stream waits on its event. On the CPU the
    packed arrays are the table's words."""

    # threads packing a chunk's shards at once (numpy releases the GIL)
    PACK_THREADS = os.cpu_count() or 1

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self._pool: Dict[tuple, list] = {}
        self._threads = None

    def _buffer(self, key, shapes):
        """A pinned host buffer of tensors of `shapes` ((shape, dtype)
        each), its last copy's event last."""
        bufs = self._pool.get(key)
        if bufs is None:
            bufs = self._pool[key] = [
                [torch.empty(shape, dtype=dtype, pin_memory=True) for shape, dtype in shapes]
                + [None] for _ in range(2)]
        buf = bufs.pop(0)
        bufs.append(buf)
        if buf[-1] is not None:
            buf[-1].synchronize()     # its previous copy has left the buffer
        return buf

    def pack(self, host, names, lo: int, n: int, cap: int, label: str, rows=None):
        """pack_host_slice of rows [lo, lo+n) (or `rows`) of the columns
        `names` of `host`, renamed label.column, padded to `cap`: ->
        (schema, layout, buffer: the (words, f64) host tensors)."""
        prefix = f"{label}."
        layout = packed_layout(Schema([f.with_name(prefix + f.name)
                                       for f in host.schema.fields if f.name in names]))
        shapes = [((layout.width, cap), torch.int32),
                  ((len(layout.f64_fields), cap), torch.float64)]
        buf = self._buffer((label, layout, cap), shapes) if self.cuda else \
            [torch.zeros(s, dtype=d) for s, d in shapes] + [None]
        schema, layout, _, _ = pack_host_slice(host, names, lo, n, cap, prefix, rows,
                                               out=(buf[0].numpy(), buf[1].numpy()))
        return schema, layout, buf

    def pack_shards(self, host, names, lo: int, counts, per: int, label: str):
        """P contiguous row shards in one buffer, packed by up to PACK_THREADS
        threads: shard p holds rows
        [lo + p * per, lo + p * per + counts[p]) of `host`, packed as
        `pack` packs (shard p's words [p], its f64 [p]), padded to `per`
        rows; the counts ride in the buffer too, as int32 [P]. -> (schema,
        layout, buffer: the (words [P, W, per], f64 [P, F, per], counts)
        host tensors)."""
        prefix, P = f"{label}.", len(counts)
        layout = packed_layout(Schema([f.with_name(prefix + f.name)
                                       for f in host.schema.fields if f.name in names]))
        shapes = [((P, layout.width, per), torch.int32),
                  ((P, len(layout.f64_fields), per), torch.float64), ((P,), torch.int32)]
        buf = self._buffer((label, layout, P, per), shapes) if self.cuda else \
            [torch.zeros(s, dtype=d) for s, d in shapes] + [None]

        def one(p):
            return pack_host_slice(host, names, lo + p * per, counts[p], per, prefix,
                                   out=(buf[0][p].numpy(), buf[1][p].numpy()))[0]
        if self._threads is None:
            self._threads = ThreadPoolExecutor(self.PACK_THREADS)
        schema = list(self._threads.map(one, range(P)))[0]
        buf[2].copy_(torch.tensor(counts, dtype=torch.int32))
        return schema, layout, buf

    def upload(self, buf):
        """The buffer's tensors on the device; the copies are queued on the
        side stream and the current stream waits for them."""
        host = buf[:-1]
        if not self.cuda:
            return tuple(host)
        if not all(t.is_pinned() for t in host if t.numel()):
            raise RuntimeError("chunk buffers must be pinned: a pageable copy is synchronous")
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.stream):
            dev = [torch.empty(t.shape, dtype=t.dtype, device=self.device) for t in host]
            for d, t in zip(dev, host):
                d.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        buf[-1] = done
        compute.wait_event(done)
        for d in dev:
            d.record_stream(compute)
        return tuple(dev)


def device_chunk(handle, schema, layout, words, f64, n: int) -> DeviceTable:
    """A packed chunk on the device, unpacked by K12."""
    pt = PackedTable(words, dict(zip(layout.f64_fields, f64)), layout)
    return unpack_table(pt, schema, torch.tensor(n, dtype=torch.int32, device=words.device),
                        handle.chain)


def _flush_input(J: PHashJoin, build: DeviceTable, vis: torch.Tensor,
                 chain=None) -> DeviceTable:
    """The deferred build-side emission of a streamed build-emitting join,
    shaped as J's OUTPUT: matched build rows for LEFT_SEMI, unmatched for
    LEFT_ANTI, unmatched + NULL probe columns for LEFT/FULL (reference
    finalizer emissions, full.rs:181-201 / left_semi.rs:166)."""
    bin_ = build.row_mask()
    if J.join_type is JoinType.LEFT_SEMI:
        return filter_rows(build, bin_ & vis, chain)
    if J.join_type is JoinType.LEFT_ANTI:
        return filter_rows(build, bin_ & ~vis, chain)
    ub = filter_rows(build, bin_ & ~vis, chain)
    nulls = DeviceTable(J.probe.schema,
                        null_columns_like(J.probe.schema, ub.capacity, device=ub.device),
                        ub.num_rows)
    return hstack_tables(ub, nulls, ub.num_rows)


def grow(handle, pairs, totals) -> bool:
    """Grow every capacity of `pairs` whose total overflowed (True if any
    did); the out-of-core loops grow only, as the JAX package's do."""
    overflow = False
    for (k, _), total in zip(pairs, totals):
        cap = handle._caps.get(k, total)
        if total > cap:
            handle._caps[k] = round_capacity(max(total, 1), minimum=1024)
            overflow = True
    return overflow


def context(handle, prepared=None) -> ExecContext:
    return ExecContext(handle._caps, None, handle.kernels, handle.chain, prepared)


def read_totals(handle, totals) -> List[int]:
    """Every total of one run in one device-to-host copy, timed."""
    from .executor import _read_totals
    t0 = time.perf_counter()
    out = _read_totals(totals)
    handle.metrics.run_time_s += time.perf_counter() - t0
    return out


def prepare_builds(handle, joins, pairs, resident) -> Dict[int, object]:
    """Every join's build subtree run once and frozen (prepare_build),
    with the grow loop around the adaptive nodes `pairs` inside them."""
    prepared = {}
    while joins:
        ctx = context(handle)
        handle.metrics.launches += 1
        prepared = {j.join_id: prepare_build(j.build.execute(resident, ctx), j.build_keys,
                                             j.strategy, handle.kernels, handle.chain)
                    for j in joins}
        if not grow(handle, pairs, read_totals(handle, [ctx.join_totals.get(k)
                                                        for k, _ in pairs])):
            break
        handle.metrics.retries += 1
    return prepared


def merge_partial(handle, agg, partial_specs, merge_specs, acc: DeviceTable,
                  child: DeviceTable, row_filter, cap: int):
    """This chunk's partial aggregate folded into the accumulator:
    (merged, its true group count)."""
    chain = handle.chain
    partial, _ = hash_aggregate_counted(child, agg.group_keys, partial_specs, cap,
                                        row_filter, chain)
    return hash_aggregate_counted(concat_tables([acc, partial], handle.kernels.concat_rows,
                                                chain),
                                  agg.group_keys, merge_specs, cap, None, chain)


def finish(handle, root, merge, key, out, resident, head_adaptive, adaptive) -> DeviceTable:
    """The plan above the merge point `merge` run on its finished result
    `out` (materialized under `key`), with the grow loop for the adaptive
    nodes up there."""
    if root is merge:
        handle._save_caps(adaptive)
        return out
    while True:
        ctx = context(handle)
        ctx.materialized = {key: out}
        handle.metrics.launches += 1
        res = root.execute(resident, ctx)
        if not grow(handle, head_adaptive,
                    read_totals(handle, [ctx.join_totals.get(k) for k, _ in head_adaptive])):
            handle._save_caps(adaptive)
            return res
        handle.metrics.retries += 1


def run_streamed(handle, sp: StreamPlan, resident: Dict[str, DeviceTable],
                 live_cols, adaptive) -> DeviceTable:
    """Drive the chunk loop. `handle` is the owning QueryHandle (capacities,
    kernel tables, metrics); `resident` its leaf tables WITHOUT the
    streamed label."""
    agg = sp.agg
    reg = handle.catalog.get(sp.scan.table_name)
    label = sp.scan.label
    chunk_rows = int(os.environ.get("DFP_STREAM_CHUNK_ROWS", 1 << 22))
    chunk_rows = round_capacity(min(chunk_rows, max(1024, reg.host.num_rows)))
    n_chunks = -(-reg.host.num_rows // chunk_rows)
    uploader = handle.uploader()
    device = uploader.device

    partial_specs, merge_specs, finishers = decompose_for_partial(agg.aggs)
    partial_schema = agg_output_schema(agg.child.schema, agg.group_keys,
                                       partial_specs)
    vjoins = sp.visited_joins          # innermost first (flush order)
    vids = [j.join_id for j in vjoins]

    # joins on the stream path probe a FROZEN build side: their build
    # subtrees are stream-free (guaranteed by plan_stream), so the lookup
    # structures are built ONCE — the reference's build-once /
    # probe-stream split (inner.rs:48-75)
    path_joins = [n for n in agg.child.walk()
                  if isinstance(n, PHashJoin) and _contains(n.probe, sp.scan)]
    prep_nodes = {id(m) for j in path_joins for m in j.build.walk()}
    prep_adaptive = [(k, n) for k, n in adaptive if id(n) in prep_nodes]
    # adaptive nodes on the stream path; the agg's own capacity doubles as
    # the accumulator capacity
    sub_adaptive = [(k, n) for k, n in adaptive
                    if n is not agg and id(n) not in prep_nodes
                    and any(m is n for m in agg.child.walk())]
    prepared = prepare_builds(handle, path_joins, prep_adaptive, resident)
    debug = bool(os.environ.get("DFP_STREAM_DEBUG"))

    def load(i):
        """Chunk i packed on the host and its upload issued."""
        t0 = time.perf_counter()
        n = min(chunk_rows, reg.host.num_rows - i * chunk_rows)
        schema, layout, buf = uploader.pack(reg.host, live_cols, i * chunk_rows, n,
                                            chunk_rows, label)
        handle.metrics.host_pack_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        words, f64 = uploader.upload(buf)
        handle.metrics.upload_s += time.perf_counter() - t0
        if debug:
            print(f"[stream] chunk {i} packed in {time.perf_counter() - t0:.2f}s", flush=True)
        return schema, layout, words, f64, n

    while True:   # aggregate-capacity (accumulator) restarts
        agg_cap = handle._caps.get(agg.node_id)
        if agg_cap is None:
            # clamp the planner's group estimate hard: cross-table composite
            # keys can be wildly overestimated; the overflow restart covers
            # true undershoot, and the settled capacity persists
            est = (round_capacity(int(2 * agg.est_groups))
                   if agg.est_groups > 0 else 1 << 16)
            agg_cap = max(128, min(est,
                                   round_capacity(max(1024, reg.host.num_rows)),
                                   1 << 24))
            handle._caps[agg.node_id] = agg_cap
        # global aggregates produce a single-row table; the accumulator must
        # match the merge output's capacity exactly
        acc_cap = agg_cap if agg.group_keys else 1
        if debug:
            print(f"[stream] agg_cap={agg_cap} acc_cap={acc_cap} "
                  f"chunk_rows={chunk_rows} n_chunks={n_chunks} "
                  f"caps={dict(handle._caps)}", flush=True)
        acc = DeviceTable(partial_schema, null_columns_like(partial_schema, acc_cap,
                                                            device=device),
                          torch.zeros((), dtype=torch.int32, device=device))
        # device-resident visited buffers, one per build-emitting join on
        # the path (bool over its FROZEN build capacity), ORed in place
        vis_list = [torch.zeros(prepared[j.join_id].build.capacity, dtype=torch.bool,
                                device=device) for j in vjoins]
        restart = False
        handle.metrics.streamed_chunks = 0

        def step(chunk, acc):
            ctx = context(handle, prepared)
            ctx.stream_visited = dict(zip(vids, vis_list))
            tables = dict(resident)
            tables[label] = device_chunk(handle, *chunk)
            child, row_filter = agg.fused_child(tables, ctx)
            merged, mtotal = merge_partial(handle, agg, partial_specs, merge_specs, acc,
                                           child, row_filter, agg_cap)
            handle.metrics.launches += 1
            return merged, [mtotal] + [ctx.join_totals.get(k) for k, _ in sub_adaptive]

        def validate(idx, totals) -> bool:
            """Blocks on one chunk's totals; False when it must run again
            (restart set when the accumulator overflowed)."""
            nonlocal restart, mtotal
            mt, *tot = read_totals(handle, totals)
            if debug:
                print(f"[stream] chunk {idx} mtotal={mt} totals={tot}", flush=True)
            if grow(handle, sub_adaptive, tot):
                # joins/filters are per-chunk stateless: retry the chunk
                handle.metrics.retries += 1
                return False
            if mt > agg_cap:
                # every prior chunk's fold was truncated: grow and restart
                handle._caps[agg.node_id] = round_capacity(max(mt, 2 * agg_cap),
                                                           minimum=1024)
                handle.metrics.retries += 1
                restart = True
                return False
            handle.metrics.streamed_chunks += 1
            mtotal = mt
            return True

        # double-buffered: chunk i's device work overlaps the host packing
        # and upload of chunk i+1; on overflow the pending chunk re-runs
        # from its saved input accumulator (nothing later is dispatched)
        pending = None   # (idx, acc_in, merged, totals)
        mtotal = i = 0
        while not restart and (i < n_chunks or pending is not None):
            chunk = load(i) if i < n_chunks else None
            if pending is not None:
                idx, acc_in, merged, totals = pending
                pending = None
                if not validate(idx, totals):
                    if restart:
                        break
                    i, acc = idx, acc_in
                    continue
                acc = merged
            if chunk is None:
                break
            merged, totals = step(chunk, acc)
            pending = (i, acc, merged, totals)
            i += 1
        if restart:
            continue

        # FLUSH passes: one per build-emitting join, innermost first — emit
        # the deferred build rows as that join's output and run the path
        # ABOVE it (marking higher joins' visited buffers as these rows
        # probe them), folding into the same accumulator
        for k, J in enumerate(vjoins):
            while True:
                ctx = context(handle, prepared)
                ctx.stream_visited = {j.join_id: vis_list[idx]
                                      for idx, j in enumerate(vjoins) if idx > k}
                ctx.materialized = {J.join_id: _flush_input(
                    J, prepared[J.join_id].build, vis_list[k], handle.chain)}
                child, row_filter = agg.fused_child(resident, ctx)
                merged, mt = merge_partial(handle, agg, partial_specs, merge_specs, acc,
                                           child, row_filter, agg_cap)
                handle.metrics.launches += 1
                mt, *tot = read_totals(handle, [mt] + [ctx.join_totals.get(kk)
                                                       for kk, _ in sub_adaptive])
                if debug:
                    print(f"[stream] flush join {J.join_id} mtotal={mt} totals={tot}",
                          flush=True)
                if grow(handle, sub_adaptive, tot):
                    handle.metrics.retries += 1
                    continue          # this flush again with grown caps
                if mt > agg_cap:
                    # new groups from the deferred rows overflowed the
                    # accumulator: grow and restart the whole stream
                    handle._caps[agg.node_id] = round_capacity(max(mt, 2 * agg_cap),
                                                               minimum=1024)
                    handle.metrics.retries += 1
                    restart = True
                acc, mtotal = merged, mt
                break
            if restart:
                break
        if restart:
            continue

        # persist the settled capacities (the aggregate shrunk to its true
        # group count)
        fit = round_capacity(max(mtotal, 1), minimum=1024)
        if agg_cap > 4 * fit:
            handle._caps[agg.node_id] = fit
        handle.metrics.join_caps = dict(handle._caps)
        handle._save_caps(adaptive)

        # finish: complete the merge-point aggregate, then run the REST of
        # the plan above it (Q13's second aggregate) on the result
        out = finish_partial(acc, agg.group_keys, agg.aggs, finishers, agg.child.schema)
        head_adaptive = [(kk, n) for kk, n in adaptive
                         if not any(m is n for m in agg.walk())]
        return finish(handle, sp.root, agg, agg.node_id, out, resident, head_adaptive,
                      adaptive)
