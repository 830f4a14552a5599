"""Distributed morsel streaming (torch): the biggest scan chunked through
the partitions, against build sides frozen once per partition.

Counterpart of the JAX package's `runtime/distributed_streaming.py`, with
its rules and numbers: streaming and distribution composed, out-of-core
scale over P partitions with the shuffle overlapped with compute. Where
the JAX package runs one compiled shard_map program per step, the port
runs each step eagerly over the local shards of the Exchange (every
partition is in this process: the handle streams only then).

  * Prepare, once: each path join's build subtree runs distributed, is
    hash-shuffled to its key range under the (join_id, "bs") capacity and
    frozen shard by shard (`prepare_build`); it never moves again.
  * Per chunk, on the host: rows [lo, lo + chunk_rows) of the streamed
    table's live columns, cut into P contiguous shards of chunk_rows / P
    rows, packed into one pinned buffer (the row counts with them) and
    copied on the side stream, before the loop blocks on the previous
    chunk's totals (the double buffer).
  * Per chunk, on the device: K12 unpacks the shards, the chunk is
    shuffled to each frozen build's key range, probed, aggregated per
    partition and merged into that partition's accumulator. Nothing
    crosses the partitions into the accumulators until the finish.
    Every total of a chunk comes back in one host read.
  * Build-emitting joins (LEFT, FULL, LEFT_SEMI, LEFT_ANTI) fold a visited
    mask over each partition's local build shard; after the last chunk a
    flush pass per join, innermost first, emits the deferred build rows
    through the path above it.
  * Finish: the accumulators shuffled by group key and merged (a global
    aggregate: all-gathered, kept on partition 0), finished, and the plan
    above the merge point run on the result.

A chunk whose join or filter capacity overflowed runs again from the
accumulators and visited masks it started from (the step writes neither
in place); an accumulator overflow restarts the stream with the grown
capacity. `metrics.stream_timeline` records each chunk's pack and upload
window, its dispatch and its validation, and whether the device was still
running the previous chunk's step when the window opened and when it
closed (a CUDA event recorded after each dispatch; on the CPU every step
has ended by then): the overlap evidence.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

import torch

from ..models.physical import ExecContext, PHashJoin
from ..ops.aggregate import (agg_output_schema, decompose_for_partial, finish_partial,
                             hash_aggregate, hash_aggregate_counted)
from ..ops.join import prepare_build
from ..parallel.exchange import get_comm_bytes, reset_comm_bytes
from ..parallel.shuffle import all_gather_table, shuffle_by_hash
from ..utils.columnar import (DeviceTable, PackedTable, concat_tables, null_columns_like,
                              round_capacity, unpack_table)
from .distributed_executor import _dist_fused_child, _on_rank_0, _pmax, execute_dist
from .executor import _read_totals
from .streaming import StreamPlan, _contains, _flush_input

Shards = List[DeviceTable]


def chunk_counts(num_rows: int, lo: int, chunk_rows: int, P: int) -> List[int]:
    """The rows each partition's shard of the chunk at `lo` holds: chunk_rows
    / P contiguous rows a partition; in the last chunk the rows go to the
    first partitions (the JAX package's `_chunk_shards`)."""
    n = max(0, min(chunk_rows, num_rows - lo))
    per = chunk_rows // P
    return [max(min((p + 1) * per, n) - p * per, 0) for p in range(P)]


def stream_chunk_rows(num_rows: int, P: int) -> int:
    """DFP_STREAM_CHUNK_ROWS (4,194,304) for P partitions: a power of two
    no larger than the table (and at least 128 rows a partition), cut to a
    multiple of P."""
    chunk_rows = int(os.environ.get("DFP_STREAM_CHUNK_ROWS", 1 << 22))
    chunk_rows = round_capacity(min(chunk_rows, max(P * 128, num_rows)))
    return max(P, chunk_rows - chunk_rows % P)


def _merge(handle, agg, partial_specs, merge_specs, acc: Shards, child: Shards, row_filter,
           cap: int):
    """Each partition's partial aggregate of `child` folded into its
    accumulator: (the merged shards, their group counts)."""
    chain = handle.chain
    merged, totals = [], []
    for a, c, f in zip(acc, child, row_filter or [None] * len(child)):
        partial, _ = hash_aggregate_counted(c, agg.group_keys, partial_specs, cap, f, chain)
        m, total = hash_aggregate_counted(
            concat_tables([a, partial], handle.kernels.concat_rows, chain), agg.group_keys,
            merge_specs, cap, None, chain)
        merged.append(m)
        totals.append(total)
    return merged, totals


def run_streamed_dist(handle, sp: StreamPlan, live, adaptive):
    """Drive the distributed chunk loop. `handle` is the owning
    DistributedQueryHandle (its Exchange, capacities, kernel tables and
    metrics); returns the result as a host table."""
    agg, ex = sp.agg, handle.mesh
    P, m = ex.P, handle.metrics
    device, chain = ex.device, handle.chain
    reg = handle.catalog.get(sp.scan.table_name)
    host, label = reg.host, sp.scan.label
    live_names = sorted((live or set(host.schema.names)) & set(host.schema.names)) \
        or [host.schema.names[0]]
    chunk_rows = stream_chunk_rows(host.num_rows, P)
    n_chunks = -(-host.num_rows // chunk_rows)
    per = chunk_rows // P
    uploader = handle.uploader()

    if handle._streamed_inputs is None or handle._streamed_inputs[0] != label:
        handle._streamed_inputs = (label, handle._shard_inputs(skip_labels=(label,))[0])
    tables = handle._streamed_inputs[1]
    root_sort = handle._root_local_sort()
    local_ids = frozenset({id(root_sort)}) if root_sort is not None else frozenset()

    partial_specs, merge_specs, finishers = decompose_for_partial(agg.aggs)
    partial_schema = agg_output_schema(agg.child.schema, agg.group_keys, partial_specs)
    vjoins = sp.visited_joins
    vids = [j.join_id for j in vjoins]
    path_joins = [n for n in agg.child.walk()
                  if isinstance(n, PHashJoin) and _contains(n.probe, sp.scan)]
    prep_nodes = {id(n) for j in path_joins for n in j.build.walk()}
    # the capacity keys the prepare step reports: the joins inside the
    # frozen build subtrees (with their shuffles' dropped rows and salted
    # heavy blocks), each frozen build's own shuffle, and the other adaptive
    # nodes in those subtrees
    prep_join_ids = [n.join_id for j in path_joins for n in j.build.walk()
                     if isinstance(n, PHashJoin)]
    prep_keys = [k for jid in prep_join_ids
                 for k in (jid, (jid, "bs"), (jid, "ps"), (jid, "hv"))]
    prep_keys += [(j.join_id, "bs") for j in path_joins]
    prep_keys += [k for k, n in adaptive if id(n) in prep_nodes and not isinstance(n, PHashJoin)]
    # the chunk step's: the path joins (candidates, the probe chunk's
    # shuffle) and the filters and aggregates on the path
    sub_keys = [k for j in path_joins for k in (j.join_id, (j.join_id, "ps"))]
    sub_keys += [k for k, n in adaptive
                 if n is not agg and id(n) not in prep_nodes
                 and not isinstance(n, PHashJoin) and any(x is n for x in agg.child.walk())]
    debug = bool(os.environ.get("DFP_STREAM_DEBUG"))

    def grow(keys, totals) -> bool:
        """The JAX loop's rule: a dropped shuffle row doubles its send block,
        any other total past its capacity grows it to fit; nothing shrinks."""
        overflow = False
        for k, total in zip(keys, totals):
            if isinstance(k, tuple):
                if total > 0:
                    handle._caps[k] = 2 * handle._caps[k]
                    overflow = True
                continue
            if total > handle._caps.get(k, total):
                handle._caps[k] = round_capacity(max(total, 1), minimum=1024)
                overflow = True
        return overflow

    def read(totals) -> List[int]:
        t0 = time.perf_counter()
        out = _read_totals(totals)
        m.run_time_s += time.perf_counter() - t0
        return out

    def context() -> ExecContext:
        return ExecContext(handle._caps, None, handle.kernels, chain)

    # ---- prepare: every path join's build side, frozen per partition ----
    while True:
        ctx = context()
        reset_comm_bytes()
        m.launches += 1
        prepared: Dict[int, list] = {}
        for j in path_joins:
            b = execute_dist(j.build, tables, ctx, ex)
            skey = (j.join_id, "bs")
            scap = ctx.join_caps.get(skey)
            if scap is None:
                scap = min(b[0].capacity, max(1024, 4 * (b[0].capacity // P)))
                ctx.join_caps[skey] = scap
            b2, ctx.join_totals[skey] = shuffle_by_hash(ex, b, j.build_keys, scap)
            del b
            prepared[j.join_id] = [prepare_build(t, j.build_keys, j.strategy, handle.kernels,
                                                 chain) for t in b2]
            del b2
        prep_comm = get_comm_bytes()
        if not grow(prep_keys, read([ctx.join_totals.get(k) for k in prep_keys])):
            break
        m.retries += 1
        del prepared
    total_comm = prep_comm   # the prepare's last attempt only, as in the JAX loop

    # ---- the chunk loop --------------------------------------------------
    while True:   # accumulator-capacity restarts
        agg_cap = handle._caps.get(agg.node_id)
        if agg_cap is None:
            est = (round_capacity(int(2 * agg.est_groups)) if agg.est_groups > 0
                   else 1 << 16)
            # 16M ceiling: customer-level group counts at SF100 are ~15M and
            # a low ceiling forces full stream restarts
            agg_cap = max(128, min(est, round_capacity(max(1024, host.num_rows)), 1 << 24))
            handle._caps[agg.node_id] = agg_cap
        # a global aggregate's merge makes one row: its accumulator too
        acc_cap = agg_cap if agg.group_keys else 1
        zero = torch.zeros((), dtype=torch.int32, device=device)
        acc = [DeviceTable(partial_schema, null_columns_like(partial_schema, acc_cap,
                                                             device=device), zero)
               for _ in ex.ranks]
        vis = [[torch.zeros(pb.build.capacity, dtype=torch.bool, device=device)
                for pb in prepared[jid]] for jid in vids]
        restart = False
        m.streamed_chunks = 0
        m.stream_timeline = timeline = []
        t_origin = time.perf_counter()

        def now():
            return time.perf_counter() - t_origin

        step_done = [None]    # the CUDA event after the last dispatched step

        def device_busy() -> bool:
            return step_done[0] is not None and not step_done[0].query()

        def load(i):
            """Chunk i's shards packed into pinned memory and their copy
            queued on the side stream."""
            t0, busy0 = now(), device_busy()
            counts = chunk_counts(host.num_rows, i * chunk_rows, chunk_rows, P)
            tp = time.perf_counter()
            schema, layout, buf = uploader.pack_shards(host, live_names, i * chunk_rows,
                                                       counts, per, label)
            m.host_pack_s += time.perf_counter() - tp
            tp = time.perf_counter()
            words, f64, nrows = uploader.upload(buf)
            m.upload_s += time.perf_counter() - tp
            shards = [unpack_table(PackedTable(words[r], dict(zip(layout.f64_fields, f64[r])),
                                               layout), schema, nrows[r], chain)
                      for r in ex.ranks]
            timeline.append({"event": "pack_upload", "chunk": i, "t0": t0, "t1": now(),
                             "busy_t0": busy0, "busy_t1": device_busy()})
            return shards

        def dispatch(i, state, chunk):
            """Chunk i's step queued on the device from `state` (the
            accumulators and visited masks it starts from, unwritten):
            (its merged accumulators, visited masks, totals, comm bytes)."""
            acc_in, vis_in = state
            ctx = context()
            ctx.prepared = prepared
            ctx.stream_visited = dict(zip(vids, vis_in))
            reset_comm_bytes()
            m.launches += 1
            child, row_filter = _dist_fused_child(agg, {**tables, label: chunk}, ctx, ex)
            merged, mtotals = _merge(handle, agg, partial_specs, merge_specs, acc_in, child,
                                     row_filter, agg_cap)
            del child, row_filter
            totals = [_pmax(ex, mtotals)] + [ctx.join_totals.get(k) for k in sub_keys]
            if device.type == "cuda":
                step_done[0] = torch.cuda.Event()
                step_done[0].record(torch.cuda.current_stream(device))
            timeline.append({"event": "dispatch", "chunk": i, "t": now()})
            return merged, [ctx.visited_out[v] for v in vids], totals, get_comm_bytes()

        def validate(i, totals) -> bool:
            """Blocks on chunk i's totals (one read); False when it must run
            again (`restart` set where the accumulator overflowed)."""
            nonlocal restart
            mt, *tot = read(totals)
            timeline.append({"event": "validated", "chunk": i, "t": now()})
            if debug:
                print(f"[dstream] chunk {i} mtotal={mt} totals={tot}", flush=True)
            if grow(sub_keys, tot):
                m.retries += 1
                return False
            if mt > agg_cap:
                # every earlier chunk's fold was truncated: grow, restart
                handle._caps[agg.node_id] = round_capacity(max(mt, 2 * agg_cap), minimum=1024)
                m.retries += 1
                restart = True
                return False
            m.streamed_chunks += 1
            return True

        # double-buffered: chunk i is packed and its copy queued before the
        # loop blocks on chunk i - 1's totals; a chunk that overflowed runs
        # again from the state it started from (nothing later was dispatched)
        chunk_comm = 0            # summed over every dispatched step, retries too
        pending = None            # (idx, state in, outputs)
        state = (acc, vis)
        i = 0
        while not restart and (i < n_chunks or pending is not None):
            chunk = load(i) if i < n_chunks else None
            if pending is not None:
                idx, state_in, outs = pending
                pending = None
                if not validate(idx, outs[2]):
                    if restart:
                        break
                    i, state = idx, state_in
                    continue
                state = (outs[0], outs[1])
                del outs
            if chunk is None:
                break
            outs = dispatch(i, state, chunk)
            chunk_comm += outs[3]
            pending = (i, state, outs)
            del chunk, outs
            i += 1
        del pending
        if restart:
            continue
        acc, vis = state

        # ---- flush passes: the deferred build rows, innermost join first
        for k, J in enumerate(vjoins):
            while True:
                ctx = context()
                ctx.prepared = prepared
                ctx.stream_visited = {j.join_id: vis[x] for x, j in enumerate(vjoins) if x > k}
                ctx.materialized = {J.join_id: [_flush_input(J, pb.build, v, chain)
                                                for pb, v in zip(prepared[J.join_id], vis[k])]}
                reset_comm_bytes()
                m.launches += 1
                child, row_filter = _dist_fused_child(agg, tables, ctx, ex)
                merged, mtotals = _merge(handle, agg, partial_specs, merge_specs, acc, child,
                                         row_filter, agg_cap)
                del child, row_filter
                new_vis = [ctx.visited_out.get(j.join_id, vis[x]) for x, j in enumerate(vjoins)]
                mt, *tot = read([_pmax(ex, mtotals)] + [ctx.join_totals.get(kk)
                                                        for kk in sub_keys])
                total_comm += get_comm_bytes()
                if debug:
                    print(f"[dstream] flush join {J.join_id} mtotal={mt} totals={tot}",
                          flush=True)
                if grow(sub_keys, tot):
                    m.retries += 1
                    continue
                if mt > agg_cap:
                    handle._caps[agg.node_id] = round_capacity(max(mt, 2 * agg_cap),
                                                               minimum=1024)
                    m.retries += 1
                    restart = True
                    break
                acc, vis = merged, new_vis
                break
            if restart:
                break
        if restart:
            continue
        break

    m.join_caps = dict(handle._caps)
    m.comm_bytes = total_comm + chunk_comm
    del prepared, vis

    # ---- finish: the accumulators merged across the partitions, the head
    head_nodes = [(kk, n) for kk, n in adaptive if not any(x is n for x in agg.walk())]
    head_keys = [kk for kk, _ in head_nodes]
    head_keys += [k for _, n in head_nodes if isinstance(n, PHashJoin)
                  for k in ((n.join_id, "bs"), (n.join_id, "ps"))]
    while True:
        ctx = context()
        ctx.local_sort_ids = local_ids
        reset_comm_bytes()
        m.launches += 1
        if agg.group_keys:
            shuffled, _ = shuffle_by_hash(ex, acc, agg.group_keys, acc[0].capacity)
            merged = [hash_aggregate(t, agg.group_keys, merge_specs, kernels=chain)
                      for t in shuffled]
            del shuffled
        else:
            gathered = all_gather_table(ex, acc)
            # every partition holds the same global row: kept once
            merged = _on_rank_0(ex, [hash_aggregate(t, [], merge_specs, kernels=chain)
                                     for t in gathered])
            del gathered
        out = [finish_partial(t, agg.group_keys, agg.aggs, finishers, agg.child.schema)
               for t in merged]
        del merged
        if sp.root is not agg:
            ctx.materialized = {agg.node_id: out}
            out = execute_dist(sp.root, tables, ctx, ex)
        totals = read([ctx.join_totals.get(k) for k in head_keys])
        m.comm_bytes += get_comm_bytes()
        if not grow(head_keys, totals):
            return handle._finish(out, root_sort)
        m.retries += 1
        del out
