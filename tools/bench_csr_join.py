#!/usr/bin/env python3
"""K2 csr_build, K3 probe_expand and K4 compact_gather timed at their SQL
shapes, on one NVIDIA GPU.

    python3 tools/bench_csr_join.py [--parent DIR] [--rounds N] [--explore]
                                    [--calls FILE] [--out FILE]

Cells (seeded data made on the card; the shapes of `tools/profile_csr_call.py`
at the SQL calls phase 15 replays):
  - K2 at Size512 (n 4,194,304, T 4 n, R 2 narrow rows, uniform slots;
    row-major, R 1, the key word the deferred join hands it);
  - K2 at Q9 (n 33,554,432, T 134,217,728, R 3; row-major R 2, its two
    key words; 3,147,082 rows valid, the rest, a capacity-padded table's
    padding, in bucket T at the end);
  - K2 at a sparse build (n 2^25, T 2^27, R 1; 10% of the rows valid, at
    random, the rest null keys in bucket T);
  - K2 at a hot key (n 2^24, T 2^26, R 2; half the rows in one bucket);
  - K3 at Size512's probe (m 4,194,304 over Size512's table; out_cap
    6,291,456) and at Q7's (m 67,108,864 probe rows over a table of
    15,000,000 valid rows at capacity 2^25, T 2^27; out_cap 33,554,432):
    lineitem-like, each build key's rows together (1-7 of them, in build
    order), 18,475,075 of them ok at random, the rest of the capacity
    padding; and the same shape with every probe row's slot random: pass 1
    with its scan (`probe_ranges`) and pass 2 (`expand_ranges`, one key
    word; word-major with its validity word, and row-major as the deferred
    join gives it, the key word and row id, with no build validity test);
  - K3 at a hot probe key: one probe row owning 4,194,304 candidates among
    4,194,304 probe rows;
  - K4 at the largest call of the first run of TPC-H Q9 at SF10 through
    SQL (phase 15's call), and at the Size512 INNER join's call, both
    captured with the join's input tables (--calls reads a file an earlier
    run saved, else they are captured first and kept in
    `_data/k4_calls.pt`); and at a synthetic call over float64, int64,
    int32, float32 and bool columns with 10% nulls on both sides (build
    and probe capacity 2^22, out_cap 2^23, 3/8 of the slots below a total
    of 3/4 of them matching).
Per cell: the kernel's ms (CUDA events around the wrapper, median of 20
after a warm-up), whether it equals its plain version bit for bit, the
bound (bytes the call must move at 3.35 TB/s, a view's bytes once) and
partial yardsticks, not the same function: `torch.argsort(slot,
stable=True)` for K2's perm alone; two `index_select`s of the offsets and
`torch.cumsum` for K3's pass 1. K4 is timed like for like: a checkout
whose K4 gathers packed rows runs what its join runs around it, K12's
pack of both input tables, K4 and K12's unpack of both halves (`ms`; K4
alone on the packed inputs: `k4_alone_ms`); one whose K4 reads the
columns runs its one call. A checkout whose K2 writes row-major rows also
times K2 and K3's second pass in the layout its deferred join asks for
(`row_major_ms` at the join's R, `expand_row_major_ms`).

With --parent (a checkout of another commit, e.g. the parent unpacked with
`git archive` under `_data/`), each version runs in its own process in the
order parent, change, change, parent (--rounds times), so both are
compared on one card in one call; `summary` gives each cell's median
[min-max] over the runs. --explore (this checkout only) also times K2
without its narrow rows (R 0: what its row gather costs) and K2 at R 0
followed by K5's gather of the rows, and splits K2 at Q9, K3 at Q7 and
the K4 cells launch by launch under `torch.profiler`. Prints one JSON
object with the card's name and power limit;
also written to --out. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys

from bench_agg_compact import agrees, smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory rate
SIZE512 = 4_194_304
K4_Q9, K4_SIZE512 = "K4 Q9 (phase 15's call)", "K4 Size512"
K4_KINDS = "K4 float64/int64/int32/float32/bool columns, 10% nulls"

# name: (n, T, R, R of the deferred join's row-major rows, valid rows,
# where the valid rows are, hot share)
K2_CELLS = {
    "K2 Size512": (SIZE512, 4 * SIZE512, 2, 1, SIZE512, "all", 0.0),
    "K2 Q9": (1 << 25, 1 << 27, 3, 2, 3_147_082, "head", 0.0),
    "K2 sparse (10% valid)": (1 << 25, 1 << 27, 1, 1, 3_355_443, "random", 0.0),
    "K2 hot key (half the rows)": (1 << 24, 1 << 26, 2, 1, 1 << 24, "all", 0.5),
}
# name: (build n, T, valid build rows, probe m, ok rows, out_cap, hot
# candidates, probe layout: "random" slots, or "runs" of 1-7 rows a build
# key in build-key order, as lineitem's rows follow their orders)
K3_CELLS = {
    "K3 Size512": (SIZE512, 4 * SIZE512, SIZE512, SIZE512, SIZE512, SIZE512 * 3 // 2, 0,
                   "random"),
    "K3 Q7": (1 << 25, 1 << 27, 15_000_000, 1 << 26, 18_475_075, 1 << 25, 0, "runs"),
    "K3 Q7 shape, random slots": (1 << 25, 1 << 27, 15_000_000, 1 << 26, 18_475_075, 1 << 25,
                                  0, "random"),
    "K3 hot probe key (2^22 candidates)": (1 << 23, 1 << 25, 1 << 23, SIZE512, SIZE512,
                                           None, 1 << 22, "random"),
}


def cuda_ms(torch, fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def equal(torch, a, b) -> bool:
    def flat(x):
        return [x] if isinstance(x, torch.Tensor) else [t for y in x for t in flat(y)]
    return all(torch.equal(x, y) for x, y in zip(flat(a), flat(b), strict=True))


def union_bytes(tensors) -> int:
    """Bytes of the tensors' storage, a view's bytes once."""
    spans = sorted((t.data_ptr(), t.data_ptr() + t.nbytes) for t in tensors if t.nbytes)
    total, end = 0, -1
    for s, e in spans:
        total += max(0, e - max(s, end))
        end = max(end, e)
    return total


def k2_inputs(torch, g, device, n, T, R, valid, where, hot):
    slot = torch.randint(0, T, (n,), generator=g, device=device, dtype=torch.int32)
    if where == "head":
        slot[valid:] = T
    elif where == "random":
        slot[torch.randperm(n, generator=g, device=device)[valid:]] = T
    if hot:
        slot[torch.rand(n, generator=g, device=device) < hot] = 12_345
    rows = torch.randint(-2**31, 2**31, (R, n), generator=g, device=device,
                         dtype=torch.int64).to(torch.int32)
    return slot, rows


def k2_cells(torch, g, device, explore: bool):
    from datafusion_parallelism_tpu_torch.kernels import csr_build as k2
    out = {}
    for name, (n, T, R, R_rm, valid, where, hot) in K2_CELLS.items():
        slot, rows = k2_inputs(torch, g, device, n, T, R, valid, where, hot)
        got = k2.csr_build(slot, T, rows)
        ok = equal(torch, got, k2.csr_build_plain(slot, T, rows))
        _, offsets, _, start_count, rows_out = got
        cell = {"shape": {"n": n, "T": T, "R": R, "rows_in_bucket_T": int((slot == T).sum())},
                "equal_plain": ok, "ms": cuda_ms(torch, lambda: k2.csr_build(slot, T, rows)),
                "bound_bytes": union_bytes([slot, rows] + list(got)),
                "bound_bytes_each_output": (slot.nbytes + rows.nbytes
                                            + sum(t.nbytes for t in got)),
                "argsort_ms": cuda_ms(torch, lambda: torch.argsort(slot, stable=True))}
        del got, offsets, start_count, rows_out
        if row_major_k2(k2):
            rm = rows[:R_rm]
            got = k2.csr_build(slot, T, rm, True)
            cell["row_major_R"] = R_rm
            cell["row_major_equal_plain"] = equal(torch, got,
                                                  k2.csr_build_plain(slot, T, rm, True))
            cell["row_major_ms"] = cuda_ms(torch, lambda: k2.csr_build(slot, T, rm, True))
            del got, rm
        if explore:
            from datafusion_parallelism_tpu_torch.kernels import filter_compact as k5
            no_rows = rows[:0]
            no_f64 = torch.empty((0, n), dtype=torch.float64, device=device)
            cell["R 0 ms"] = cuda_ms(torch, lambda: k2.csr_build(slot, T, no_rows))

            def gather_after():   # the rows by K5's gather after a sort without them
                return k5.gather_rows(rows, no_f64, k2.csr_build(slot, T, no_rows)[2])
            cell["R 0 then K5 gather ms"] = cuda_ms(torch, gather_after)
            cell["R 0 then K5 gather equal"] = torch.equal(
                gather_after()[0], k2.csr_build_plain(slot, T, rows)[4][:R])
        out[name] = cell
        del slot, rows
        torch.cuda.empty_cache()
    return out


def row_major_k2(k2) -> bool:
    """Whether this checkout's K2 writes row-major narrow rows on request."""
    return "row_major" in inspect.signature(k2.csr_build).parameters


def k3_inputs(torch, g, device, n, T, valid, m, ok_rows, hot, layout):
    """The build's table (K2 over seeded slots, with one key word and its
    validity word as narrow rows; row-major, the key word alone, as the
    deferred join asks) and the probe's slots, ok mask and words.
    "random": each ok probe row takes the slot and key of a random valid
    build row, the others random slots, in random order; "runs": build row
    b's key repeated 1-7 times, b in order, ok_rows of them ok at random,
    the rows past them padding (one slot, not ok). A hot cell: `hot` build
    rows share one slot and key, which one probe row takes."""
    from datafusion_parallelism_tpu_torch.kernels import csr_build as k2
    bslot = torch.randint(0, T, (n,), generator=g, device=device, dtype=torch.int32)
    bkey = torch.randint(0, 1 << 30, (n,), generator=g, device=device, dtype=torch.int32)
    if hot:
        bslot[:hot] = 77
        bkey[:hot] = 5
    bslot[valid:] = T
    vbit = torch.full((n,), 1, dtype=torch.int32, device=device)
    _, offsets, _, start_count, bwords = k2.csr_build(bslot, T, torch.stack([bkey, vbit]))
    if layout == "runs":
        lengths = torch.randint(1, 8, (valid,), generator=g, device=device)
        pick = torch.repeat_interleave(torch.arange(valid, device=device), lengths)[:m]
        real = pick.shape[0]
        ok = torch.zeros(m, dtype=torch.bool, device=device)
        ok[torch.randperm(real, generator=g, device=device)[:ok_rows]] = True
        pslot = torch.full((m,), 12_345, dtype=torch.int32, device=device)
        pslot[:real] = bslot[pick]
        pkey = torch.zeros(m, dtype=torch.int32, device=device)
        pkey[:real] = bkey[pick]
    else:
        pick = torch.randint(0, valid, (m,), generator=g, device=device)
        pslot = torch.where(torch.arange(m, device=device) < ok_rows, bslot[pick],
                            torch.randint(0, T, (m,), generator=g, device=device,
                                          dtype=torch.int32))
        pkey = bkey[pick]
        if hot:
            pslot = torch.randint(0, T, (m,), generator=g, device=device, dtype=torch.int32)
            pslot[pslot == 77] = 78
            pslot[m // 3] = 77
            pkey[m // 3] = 5
        perm = torch.randperm(m, generator=g, device=device)
        ok = (torch.arange(m, device=device) < ok_rows)[perm]
        pslot, pkey = pslot[perm].contiguous(), pkey[perm].contiguous()
    pwords = torch.stack([pkey, torch.ones_like(pkey)])
    rm = k2.csr_build(bslot, T, bkey[None], True)[4] if row_major_k2(k2) else None
    return offsets, start_count, bwords, pslot, ok, pwords, rm


def k3_cells(torch, g, device):
    from datafusion_parallelism_tpu_torch.kernels import probe_expand as k3
    out = {}
    by_offsets = "offsets" in inspect.signature(k3.probe_ranges).parameters
    compares = [([0], [0], (1, 0), (1, 0))]
    join_plan = [([0], [0], None, (1, 0))]   # the deferred join's: no build validity
    for name, (n, T, valid, m, ok_rows, out_cap, hot, layout) in K3_CELLS.items():
        offsets, start_count, bwords, pslot, ok, pwords, rm = k3_inputs(
            torch, g, device, n, T, valid, m, ok_rows, hot, layout)
        table = offsets if by_offsets else start_count

        def ranges():
            return k3.probe_ranges(pslot, ok, table)
        got = ranges()
        want = k3.probe_ranges_plain(pslot, ok, table)
        total = int(got[3])
        cap = out_cap or total

        def expand():
            return k3.expand_ranges(*got, pwords, bwords, compares, cap)
        got_x = expand()
        want_x = k3.expand_ranges_plain(*want, pwords, bwords, compares, cap)

        def yardstick():   # two index_selects of the descriptor rows and a cumsum
            sl = pslot.long()
            s = offsets.index_select(0, sl)
            c = torch.where(ok, offsets.index_select(0, sl + 1) - s, 0)
            return s, c, torch.cumsum(c, 0)
        k = min(total, cap)
        cell = {"shape": {"m": m, "T": T, "ok_rows": ok_rows, "total": total, "out_cap": cap},
                "equal_plain": equal(torch, (got, got_x), (want, want_x)),
                "ranges_ms": cuda_ms(torch, ranges), "expand_ms": cuda_ms(torch, expand),
                # pass 1: slot, ok, one 8-byte descriptor a row, start/count/base
                "ranges_bound_bytes": pslot.nbytes + ok.nbytes + 8 * m + 12 * m + 8,
                # pass 2: start, base, the probe words, the candidates' build
                # words, the outputs
                "expand_bound_bytes": (8 * m + pwords.nbytes
                                       + min(bwords.nbytes, k * bwords.shape[0] * 4)
                                       + 9 * cap),
                "yardstick_ms": cuda_ms(torch, yardstick)}
        if rm is not None:   # the rows and plan of the deferred join
            cell["expand_row_major_equal_plain"] = equal(
                torch, k3.expand_ranges(*got, pwords, rm, join_plan, cap), want_x)
            cell["expand_row_major_ms"] = cuda_ms(
                torch, lambda: k3.expand_ranges(*got, pwords, rm, join_plan, cap))
        out[name] = cell
        del offsets, start_count, bwords, pslot, ok, pwords, got, want, got_x, want_x, rm
        torch.cuda.empty_cache()
    return out


def k4_capture(torch, sf: float, device) -> dict:
    """{label: call} of K4: the largest call (by the bytes of its match,
    ids and both input tables' columns) of the first run of Q9 over TPC-H
    at `sf`, and the Size512 INNER join's call. A call is its match,
    build_id and probe_idx, the candidate total K3 gave the join, and the
    columns of the join's two input tables."""
    import numpy as np

    from datafusion_parallelism_tpu_torch import SessionContext
    from datafusion_parallelism_tpu_torch.entry import make_tables
    from datafusion_parallelism_tpu_torch.models import physical
    from datafusion_parallelism_tpu_torch.ops.join import KERNELS, JoinType, hash_join
    from datafusion_parallelism_tpu_torch.tpch import QUERIES, generate_tables
    sm = smoke()
    state = {"tables": None, "total": None, "call": None, "bytes": -1}

    def join(b, p, *args, **kw):
        state["tables"] = (b, p)
        return real_join(b, p, *args, **kw)

    def expand(*args):
        state["total"] = args[3]
        return KERNELS.expand_ranges(*args)

    def k4(*args):
        b, p = state["tables"]
        call = {"match": args[0], "build_id": args[1], "probe_idx": args[2],
                "total": state["total"], "build": [b.columns[n] for n in b.schema.names],
                "probe": [p.columns[n] for n in p.schema.names]}
        size = sm._bytes(list(call.values()))
        if size > state["bytes"]:
            state["call"], state["bytes"] = call, size
        return KERNELS.compact_gather(*args)

    kernels = KERNELS._replace(expand_ranges=expand, compact_gather=k4)
    real_join = physical.hash_join
    physical.hash_join = join
    try:
        ctx = SessionContext(device=device)
        for name, t in generate_tables(sf=sf).items():
            ctx.register_table(name, t)
        ctx.sql(QUERIES[9], kernels=kernels).collect()
    finally:
        physical.hash_join = real_join
    for reg in ctx.catalog.tables.values():
        reg.release_device()
    del ctx
    out = {K4_Q9: state["call"]}
    state.update(call=None, bytes=-1)
    build, probe = make_tables(np.random.default_rng(0), SIZE512, SIZE512, SIZE512,
                               device=device)
    state["tables"] = (build, probe)
    hash_join(build, probe, ["b_key"], ["p_key"], JoinType.INNER, sm.SIZE512_OUT_CAP,
              kernels=kernels)
    out[K4_SIZE512] = state["call"]
    return out


def k4_kinds_call(torch, g, device) -> dict:
    """K4_KINDS's call, made from `g` on `device`."""
    cap, out_cap = 1 << 22, 1 << 23
    total = out_cap * 3 // 4

    def cols():
        rand = lambda: torch.randint(-2**62, 2**62, (cap,), generator=g, device=device)  # noqa: E731
        vals = [torch.rand(cap, generator=g, device=device, dtype=torch.float64), rand(),
                rand().to(torch.int32), torch.rand(cap, generator=g, device=device),
                rand() > 0]
        return [(v, torch.rand(cap, generator=g, device=device) >= 0.1) for v in vals]
    j = torch.arange(out_cap, device=device)
    match = (j < total) & (torch.rand(out_cap, generator=g, device=device) < 0.5)
    build_id = torch.randint(0, cap, (out_cap,), generator=g, device=device, dtype=torch.int32)
    probe_idx = torch.sort(torch.randint(0, cap, (out_cap,), generator=g, device=device,
                                         dtype=torch.int32))[0]
    zero = j >= total
    return {"match": match, "build_id": build_id.masked_fill(zero, 0),
            "probe_idx": probe_idx.masked_fill(zero, 0),
            "total": torch.tensor(total, dtype=torch.int32, device=device),
            "build": cols(), "probe": cols()}


def _table_of(torch, cols):
    """A DeviceTable of the columns, named c0, c1, ..., kinds from their
    dtypes (an int32 column packs as a date or a string code does)."""
    from datafusion_parallelism_tpu_torch.utils import columnar as uc
    kinds = {torch.int32: uc.INT32, torch.int64: uc.INT64, torch.float32: uc.FLOAT32,
             torch.float64: uc.FLOAT64, torch.bool: uc.BOOL}
    schema = uc.Schema([uc.Field(f"c{i}", kinds[v.dtype]) for i, (v, _) in enumerate(cols)])
    return uc.DeviceTable(schema, {f"c{i}": c for i, c in enumerate(cols)},
                          torch.tensor(cols[0][0].shape[0], dtype=torch.int32,
                                       device=cols[0][0].device))


def k4_versions(torch, call):
    """(run, kernel alone, plain) of this checkout's K4 on `call`: with the
    column contract, one call each; with the packed one, run = K12's pack of
    both tables, K4 and K12's unpack of both halves, as the deferred join
    ran them, and the kernel and its plain version on inputs packed once."""
    from datafusion_parallelism_tpu_torch.kernels import compact_gather as k4
    from datafusion_parallelism_tpu_torch.utils import columnar as uc
    ids = (call["match"], call["build_id"], call["probe_idx"])
    if "build_cols" in inspect.signature(k4.compact_gather).parameters:
        args = (*ids, call["build"], call["probe"], call["total"])
        return (lambda: k4.compact_gather(*args)), None, (lambda: k4.compact_gather_plain(*args))
    bt, pt = _table_of(torch, call["build"]), _table_of(torch, call["probe"])

    def packed():
        bp, pp = uc.pack_table(bt), uc.pack_table(pt)
        return (*ids, bp.packed, uc.f64_matrix(bp), pp.packed, uc.f64_matrix(pp)), bp, pp

    def run():
        args, bp, pp = packed()
        out_b, out_bf, out_p, out_pf, n_match = k4.compact_gather(*args)
        n = n_match.to(torch.int32)
        cb = uc.PackedTable(out_b, dict(zip(bp.layout.f64_fields, out_bf)), bp.layout)
        cp = uc.PackedTable(out_p, dict(zip(pp.layout.f64_fields, out_pf)), pp.layout)
        return uc.unpack_table(cb, bt.schema, n), uc.unpack_table(cp, pt.schema, n)
    args = packed()[0]
    return run, (lambda: k4.compact_gather(*args)), (lambda: k4.compact_gather_plain(*args))


def k4_cells(torch, captured: dict, g, device, explore: bool) -> dict:
    out = {}
    sm = smoke()
    calls = dict(captured)
    calls[K4_KINDS] = k4_kinds_call(torch, g, device)
    for name, call in calls.items():
        run, alone, plain = k4_versions(torch, call)
        fn = alone or run
        got, want = fn(), plain()
        n_match = int(got[-1])
        out_cap = call["match"].shape[0]
        k = out_cap if call["total"] is None else min(int(call["total"]), out_cap)
        cell = {"shape": {"out_cap": out_cap, "total": int(call["total"]), "n_match": n_match,
                          "build": [(str(v.dtype)[6:], v.shape[0]) for v, _ in call["build"]],
                          "probe": [(str(v.dtype)[6:], v.shape[0]) for v, _ in call["probe"]]},
                "equal_plain": agrees(sm.max_abs_err, got, want),
                "same_bits_twice": agrees(sm.max_abs_err, got, fn()),
                "ms": cuda_ms(torch, run),
                "bound_bytes": sm.k4_bytes(out_cap, k, n_match, call["build"], call["probe"])}
        if alone is not None:
            cell["k4_alone_ms"] = cuda_ms(torch, alone)
        if explore:
            from profile_csr_call import launch_split
            cell["launches"] = launch_split(torch, lambda: run(), ())
        del got, want, run, alone, plain, fn
        out[name] = cell
        torch.cuda.empty_cache()
    return out


def splits(torch, g, device):
    """--explore: K2 at Q9 and K3 at Q7, launch by launch."""
    from profile_csr_call import launch_split

    from datafusion_parallelism_tpu_torch.kernels import csr_build as k2
    from datafusion_parallelism_tpu_torch.kernels import probe_expand as k3
    out = {}
    n, T, R, _, valid, where, hot = K2_CELLS["K2 Q9"]
    slot, rows = k2_inputs(torch, g, device, n, T, R, valid, where, hot)
    out["K2 Q9"] = launch_split(torch, k2.csr_build, (slot, T, rows))
    del slot, rows
    n, T, valid, m, ok_rows, out_cap, hot, layout = K3_CELLS["K3 Q7"]
    offsets, _, bwords, pslot, ok, pwords, rm = k3_inputs(torch, g, device, n, T, valid, m,
                                                          ok_rows, hot, layout)
    got = k3.probe_ranges(pslot, ok, offsets)
    out["K3 Q7 probe_ranges"] = launch_split(torch, k3.probe_ranges, (pslot, ok, offsets))
    out["K3 Q7 expand_ranges"] = launch_split(
        torch, k3.expand_ranges, (*got, pwords, rm, [([0], [0], None, (1, 0))], out_cap))
    del offsets, bwords, pslot, ok, pwords, rm, got
    torch.cuda.empty_cache()
    return out


def child(root: str, calls: str, seed: int, explore: bool) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))
    os.environ["DFP_NO_CAP_STORE"] = "1"
    import torch
    from profile_agg_compact_call import to_device

    from datafusion_parallelism_tpu_torch.kernels import _build
    _build.build()
    device = torch.device("cuda", 0)
    g = torch.Generator(device=device).manual_seed(seed)
    captured = to_device(torch, torch.load(calls, weights_only=False), device)
    cells = {**k2_cells(torch, g, device, explore), **k3_cells(torch, g, device),
             **k4_cells(torch, captured, g, device, explore)}
    res = {"root": os.path.abspath(root), "cells": cells}
    if explore:
        res["splits"] = splits(torch, g, device)
    return res


def save_calls(path: str) -> None:
    """Capture K4's calls (k4_capture) at chip_smoke's SF and save them on
    the host."""
    sys.path.insert(0, REPO)
    os.environ["DFP_NO_CAP_STORE"] = "1"
    import torch
    from profile_agg_compact_call import to_device
    smoke().phase_build()
    captured = k4_capture(torch, smoke().TPCH_SF, torch.device("cuda", 0))
    torch.save(to_device(torch, captured, "cpu"), path)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None, help="another checkout, run in turn with this one")
    ap.add_argument("--root", default=None, help=argparse.SUPPRESS)   # one process's version
    ap.add_argument("--save", default=None, help=argparse.SUPPRESS)   # capture into this file
    ap.add_argument("--calls", default=None, help="K4's captured calls (saved by an earlier run)")
    ap.add_argument("--seed", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=1, help="turns of the four-run order")
    ap.add_argument("--explore", action="store_true",
                    help="also time K2's row gathers, and split the "
                         "Q9 and Q7 calls (this checkout)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.save is not None:
        save_calls(args.save)
        return 0
    if args.root is not None:
        print(json.dumps(child(args.root, args.calls, args.seed, args.explore)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("bench_csr_join: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    calls = args.calls
    if calls is None:
        calls = os.path.join(REPO, "_data", "k4_calls.pt")
        os.makedirs(os.path.dirname(calls), exist_ok=True)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--save", calls],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
    order = ([("parent", args.parent), ("change", REPO), ("change", REPO),
              ("parent", args.parent)] if args.parent else [("change", REPO)]) * args.rounds
    runs = []
    for label, root in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--root", root, "--calls", calls,
               "--seed", str(args.seed)]
        if args.explore and label == "change":
            cmd.append("--explore")
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append({"label": label, **json.loads(proc.stdout.strip().splitlines()[-1])})
    spread = {}
    for r in runs:
        for name, c in r["cells"].items():
            for k in ("bound_bytes", "ranges_bound_bytes", "expand_bound_bytes"):
                if k in c:
                    c[k.replace("bytes", "ms")] = c[k] / HBM_BYTES_PER_S * 1e3
            cell = spread.setdefault(name, {}).setdefault(r["label"], {})
            for k, v in c.items():
                if k.endswith("_ms") or k.endswith(" ms") or k == "ms":
                    cell.setdefault(k, []).append(v)
    summary = {name: {label: {k: f"{statistics.median(v):.4f} [{min(v):.4f}-{max(v):.4f}]"
                              for k, v in sides.items()} for label, sides in labels.items()}
               for name, labels in spread.items()}
    line = json.dumps({"card": card, "summary": summary, "spread": spread, "runs": runs})
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    ok = all(v for r in runs for c in r["cells"].values() for k, v in c.items()
             if "equal" in k or k == "same_bits_twice")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
