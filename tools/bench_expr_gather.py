#!/usr/bin/env python3
"""K17 expr_eval and K5's row gather timed at their SQL shapes, on one NVIDIA GPU.

    python3 tools/bench_expr_gather.py [--parent DIR] [--rounds N] [--explore] [--out FILE]

Cells (TPC-H SF10 shapes, seeded data made on the card):
  - K17 at Q1's projection (29 instructions over 5 registers, 3 columns
    in, 2 outputs) and at Q6's predicate (mask mode), over lineitem's
    capacity, 67,108,864 rows, 59,997,411 of them valid; the programs are
    compiled from the queries on a small CPU session, as the SQL path
    compiles them;
  - K5's gather at Q20's grouping (5 words, 67,108,864 rows; a head of
    9,193,894 rows, 13.7%, in random order, then the other rows in source
    order), without the count (every row read) and with it (rows past the
    count zeros, unread);
  - K5 at the 4,194,304-row sort of 13 columns (14 words, a random
    permutation, the count = every row) and at a SORT build's shape
    (33,554,432 rows of 4 words and 1 float64 sidecar, 15,000,000 valid
    rows in random order, then the rest in order).
Per cell: the kernel's ms (CUDA events around the wrapper, median of 20
after a warm-up), whether it equals its plain version bit for bit, the
bound (bytes the call must move at 3.35 TB/s: K5's from
`kernels/filter_compact.py::gather_bytes`) and, for K5, the library
yardstick: index_select of the words and of the sidecars (then
torch.where past the count, where one is given).

With --parent (a checkout of another commit, e.g. the parent unpacked with
`git archive` under `_data/`), each version runs in its own process in the
order parent, change, change, parent (--rounds times), so both are
compared on one card in one call; `spread` lists every run's ms side by
side. --explore (this checkout only) also times K17 at every tile that
fits and K5 in each layout, at these cells and at a W 5 random gather of
2^22 to 2^26 rows. Prints one JSON object with the card's name and power
limit; also written to --out. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory rate

LINEITEM_CAP = 67_108_864           # SF10 lineitem's capacity
LINEITEM_ROWS = 59_997_411          # SF10 lineitem's rows
# (W, F, cap, head rows in random order or None for a full permutation,
#  count given)
GATHERS = {
    "K5 Q20 grouping gather, no count": (5, 0, LINEITEM_CAP, 9_193_894, False),
    "K5 Q20 grouping gather, count": (5, 0, LINEITEM_CAP, 9_193_894, True),
    "K5 4M-row 13-column sort gather": (14, 0, 1 << 22, None, True),
    "K5 SORT build gather (2^25 rows)": (4, 1, 1 << 25, 15_000_000, False),
}
# column -> (low, high) of its values (TPC-H's ranges; decimals in cents)
LINEITEM_RANGES = {"l_quantity": (100, 5001), "l_extendedprice": (90_000, 10_494_951),
                   "l_discount": (0, 11), "l_tax": (0, 9), "l_shipdate": (8036, 10562)}


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


def bits_equal(torch, a, b) -> bool:
    def flat(x):
        if isinstance(x, torch.Tensor):
            return [x.view(torch.int64) if x.dtype == torch.float64 else
                    x.view(torch.int32) if x.dtype == torch.float32 else x]
        return [t for y in x for t in flat(y)]
    return all(torch.equal(x, y) for x, y in zip(flat(a), flat(b), strict=True))


def query_programs():
    """{"Q1": (program, column dtypes, mask kinds), "Q6": ...}: Q1's largest
    projection and Q6's predicate, as the SQL path compiles them (a small
    CPU session; the programs do not depend on the scale)."""
    import torch
    from datafusion_parallelism_tpu_torch import SessionContext
    from datafusion_parallelism_tpu_torch.kernels import expr_eval as k17
    from datafusion_parallelism_tpu_torch.tpch import QUERIES, generate_tables
    seen = []
    plain = k17.expr_eval_plain

    def record(program, columns, n, scalars, mask=None, device=None):
        kinds = None if mask is None else tuple(x is not None for x in mask)
        seen.append((program, tuple(v.dtype for v, _ in columns), kinds))
        return plain(program, columns, n, scalars, mask, device)

    k17.expr_eval_plain = record
    try:
        ctx = SessionContext(device="cpu")
        for name, t in generate_tables(sf=0.001).items():
            ctx.register_table(name, t)
        out = {}
        for q, masked in ((1, False), (6, True)):
            seen.clear()
            ctx.sql(QUERIES[q]).collect()
            calls = [c for c in seen if (c[2] is not None) == masked]
            out[f"Q{q}"] = max(calls, key=lambda c: len(c[0].code))
    finally:
        k17.expr_eval_plain = plain
    return out


def probe_programs():
    """--explore's programs over Q1's columns: the memory alone (two sums
    of two columns, Q1's reads and int64 writes) and Q1's arithmetic twice
    over (the cost an instruction adds)."""
    import numpy as np
    import torch
    from datafusion_parallelism_tpu_torch.ops.expressions import BinOp, Col, Lit, compile_exprs
    from datafusion_parallelism_tpu_torch.utils.columnar import DECIMAL, INT32, HostTable
    names = ("l_extendedprice", "l_discount", "l_tax")
    t = HostTable.from_numpy({c: np.arange(4) for c in names},
                             dtypes={c: DECIMAL(2) for c in names}).to_device(device="cpu")
    price, disc, tax = (Col(c) for c in names)

    def charge(x):
        return BinOp("*", BinOp("*", x, BinOp("-", Lit(1, INT32), disc)),
                     BinOp("+", Lit(1, INT32), tax))

    out = {}
    for label, exprs in (("memory", [BinOp("+", price, disc), BinOp("+", tax, price)]),
                         ("Q1 arithmetic twice", [charge(charge(price)), charge(price)])):
        program, _ = compile_exprs(exprs, t)
        out[label] = (program, tuple(torch.int64 for _ in program.cols), None)
    return out


def lineitem_columns(torch, g, program, dtypes, n, rows, device):
    """(values, validity) of the program's columns: seeded values in TPC-H's
    ranges below `rows`, zeros and NULL past it (as a capacity-padded
    table holds them)."""
    valid = torch.arange(n, device=device) < rows
    cols = []
    for name, dtype in zip(program.cols, dtypes):
        lo, hi = LINEITEM_RANGES[name.split(".")[-1]]
        v = torch.randint(lo, hi, (n,), generator=g, device=device, dtype=torch.int64)
        v = (v.to(dtype) / 100 if dtype.is_floating_point else v.to(dtype))
        cols.append((torch.where(valid, v, torch.zeros((), dtype=dtype, device=device)), valid))
    return cols


def expr_cells(torch, g, device, explore: bool):
    from datafusion_parallelism_tpu_torch.kernels import expr_eval as k17
    out = {}
    programs = query_programs()
    if explore:
        programs.update(probe_programs())
    for q, (program, dtypes, kinds) in programs.items():
        n = LINEITEM_CAP
        cols = lineitem_columns(torch, g, program, dtypes, n, LINEITEM_ROWS, device)
        mask = None
        if kinds is not None:
            mask = (torch.tensor(LINEITEM_ROWS, dtype=torch.int32, device=device)
                    if kinds[0] else None,
                    (torch.rand(n, generator=g, device=device) < 0.5) if kinds[1] else None)
        def fn():
            return k17.expr_eval(program, cols, n, (), mask, device)
        equal = bits_equal(torch, fn(), k17.expr_eval_plain(program, cols, n, (), mask, device))
        out_bytes = n if mask is not None else sum(
            n * (torch.empty((), dtype=dt).element_size() + 1) for _, dt in program.roots)
        nbytes = sum(v.nbytes + ok.nbytes for v, ok in cols) + out_bytes
        if mask is not None and mask[1] is not None:
            nbytes += mask[1].nbytes
        cell = {"shape": {"instructions": len(program.code), "registers": program.n_regs,
                          "columns": len(program.cols), "outputs": len(program.roots),
                          "mask": kinds is not None, "rows": n},
                "equal_plain": equal, "ms": cuda_ms(torch, fn), "bytes": nbytes}
        if explore and hasattr(k17, "plan_tile"):
            from datafusion_parallelism_tpu_torch.kernels import _build
            lim = _build.device_limits(device)
            roots = 1 if mask is not None else len(program.roots)
            cell["tile"] = k17.plan_tile(program.n_regs, len(program.code), roots,
                                         lim.smem_block, lim.smem_sm)
            tiles = {}
            for tile in range(k17.BLOCK, 2 * k17.MAX_TILE + 1, k17.BLOCK):
                if k17.smem_bytes(program.n_regs, len(program.code), roots, tile) > lim.smem_block:
                    break
                def at(t=tile):
                    return k17._launch(program, cols, n, (), mask, device, t)
                ok = bits_equal(torch, at(), fn())
                tiles[tile] = {"ms": cuda_ms(torch, at), "equal": ok}
            cell["tiles"] = tiles
        out[f"K17 {q} {'predicate' if kinds is not None else 'projection'}"] = cell
        del cols, mask
        torch.cuda.empty_cache()
    return out


def gather_inputs(torch, g, device, W, F, cap, head, counted):
    """Source rows, idx and count of one gather cell: a full random
    permutation (head None), or `head` random rows in random order, then
    the others in source order."""
    words = torch.randint(-2**31, 2**31, (W, cap), generator=g, device=device,
                          dtype=torch.int64).to(torch.int32)
    f64 = torch.randint(-2**63, 2**63 - 1, (F, cap), generator=g, device=device,
                        dtype=torch.int64).view(torch.float64)
    perm = torch.randperm(cap, generator=g, device=device)
    if head is None:
        idx, k = perm, cap
    else:
        picked = torch.zeros(cap, dtype=torch.bool, device=device)
        picked[perm[:head]] = True
        idx, k = torch.cat([perm[:head], torch.nonzero(~picked)[:, 0]]), head
    n = torch.tensor(k, dtype=torch.int64, device=device) if counted else None
    return words, f64, idx.to(torch.int32), n


def gather_cells(torch, g, device, explore: bool):
    from datafusion_parallelism_tpu_torch.kernels import filter_compact as k5
    out = {}
    cells = dict(GATHERS)
    if explore:
        cells.update({f"K5 W 5 random gather, 2^{b} rows": (5, 0, 1 << b, None, False)
                      for b in range(22, 27)})
    for name, (W, F, cap, head, counted) in cells.items():
        words, f64, idx, n = gather_inputs(torch, g, device, W, F, cap, head, counted)
        def fn():
            return k5.gather_rows(words, f64, idx, n)
        def lib():
            o, of = words.index_select(1, idx), f64.index_select(1, idx)
            if n is None:
                return o, of
            ok = torch.arange(idx.shape[0], device=device) < n
            return torch.where(ok, o, 0), torch.where(ok, of, 0.0)
        equal = bits_equal(torch, fn(), k5.gather_rows_plain(words, f64, idx, n))
        cell = {"shape": {"W": W, "F": F, "cap": cap, "m": cap,
                          "n": None if n is None else int(n)},
                "equal_plain": equal, "ms": cuda_ms(torch, fn),
                "library_ms": cuda_ms(torch, lib)}
        if explore and hasattr(k5, "gather_layout"):
            from datafusion_parallelism_tpu_torch.kernels import _build
            cell["layout"] = k5.gather_layout(cap, F, _build.device_limits(device).l2_bytes)
            cell["layouts"] = {}
            for layout in (k5.GATHER_WORD, k5.GATHER_WORD4):
                def at(lay=layout):
                    return k5._gather(words, f64, idx, n, lay)
                cell["layouts"][layout] = {"ms": cuda_ms(torch, at),
                                           "equal": bits_equal(torch, at(), fn())}
        out[name] = cell
        del words, f64, idx, n
        torch.cuda.empty_cache()
    return out


def child(root: str, seed: int, explore: bool) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    os.environ["DFP_NO_CAP_STORE"] = "1"
    import torch
    from datafusion_parallelism_tpu_torch.kernels import _build
    _build.build()
    device = torch.device("cuda", 0)
    g = torch.Generator(device=device).manual_seed(seed)
    cells = {**expr_cells(torch, g, device, explore), **gather_cells(torch, g, device, explore)}
    return {"root": os.path.abspath(root), "cells": cells}


def bound_ms(cell) -> float:
    """The cell's bound: K5's bytes from gather_bytes, K17's the columns
    read and outputs written once."""
    from datafusion_parallelism_tpu_torch.kernels.filter_compact import gather_bytes
    s = cell["shape"]
    nbytes = (gather_bytes(s["W"], s["F"], s["cap"], s["m"], s["n"]) if "W" in s
              else cell["bytes"])
    return nbytes / HBM_BYTES_PER_S * 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None, help="another checkout, run in turn with this one")
    ap.add_argument("--root", default=None, help=argparse.SUPPRESS)   # one process's version
    ap.add_argument("--seed", type=int, default=9)
    ap.add_argument("--rounds", type=int, default=1, help="turns of the four-run order")
    ap.add_argument("--explore", action="store_true",
                    help="also time every K17 tile and both K5 layouts (this checkout)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.root is not None:
        print(json.dumps(child(args.root, args.seed, args.explore)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("bench_expr_gather: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    order = ([("parent", args.parent), ("change", REPO), ("change", REPO),
              ("parent", args.parent)] if args.parent else [("change", REPO)]) * args.rounds
    runs = []
    for label, root in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--root", root, "--seed", str(args.seed)]
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
            c["bound_ms"] = bound_ms(c)
            cell = spread.setdefault(name, {}).setdefault(r["label"], {})
            for k in ("ms", "library_ms"):
                if k in c:
                    cell.setdefault(k, []).append(c[k])
    summary = {name: {label: {k: f"{statistics.median(v):.4f} [{min(v):.4f}-{max(v):.4f}]"
                              for k, v in sides.items()} for label, sides in labels.items()}
               for name, labels in spread.items()}
    line = json.dumps({"card": card, "summary": summary, "spread": spread, "runs": runs})
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if all(c["equal_plain"] for r in runs for c in r["cells"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
