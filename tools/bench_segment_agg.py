#!/usr/bin/env python3
"""K7 segment_agg timed at its SQL shapes, on one NVIDIA GPU.

    python3 tools/bench_segment_agg.py [--parent DIR] [--rounds N] [--explore]
                                       [--calls FILE] [--out FILE]

Cells:
  - K7's calls in the first run of TPC-H Q18 at SF10 through SQL (the
    capacities the planner seeds, as `chip_smoke.py` phase 15 replays
    them): the largest by the bytes of its arguments (phase 15's call, the
    outer grouping: 4,473 rows in a 2^25 capacity) and the one with the
    most valid rows (the grouping of lineitem by l_orderkey);
    --calls reads a file that an earlier run saved, else they are captured
    first and kept in `_data/segment_agg_calls.pt`;
  - Q18-shaped: 2^26 rows, an int64 key of about 4 rows a group, an int64
    sum;
  - one group over 2^26 rows, the same sum (the longest carry chain);
  - 4,473 valid rows (groups of about 7) in a capacity of 2^25, the same
    sum.
Per cell: the kernel's ms (CUDA events around the wrapper, median of 20
after a warm-up); whether it equals `segment_agg_plain` by
`chip_smoke.py`'s check (integers bit for bit, float64 sums within rtol
1e-9 + 1e-12 sum|x|) and gives the same bits twice; two bounds at 3.35
TB/s: the bytes its inputs need below n_valid and its outputs
(`chip_smoke.py::k7_work`), and every byte of its arguments
and outputs (the bound as counted before); chip_smoke's partial
yardstick (`torch.unique_consecutive` over the key words with its counts,
then one `torch.segment_reduce` a float request). The checks and
yardsticks are this checkout's in both turns.

With --parent (a checkout of another commit, e.g. the parent unpacked with
`git archive` under `_data/`), each version runs in its own process in the
order parent, change, change, parent (--rounds times) on the same inputs;
`summary` gives each cell's median [min-max] over the runs. --explore
(this checkout only) also splits every cell launch by launch under
`torch.profiler`. Prints one JSON object with the card's name and power
limit; also written to --out. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

from bench_agg_compact import agrees, cuda_ms, smoke
from profile_agg_compact_call import to_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory rate
BIG = 1 << 26
FEW_CAP, FEW_ROWS = 1 << 25, 4473
ENTRY = ("chain", "segment_agg")
# name: (FEW_ROWS valid in FEW_CAP, else BIG valid rows; rows a group, 0: one group)
SYNTHETIC = {"Q18-shaped: 2^26 rows, groups of ~4, int64 sum": (False, 4),
             "one group over 2^26 rows, int64 sum": (False, 0),
             "4,473 valid rows in 2^25, groups of ~7, int64 sum": (True, 7)}


def capture(torch, sf: float, device) -> dict:
    """{label: arguments} of K7's calls in the first run of Q18 over TPC-H
    at `sf`: the largest by the bytes of its arguments, and the one with
    the most valid rows."""
    sm = smoke()
    from datafusion_parallelism_tpu_torch import SessionContext
    from datafusion_parallelism_tpu_torch.kernels.chain import KERNELS
    from datafusion_parallelism_tpu_torch.tpch import QUERIES, generate_tables
    ctx = SessionContext(device=device)
    for name, t in generate_tables(sf=sf).items():
        ctx.register_table(name, t)
    calls = []

    def record(*args):
        calls.append(args)
        return KERNELS.segment_agg(*args)
    ctx.sql(QUERIES[18], chain=KERNELS._replace(segment_agg=record)).collect()
    for reg in ctx.catalog.tables.values():
        reg.release_device()
    del ctx
    return {"K7 Q18, the largest call (phase 15's)": max(calls, key=sm._bytes),
            "K7 Q18, the most valid rows": max(calls, key=lambda a: int(a[2]))}


def synthetic(torch, g, device, cap: int, rows: int, group: int):
    """segment_agg's arguments: an int64 key over the first `rows` of
    `cap` (sorted, about `group` rows a group; 0: one group), zeros past
    them, and the sum of an int64 column."""
    from datafusion_parallelism_tpu_torch.ops.hashing import key_words
    key = torch.zeros(cap, dtype=torch.int64, device=device)
    if group:
        key[:rows] = torch.sort(torch.randint(0, max(rows // group, 1), (rows,), generator=g,
                                              device=device))[0] * 7919
    ones = torch.ones(cap, dtype=torch.bool, device=device)
    words, cols = key_words([(key, ones)])
    v = torch.randint(-2**40, 2**40, (cap,), generator=g, device=device)
    return (words, cols, torch.tensor(rows, dtype=torch.int32, device=device), [("sum", v, None)],
            cap)


def k7_cell(torch, args, explore: bool) -> dict:
    from datafusion_parallelism_tpu_torch.kernels import segment_agg as k7
    sm = smoke()
    words, cols, n_valid, reqs, out_cap = args
    got = k7.segment_agg(*args)
    again = k7.segment_agg(*args)
    want = k7.segment_agg_plain(*args)
    cell = {"shape": {"cap": words.shape[1], "R": words.shape[0], "key_columns": len(cols),
                      "n_valid": int(n_valid), "out_cap": out_cap, "n_groups": int(got[3]),
                      "ops": [f"{f} {str(v.dtype)[6:]}" for f, v, _ in reqs]},
            "equal_plain": agrees(sm.entry_err, "segment_agg", args, got, want),
            "same_bits_twice": agrees(sm.max_abs_err, got, again),
            "ms": cuda_ms(lambda: k7.segment_agg(*args)),
            "bound_bytes": sm.work(ENTRY, args, got)[0],
            "bound_all_rows_bytes": sm._bytes([args, got]),
            "library_partial_ms": cuda_ms(sm.partial_call(ENTRY, args))}
    if explore:
        from profile_csr_call import launch_split
        try:
            cell["launches"] = launch_split(torch, k7.segment_agg, args)
        except RuntimeError:   # a profiled call that lost activities: once more
            cell["launches"] = launch_split(torch, k7.segment_agg, args)
    return cell


def run_cells(torch, captured: dict, g, device, explore: bool) -> dict:
    """Every cell: the captured calls, then the synthetic ones made from
    `g` on `device`."""
    cells = {label: k7_cell(torch, args, explore) for label, args in captured.items()}
    for name, (few, group) in SYNTHETIC.items():
        cap, rows = (FEW_CAP, FEW_ROWS) if few else (BIG, BIG)
        cells[name] = k7_cell(torch, synthetic(torch, g, device, cap, rows, group), explore)
    return cells


def child(root: str, calls: str, seed: int, explore: bool) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))
    os.environ["DFP_NO_CAP_STORE"] = "1"
    import torch

    from datafusion_parallelism_tpu_torch.kernels import _build
    _build.build()
    device = torch.device("cuda", 0)
    g = torch.Generator(device=device).manual_seed(seed)
    captured = to_device(torch, torch.load(calls, weights_only=False), device)
    return {"root": os.path.abspath(root),
            "cells": run_cells(torch, captured, g, device, explore)}


def save_calls(path: str) -> None:
    """Capture Q18's calls at chip_smoke's SF and save them on the host."""
    sys.path.insert(0, REPO)
    os.environ["DFP_NO_CAP_STORE"] = "1"
    import torch
    smoke().phase_build()
    captured = capture(torch, smoke().TPCH_SF, torch.device("cuda", 0))
    torch.save(to_device(torch, captured, "cpu"), path)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None, help="another checkout, run in turn with this one")
    ap.add_argument("--root", default=None, help=argparse.SUPPRESS)   # one process's version
    ap.add_argument("--save", default=None, help=argparse.SUPPRESS)   # capture into this file
    ap.add_argument("--calls", default=None, help="captured calls (saved by an earlier run)")
    ap.add_argument("--seed", type=int, default=12)
    ap.add_argument("--rounds", type=int, default=1, help="turns of the four-run order")
    ap.add_argument("--explore", action="store_true",
                    help="also split every cell launch by launch (this checkout)")
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
        print("bench_segment_agg: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    calls = args.calls
    if calls is None:
        calls = os.path.join(REPO, "_data", "segment_agg_calls.pt")
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
            c["bound_ms"] = c["bound_bytes"] / HBM_BYTES_PER_S * 1e3
            c["bound_all_rows_ms"] = c["bound_all_rows_bytes"] / HBM_BYTES_PER_S * 1e3
            cell = spread.setdefault(name, {}).setdefault(r["label"], {})
            for k, v in c.items():
                if k == "ms" or k.endswith("_ms"):
                    cell.setdefault(k, []).append(v)
    summary = {name: {label: {k: f"{statistics.median(v):.4f} [{min(v):.4f}-{max(v):.4f}]"
                              for k, v in sides.items()} for label, sides in labels.items()}
               for name, labels in spread.items()}
    line = json.dumps({"card": card, "summary": summary, "spread": spread, "runs": runs})
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    ok = all(c["equal_plain"] and c["same_bits_twice"] for r in runs for c in r["cells"].values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
