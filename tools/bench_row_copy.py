#!/usr/bin/env python3
"""K13 append_rows and K11 concat_rows timed at their SQL shapes, on one NVIDIA GPU.

    python3 tools/bench_row_copy.py [--parent DIR] [--rounds N] [--out FILE]

Times the two row copies (K13, K11) on seeded packed rows made on the card, at
the shapes of their largest calls in `chip_smoke.py` phase 15 (TPC-H SF10:
K13 at Q2's grace union, phase 16; K11 at Q13's LEFT join, phase 14) and at
a large unaligned append (4,194,304 rows of 13 words and 2 float64
sidecars at an odd offset into 16,777,216 rows). Per cell: the kernel's ms
(CUDA events around the wrapper, median of 20 after a warm-up), whether it
equals its plain version bit for bit, the bound (bytes moved once at
3.35 TB/s) and two library yardsticks: the same torch.cat / slice copy_
with the device counts read before the timing, and with them read inside
it, as the kernels read them.

With --parent (a checkout of another commit, e.g. the parent unpacked with
`git archive` under `_data/`), each version runs in its own process in the
order parent, change, change, parent (--rounds times), so both are
compared on one card in one call. Prints one JSON object with the card's
name and power limit, every run, and per cell and version the runs' ms
and library ms side by side (`spread`); also written to --out. Needs a
CUDA device.
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

# name -> (kernel, shape); shapes as chip_smoke.py phase 15 prints them
CELLS = {
    "K13 Q2 grace union (phase 16)": ("append_rows", dict(
        w=12, f=0, acc_cap=8192, acc_rows=0, cap=4096, num_rows=2361)),
    "K13 large unaligned append": ("append_rows", dict(
        w=13, f=2, acc_cap=1 << 24, acc_rows=(1 << 22) + 12345, cap=1 << 22,
        num_rows=1 << 22)),
    "K11 Q13 LEFT join (phase 14)": ("concat_rows", dict(
        w=5, f=0, caps=[1 << 25, 1 << 21], num_rows=[14_921_814, 1_000_000])),
}


def rows(torch, g, w, f, cap, device):
    """Packed rows: int32 words [w, cap], float64 sidecars [f, cap] of
    random 64-bit patterns."""
    words = torch.randint(-2**31, 2**31, (w, cap), generator=g, device=device,
                          dtype=torch.int64).to(torch.int32)
    bits = torch.randint(-2**63, 2**63 - 1, (f, cap), generator=g, device=device,
                         dtype=torch.int64)
    return words, bits.view(torch.float64)


def count(torch, n, device):
    return torch.tensor(n, dtype=torch.int32, device=device)


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
    a = [t.view(torch.int64) if t.dtype == torch.float64 else t for t in a]
    b = [t.view(torch.int64) if t.dtype == torch.float64 else t for t in b]
    return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


def append_cell(torch, g, device, s):
    from datafusion_parallelism_tpu_torch.kernels import append_rows as k13
    acc, acc_f64 = rows(torch, g, s["w"], s["f"], s["acc_cap"], device)
    words, f64 = rows(torch, g, s["w"], s["f"], s["cap"], device)
    acc_rows, num_rows = count(torch, s["acc_rows"], device), count(torch, s["num_rows"], device)
    a1, f1, a2, f2 = acc.clone(), acc_f64.clone(), acc.clone(), acc_f64.clone()
    n1 = k13.append_rows(a1, f1, acc_rows, words, f64, num_rows)
    n2 = k13.append_rows_plain(a2, f2, acc_rows, words, f64, num_rows)
    equal = bits_equal(torch, (n1, a1, f1), (n2, a2, f2))
    del a1, f1, a2, f2
    k = max(0, min(s["num_rows"], s["cap"], s["acc_cap"] - s["acc_rows"]))
    nbytes = 2 * k * (4 * s["w"] + 8 * s["f"]) + 12
    lo = s["acc_rows"]

    def copy_before():
        return (acc[:, lo:lo + k].copy_(words[:, :k]), acc_f64[:, lo:lo + k].copy_(f64[:, :k]))

    def copy_inside():
        lo_ = int(acc_rows)
        k_ = max(min(int(num_rows), words.shape[1], acc.shape[1] - lo_), 0)
        return (acc[:, lo_:lo_ + k_].copy_(words[:, :k_]),
                acc_f64[:, lo_:lo_ + k_].copy_(f64[:, :k_]))

    return (equal, nbytes, lambda: k13.append_rows(acc, acc_f64, acc_rows, words, f64, num_rows),
            copy_before, copy_inside)


def concat_cell(torch, g, device, s):
    from datafusion_parallelism_tpu_torch.kernels import concat_rows as k11
    parts = [(*rows(torch, g, s["w"], s["f"], c, device), count(torch, n, device))
             for c, n in zip(s["caps"], s["num_rows"])]
    equal = bits_equal(torch, k11.concat_rows(parts), k11.concat_rows_plain(parts))
    total_cap = sum(s["caps"])
    row = 4 * s["w"] + 8 * s["f"]
    nbytes = sum(min(n, c) for n, c in zip(s["num_rows"], s["caps"])) * row + total_cap * row + 4
    ns = list(s["num_rows"])

    def cat(ks):
        return (torch.cat([w[:, :k] for (w, _, _), k in zip(parts, ks)], 1),
                torch.cat([f[:, :k] for (_, f, _), k in zip(parts, ks)], 1))

    return (equal, nbytes, lambda: k11.concat_rows(parts), lambda: cat(ns),
            lambda: cat([int(n) for _, _, n in parts]))


def child(root: str, seed: int) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from datafusion_parallelism_tpu_torch.kernels import _build
    _build.build()
    device = torch.device("cuda", 0)
    out = {"root": os.path.abspath(root), "cells": {}}
    for name, (kernel, shape) in CELLS.items():
        g = torch.Generator(device=device).manual_seed(seed)
        make = append_cell if kernel == "append_rows" else concat_cell
        equal, nbytes, fn, lib_before, lib_inside = make(torch, g, device, shape)
        out["cells"][name] = {
            "shape": shape, "equal_plain": equal, "ms": cuda_ms(torch, fn),
            "library_ms": cuda_ms(torch, lib_before),
            "library_sync_ms": cuda_ms(torch, lib_inside),
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        del fn, lib_before, lib_inside
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None, help="another checkout, run in turn with this one")
    ap.add_argument("--root", default=None, help=argparse.SUPPRESS)   # one process's version
    ap.add_argument("--seed", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=1, help="turns of the four-run order")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.root is not None:
        print(json.dumps(child(args.root, args.seed)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("bench_row_copy: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    order = ([("parent", args.parent), ("change", REPO), ("change", REPO),
              ("parent", args.parent)] if args.parent else [("change", REPO)]) * args.rounds
    runs = []
    for label, root in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--root", root,
                               "--seed", str(args.seed)], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append({"label": label, **json.loads(proc.stdout.strip().splitlines()[-1])})
    spread = {}
    for r in runs:
        for name, c in r["cells"].items():
            cell = spread.setdefault(name, {}).setdefault(r["label"], {})
            for k in ("ms", "library_ms", "library_sync_ms"):
                cell.setdefault(k, []).append(c[k])
    line = json.dumps({"card": card, "spread": spread, "runs": runs})
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if all(c["equal_plain"] for r in runs for c in r["cells"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
