#!/usr/bin/env python3
"""K18 dest_pack, the distributed join's index grid, timed at the shapes of
`chip_smoke.py` phase 19's three largest calls on one NVIDIA GPU.

    python3 tools/bench_dest_pack.py [--parent DIR] [--rounds N] [--explore] [--out FILE]

Cells (seeded hashes made on the card with torch alone, so every checkout
gets the same inputs; P = 8 destinations as phase 19's mesh):
  - route: phase 19's largest plain route, a shard of SF10 lineitem (the
    orders x lineitem join): 7,499,677 rows in capacity 8,388,608, random
    hashes, send_cap = the capacity;
  - salted: a Size512 probe shard, 524,288 rows, 30% of them in the 8 of
    256 hash buckets the heavy table marks, which stay on rank 3, send_cap
    = the capacity;
  - heavy_to_all: the same shard's build side, its heavy rows sent to all
    8 destinations (replicating_shuffle), send_cap = the capacity;
  - P = 1024: 2^20 rows at random, send_cap 2,048 (twice the fair share:
    the large-P range of the kernel's contract).
Phase 19 captures its calls from the distributed joins; these cells are
made at those calls' shapes (rows, capacity, P, send_cap, kind), their
hashes random and the heavy share chosen here.

Per cell: the kernel's ms (CUDA events around the wrapper, median of 20
after a warm-up), whether it equals its plain version bit for bit and
gives the same bits twice, its dropped count and the bound: phase 19's
bytes (the hash and mask, the replicate flags and heavy table where
given, read once; the whole grid and the counts written once) at
3.35 TB/s.

With --parent (a checkout of another commit, e.g. the parent unpacked with
`git archive` under `_data/`), each version runs in its own process in the
order parent, change, change, parent (--rounds times) on the same inputs;
`summary` gives each cell's median [min-max] over the runs. --explore
(this checkout only) splits every cell launch by launch under
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

from bench_agg_compact import smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory rate
P_MESH = 8
HEAVY_BUCKETS = 8
HEAVY_SHARE = 0.3
RANK = 3
# name: (capacity, rows in the mask, P, send_cap, kind)
CELLS = {
    "K18 route (SF10 lineitem shard)": (8_388_608, 7_499_677, P_MESH, 8_388_608, "route"),
    "K18 salted (Size512 probe shard)": (524_288, 524_288, P_MESH, 524_288, "salted"),
    "K18 heavy_to_all (Size512 build shard)": (524_288, 524_288, P_MESH, 524_288,
                                               "heavy_to_all"),
    "K18 P = 1024 (2^20 rows, send_cap 2,048)": (1 << 20, 1 << 20, 1024, 2048, "route"),
}


def cuda_ms(fn) -> float:
    return smoke().cuda_ms(fn, reps=20)


def inputs(torch, g, device, cap, rows, P, send_cap, kind):
    """dest_pack's arguments (hashes, mask, P, send_cap, heavy, rank,
    replicate, heavy_to_all) of a cell."""
    h = torch.randint(-2**31, 2**31, (cap,), generator=g, device=device,
                      dtype=torch.int64)
    mask = torch.arange(cap, device=device) < rows
    heavy = None
    if kind != "route":
        heavy = torch.zeros(256, dtype=torch.bool, device=device)
        buckets = torch.randperm(256, generator=g, device=device)[:HEAVY_BUCKETS]
        heavy[buckets] = True
        into = torch.rand(cap, generator=g, device=device) < HEAVY_SHARE
        pick = buckets[torch.randint(0, HEAVY_BUCKETS, (cap,), generator=g, device=device)]
        h = torch.where(into, (pick.long() << 24) | (h & 0xFFFFFF), h)
    h = torch.where(h >= 2**31, h - 2**32, h).to(torch.int32)   # uint32 bits in int32
    return (h, mask, P, send_cap, heavy, RANK if heavy is not None else 0, None,
            kind == "heavy_to_all")


def bound_bytes(args) -> int:
    """Phase 19's count (`chip_smoke.py::_k18_k19_vs_plain`)."""
    h, _, P, send_cap, heavy, _, rep, _ = args
    return (h.numel() * (5 + (rep is not None)) + 256 * (heavy is not None)
            + 4 * P * (send_cap + 1) + 4)


def equal(torch, a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


def cell(torch, k18, args, explore: bool) -> dict:
    got = k18.dest_pack(*args)
    again = k18.dest_pack(*args)
    want = k18.dest_pack_plain(*args)
    h, mask, P, send_cap = args[:4]
    out = {"shape": {"cap": h.numel(), "rows": int(mask.sum()), "P": P, "send_cap": send_cap,
                     "members": int(got[1].long().sum()), "dropped": int(got[2])},
           "equal_plain": equal(torch, got, want), "same_bits_twice": equal(torch, got, again),
           "ms": cuda_ms(lambda: k18.dest_pack(*args)), "bound_bytes": bound_bytes(args)}
    if explore:
        from profile_csr_call import launch_split
        out["launches"] = launch_split(torch, k18.dest_pack, args)
    return out


def child(root: str, seed: int, explore: bool) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))
    import torch

    from datafusion_parallelism_tpu_torch.kernels import _build
    from datafusion_parallelism_tpu_torch.kernels import dest_pack as k18
    _build.build()
    device = torch.device("cuda", 0)
    cells = {}
    for i, (name, spec) in enumerate(CELLS.items()):
        g = torch.Generator(device=device).manual_seed(seed * 1000 + i)
        args = inputs(torch, g, device, *spec)
        cells[name] = cell(torch, k18, args, explore)
        del args
        torch.cuda.empty_cache()
    return {"root": os.path.abspath(root), "cells": cells}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None, help="another checkout, run in turn with this one")
    ap.add_argument("--root", default=None, help=argparse.SUPPRESS)   # one process's version
    ap.add_argument("--seed", type=int, default=15)
    ap.add_argument("--rounds", type=int, default=1, help="turns of the four-run order")
    ap.add_argument("--explore", action="store_true",
                    help="also split every cell launch by launch (this checkout)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.root is not None:
        print(json.dumps(child(args.root, args.seed, args.explore)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("bench_dest_pack: no CUDA device", file=sys.stderr)
        return 1
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
            c["bound_ms"] = c["bound_bytes"] / HBM_BYTES_PER_S * 1e3
            side = spread.setdefault(name, {}).setdefault(r["label"], {})
            for k, v in c.items():
                if k == "ms" or k.endswith("_ms"):
                    side.setdefault(k, []).append(v)
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
