#!/usr/bin/env python3
"""K10 match_flags and K19 key_histogram timed at the shapes of their
largest calls in `chip_smoke.py` (phases 15 and 19), on one NVIDIA GPU.

    python3 tools/bench_flags_hist.py [--parent DIR] [--rounds N] [--cells K10|K19] [--explore]
                                      [--out FILE]

Cells (seeded inputs made on the card with torch alone, so every checkout
gets the same ones):
  - K10 Q13: SF10 Q13's LEFT join (customer build, bcap 2^21; orders
    probe, mcap 2^24) at out_cap 2^25: 14,800,000 candidates, one a kept
    probe row in probe order, each a match to a random customer row; the
    join reads the visited flags;
  - K10 Q13 out of core: a streamed chunk of it (out_cap 2^24, mcap 2^22,
    4,140,000 candidates), the visited flags accumulated into a buffer
    that holds earlier chunks' flags (half the build rows set);
  - K10 RIGHT and FULL at Size512: 4,194,304 probe rows with a Poisson
    count of candidates each (5.2 M in out_cap 6,291,456), 80% of them
    matches at random build rows; RIGHT reads the probe flags, FULL both;
  - K10 hot build keys: the FULL cell with 30% of the matches on one
    build row;
  - K19 at one 524,288-row Size512 probe shard: random hashes; every row
    in one hash bucket; the rows in 4 buckets;
  - K19 over 8 such shards in one histogram (phase 19's P = 8), random
    hashes, the last shard holding 400,000 rows.
Each version runs its own calls: this checkout's K10 takes the candidate
total and only the flags its join reads, and K19 takes every shard in one
launch with the row mask made inside; a parent's K10 writes both flags
over every slot, and its K19 runs the `row_mask` glue and one launch a
shard, as `parallel/skew.py` ran them.

Per cell: the kernel's ms (CUDA events around the call, median of 20 after
a warm-up), whether it equals its plain version bit for bit and gives the
same bits twice, and the bound: the bytes the call needs at 3.35 TB/s
(K10: the match bytes below the total, each asked flag's ids at the
matched slots and its flags written once; K19: each shard's hashes below
its row count read once and the histogram written once). Beside them,
`launch floor`: an empty kernel built here with the library's nvcc flags
and called through ctypes as the wrappers call theirs, alone and after a
256-int32 `torch.empty` (what a K19 call allocates).

With --parent (a checkout of another commit, e.g. the parent unpacked with
`git archive` under `_data/`), each version runs in its own process in the
order parent, change, change, parent (--rounds times) on the same inputs;
`summary` gives each cell's median [min-max] over the runs. --cells K10
or K19 runs that kernel's cells alone. --explore
(this checkout only) splits every cell launch by launch under
`torch.profiler`. Prints one JSON object with the card's name and power
limit; also written to --out. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import os
import statistics
import subprocess
import sys
import tempfile

from bench_agg_compact import smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory rate
SHARD = 524_288                     # a Size512 shard at P = 8
# K10 cells: name: (shape, flags the join reads: (visited, probe flags), accumulate)
K10_CELLS = {
    "K10 Q13 (LEFT, out_cap 2^25)": ("q13", (True, False), False),
    "K10 Q13 out of core (accumulate, out_cap 2^24)": ("q13_chunk", (True, False), True),
    "K10 Size512 RIGHT": ("size512", (False, True), False),
    "K10 Size512 FULL": ("size512", (True, True), False),
    "K10 hot build keys (Size512 FULL, 30% on one row)": ("hot", (True, True), False),
}
# K19 cells: name: (rows of each shard, buckets the hashes fall in or None)
K19_CELLS = {
    "K19 one shard, uniform": ((SHARD,), None),
    "K19 one shard, 1 bucket": ((SHARD,), 1),
    "K19 one shard, 4 buckets": ((SHARD,), 4),
    "K19 8 shards, uniform": ((SHARD,) * 7 + (400_000,), None),
}
EMPTY_SRC = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int dfp_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def cuda_ms(fn) -> float:
    return smoke().cuda_ms(fn, reps=20)


def k10_inputs(torch, g, device, shape):
    """(match, build_id, probe_idx, total int32 0-dim, bcap, mcap,
    visited buffer or None) of a K10 cell; past the total the slots are
    False and 0, as K3 leaves them."""
    if shape.startswith("q13"):
        chunk = shape == "q13_chunk"
        n, bcap, mcap = (1 << 24, 1 << 21, 1 << 22) if chunk else (1 << 25, 1 << 21, 1 << 24)
        total = 4_140_000 if chunk else 14_800_000
        kept = torch.nonzero(torch.rand(mcap, generator=g, device=device) < 0.99).flatten()
        pidx = kept[:total].to(torch.int32)
        total = pidx.shape[0]
        bid = torch.randint(0, 1_500_000, (total,), generator=g, device=device,
                            dtype=torch.int32)
        hit = torch.ones(total, dtype=torch.bool, device=device)
    else:
        m = bcap = mcap = 1 << 22
        n = 6_291_456
        counts = torch.poisson(torch.full((m,), 1.2465, device=device), generator=g).long()
        counts = torch.minimum(counts, torch.full_like(counts, 8))
        pidx = torch.repeat_interleave(torch.arange(m, device=device, dtype=torch.int32),
                                       counts)[:n]
        total = pidx.shape[0]
        bid = torch.randint(0, bcap, (total,), generator=g, device=device, dtype=torch.int32)
        hit = torch.rand(total, generator=g, device=device) < 0.8015
        if shape == "hot":
            bid = torch.where(torch.rand(total, generator=g, device=device) < 0.3, 12345, bid)
    match = torch.zeros(n, dtype=torch.bool, device=device)
    build_id = torch.zeros(n, dtype=torch.int32, device=device)
    probe_idx = torch.zeros(n, dtype=torch.int32, device=device)
    match[:total], build_id[:total], probe_idx[:total] = hit, bid, pidx
    visited = None
    if shape == "q13_chunk":
        visited = torch.rand(bcap, generator=g, device=device) < 0.5
    return (match, build_id, probe_idx, torch.tensor(total, dtype=torch.int32, device=device),
            bcap, mcap, visited)


def k10_bound_bytes(match, build_id, probe_idx, total, bcap, mcap, visited, want) -> int:
    """The match bytes below the total, each asked flag's ids at the
    matched slots, each asked flag written once (`chip_smoke.py::work`)."""
    k = min(int(total), match.shape[0])
    hits = int(match[:k].sum())
    return k + want[0] * (4 * hits + bcap) + want[1] * (4 * hits + mcap)


def k19_inputs(torch, g, device, rows, buckets):
    """(hashes per shard int32[SHARD], num_rows per shard int32 0-dim)."""
    hashes, num_rows = [], []
    for r in rows:
        h = torch.randint(-2**31, 2**31, (SHARD,), generator=g, device=device,
                          dtype=torch.int64)
        if buckets is not None:
            pick = torch.randint(0, buckets, (SHARD,), generator=g, device=device) * 37 + 5
            h = (pick << 24) | (h & 0xFFFFFF)
            h = torch.where(h >= 2**31, h - 2**32, h)
        hashes.append(h.to(torch.int32))
        num_rows.append(torch.tensor(r, dtype=torch.int32, device=device))
    return hashes, num_rows


def equal(torch, a, b) -> bool:
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b, strict=True))


def k10_calls(k10, args, want):
    """(kernel call, plain call) of this checkout's K10 or a parent's; each
    call gets a fresh copy of the visited buffer it accumulates into."""
    match, build_id, probe_idx, total, bcap, mcap, visited = args
    new = "total" in inspect.signature(k10.match_flags).parameters

    def run(fn):
        def call():
            vis = visited.clone() if visited is not None else None
            if new:
                return fn(match, build_id, probe_idx, bcap if want[0] else None,
                          mcap if want[1] else None, vis, total)
            return fn(match, build_id, probe_idx, bcap, mcap, vis)
        return call
    return run(k10.match_flags), run(k10.match_flags_plain)


def k19_calls(torch, k19, hashes, num_rows):
    """(kernel call, plain call): this checkout's one launch over the
    shards, or a parent's row mask and launch a shard."""
    if "num_rows" in inspect.signature(k19.key_histogram).parameters:
        return (lambda: k19.key_histogram(hashes, num_rows),
                lambda: k19.key_histogram_plain(hashes, num_rows))

    def per_shard(fn):
        def call():
            return [fn(h, torch.arange(h.shape[0], dtype=torch.int32, device=h.device) < n)
                    for h, n in zip(hashes, num_rows)]
        return call
    return per_shard(k19.key_histogram), per_shard(k19.key_histogram_plain)


def timed_cell(torch, kernel, plain, nbytes, shape, explore) -> dict:
    got, again, want = kernel(), kernel(), plain()
    out = {"shape": shape, "equal_plain": equal(torch, got, want),
           "same_bits_twice": equal(torch, got, again), "ms": cuda_ms(kernel),
           "bound_bytes": nbytes}
    if explore:
        from profile_csr_call import launch_split
        out["launches"] = launch_split(torch, lambda: kernel(), ())
    return out


def launch_floor(torch, _build, device) -> dict:
    """ms of an empty kernel through ctypes, alone and after a 256-int32
    torch.empty, timed as the cells are."""
    with tempfile.TemporaryDirectory() as tmp:
        src, lib = os.path.join(tmp, "empty.cu"), os.path.join(tmp, "libempty.so")
        with open(src, "w") as f:
            f.write(EMPTY_SRC)
        subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-o", lib, src],
                       check=True, capture_output=True)
        fn = ctypes.CDLL(lib).dfp_empty
    fn.argtypes, fn.restype = (_build.P,), ctypes.c_int

    def empty():
        _build.check(fn(_build.stream(device)), "empty")

    def with_alloc():
        torch.empty(256, dtype=torch.int32, device=device)
        empty()
    return {"empty kernel": cuda_ms(empty), "torch.empty + empty kernel": cuda_ms(with_alloc)}


def child(root: str, seed: int, explore: bool, only: str = None) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))
    import torch

    from datafusion_parallelism_tpu_torch.kernels import _build
    from datafusion_parallelism_tpu_torch.kernels import key_histogram as k19
    from datafusion_parallelism_tpu_torch.kernels import match_flags as k10
    _build.build()
    device = torch.device("cuda", 0)
    cells = {}
    for i, (name, (shape, want, _)) in enumerate(K10_CELLS.items()):
        if only not in (None, "K10"):
            break
        g = torch.Generator(device=device).manual_seed(seed * 1000 + i)
        args = k10_inputs(torch, g, device, shape)
        kernel, plain = k10_calls(k10, args, want)
        match, _, _, total, bcap, mcap, visited = args
        desc = {"n": match.shape[0], "total": int(total), "matches": int(match.sum()),
                "bcap": bcap, "mcap": mcap, "flags": list(want),
                "accumulate": visited is not None}
        cells[name] = timed_cell(torch, kernel, plain, k10_bound_bytes(*args, want), desc,
                                 explore)
        del args, kernel, plain
        torch.cuda.empty_cache()
    for i, (name, (rows, buckets)) in enumerate(K19_CELLS.items()):
        if only not in (None, "K19"):
            break
        g = torch.Generator(device=device).manual_seed(seed * 1000 + 100 + i)
        hashes, num_rows = k19_inputs(torch, g, device, rows, buckets)
        kernel, plain = k19_calls(torch, k19, hashes, num_rows)
        desc = {"shards": len(rows), "rows": list(rows), "buckets": buckets}
        cells[name] = timed_cell(torch, kernel, plain, 4 * sum(rows) + 1024 * len(rows),
                                 desc, explore)
    return {"root": os.path.abspath(root), "cells": cells,
            "launch_floor": launch_floor(torch, _build, device)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None, help="another checkout, run in turn with this one")
    ap.add_argument("--root", default=None, help=argparse.SUPPRESS)   # one process's version
    ap.add_argument("--seed", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=1, help="turns of the four-run order")
    ap.add_argument("--cells", default=None, choices=("K10", "K19"),
                    help="one kernel's cells alone")
    ap.add_argument("--explore", action="store_true",
                    help="also split every cell launch by launch (this checkout)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.root is not None:
        print(json.dumps(child(args.root, args.seed, args.explore, args.cells)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("bench_flags_hist: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    order = ([("parent", args.parent), ("change", REPO), ("change", REPO),
              ("parent", args.parent)] if args.parent else [("change", REPO)]) * args.rounds
    runs = []
    for label, root in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--root", root, "--seed", str(args.seed)]
        if args.cells:
            cmd += ["--cells", args.cells]
        if args.explore and label == "change":
            cmd.append("--explore")
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append({"label": label, **json.loads(proc.stdout.strip().splitlines()[-1])})
    spread = {}
    for r in runs:
        for name, c in list(r["cells"].items()) + [(k, {"ms": v})
                                                   for k, v in r["launch_floor"].items()]:
            if "bound_bytes" in c:
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
