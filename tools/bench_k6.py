#!/usr/bin/env python3
"""K6 radix_sort timed at the shapes of its largest SQL calls, on one NVIDIA GPU.

    python3 tools/bench_k6.py [--root DIR] [--label NAME] [--out FILE]

Imports `datafusion_parallelism_tpu_torch` from --root (the repo by
default; a checkout of another commit to compare two versions in one
call: parent, change, change, parent), builds its kernels and sorts
seeded key words made on the card, shaped as the calls `chip_smoke.py`
phase 15 replays: the SORT build's (invalid, hash) and the OA build's
(invalid, home, hash) at a 2^25-row build, a grouping's (biased hash,
high word, low word, validity word) over SF10 lineitem, ORDER BYs on
one and on two int64 columns, and a wide grouping (Q18's: 8 words, 144 varying
bits) over a 2^25-row capacity that holds few rows. Per cell: K6 ms
(CUDA events, median of 5), whether its permutation equals
`radix_sort_plain`'s bit for bit, and the ms of
`torch.argsort(stable=True)` of an int64 key that orders the rows the
same way (their varying bits packed, before the timing; cells past 63
varying bits have none). Prints one JSON object, also written to
--out. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_ROWS = 1 << 25              # the SORT/OA builds of phase 17's Q7
LINEITEM_ROWS = 59_986_052        # SF10 lineitem


def cells(torch, device, seed: int):
    """{name: (words [k, n] int32 on the card, signed flags)}."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(n, lo, hi):
        return torch.randint(lo, hi, (n,), generator=g, device=device, dtype=torch.int64)

    def i32(v):
        return v.to(torch.int32)

    def padded(cols, valid):
        """int32 words from int64 values, the rows from `valid` on zero
        (a capacity-padded table's rows past its count)."""
        words = torch.stack([i32(c) for c in cols])
        words[:, valid:] = 0
        return words

    n = BUILD_ROWS
    hashes = i32(rand(n, -2**31, 2**31))
    invalid = i32(rand(n, 0, 100) == 0)      # 1% of the rows past the table's count
    home = i32(rand(n, 0, 1 << 25))
    m = LINEITEM_ROWS
    orderkey = rand(m, 1, 60_000_000 * 4)
    int64 = rand(m, -2**40, 2**40)
    other = rand(m, -2**40, 2**40)
    return {
        "SORT build (invalid, hash)": (torch.stack([invalid, hashes]), [False, False]),
        "OA build (invalid, home, hash)": (torch.stack([invalid, home, hashes]),
                                           [False, False, False]),
        "Q18 grouping (hash, orderkey hi, lo, validity)": (
            torch.stack([i32(rand(m, -2**31, 2**31)), i32(orderkey >> 32),
                         i32(orderkey & 0xFFFFFFFF), torch.full((m,), 3, dtype=torch.int32,
                                                                device=device)]),
            [True, True, True, True]),
        "ORDER BY int64 (hi, lo)": (torch.stack([i32(int64 >> 32), i32(int64 & 0xFFFFFFFF)]),
                                    [True, False]),
        "ORDER BY two int64 columns (hi, lo, hi, lo)": (
            torch.stack([i32(int64 >> 32), i32(int64 & 0xFFFFFFFF), i32(other >> 32),
                         i32(other & 0xFFFFFFFF)]), [True, False, True, False]),
        "wide grouping (8 words, 144 bits; 4,096 rows valid, the rest padding)": (
            padded([rand(n, -2**31, 2**31), rand(n, 0, 1 << 21), rand(n, 0, 1 << 21),
                    rand(n, 0, 1 << 18), rand(n, 0, 1 << 12), rand(n, 0, 1 << 4),
                    rand(n, -2**31, 2**31), rand(n, 0, 1 << 4)], 4096),
            [True] * 8),
    }


def packed_key(torch, words, signed):
    """An int64 key that orders the rows as the words do (their varying
    bits, flipped where signed, packed most significant first), or None
    past 63 bits."""
    w = words.long() & 0xFFFFFFFF
    flips = torch.tensor([0x80000000 if s else 0 for s in signed], device=words.device)
    w = w ^ flips[:, None]
    key = torch.zeros(words.shape[1], dtype=torch.int64, device=words.device)
    bits = 0
    for row in w:
        mask = int(torch.bitwise_xor(row.min(), row.max()).item())   # a superset, enough here
        width = mask.bit_length()
        low = row & ((1 << width) - 1)
        if bits + width > 63:
            return None
        key = (key << width) | low
        bits += width
    return key


def cuda_ms(torch, fn, reps: int = 5) -> float:
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("bench_k6: no CUDA device", file=sys.stderr)
        return 1
    from datafusion_parallelism_tpu_torch.kernels import _build
    from datafusion_parallelism_tpu_torch.kernels import radix_sort as k6
    _build.build()
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    out = {"label": args.label, "root": os.path.abspath(args.root), "card": card, "cells": {}}
    for name, (words, signed) in cells(torch, device, args.seed).items():
        got = k6.radix_sort(words, signed)
        equal = bool(torch.equal(got, k6.radix_sort_plain(words, signed)))
        del got
        ms = cuda_ms(torch, lambda: k6.radix_sort(words, signed))
        key = packed_key(torch, words, signed)
        lib = None if key is None else cuda_ms(torch, lambda: torch.argsort(key, stable=True))
        out["cells"][name] = {"rows": words.shape[1], "words": words.shape[0], "ms": ms,
                              "equal_plain": equal, "argsort_ms": lib}
        del words, key
        torch.cuda.empty_cache()
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if all(c["equal_plain"] for c in out["cells"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
