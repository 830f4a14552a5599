#!/usr/bin/env python3
"""K14 sorted_probe, K15 oa_place and K16 oa_probe, the SORT and OA
strategies' own kernels, timed at their SQL shapes on one NVIDIA GPU.

    python3 tools/bench_strategies.py [--parent DIR] [--rounds N] [--explore]
                                      [--cells PREFIX] [--out FILE]

Cells (seeded data made on the card with torch alone, so every checkout
gets the same inputs):
  - K14 at Q7's shape: a SORT table of 15,000,000 valid keys (random
    hashes) at capacity 2^25, the rest of the capacity the 2^33 key of
    null keys and padding; 67,108,864 probe rows, each build key's hash
    repeated 1-7 times in build order (lineitem's rows follow their
    orders), 18,475,075 of them ok at random, the rows past them padding
    (one hash, not ok);
  - K14 at Size512: 4,194,304 build and probe rows, hashes drawn from
    4,194,304 values (the repeats of uniform int32 keys), all ok;
  - K14 with a hot key: 2^24 build rows, half of them one hash; 2^24
    probe rows from the build's hashes, 16 of them on the hot hash;
  - K14 over a sparse build: 10% of 2^25 valid; 2^26 probe rows, half of
    them ok, half the ok ones on a build hash;
  - K15 at Q7's shape: 15,000,000 valid rows (random hashes) at capacity
    2^25, T = 2^27, S = 167,772,160;
  - K15 at Size512: 4,194,304 rows, all valid, hashes as K14's;
  - K15 with phase 2c's one-home cluster (`chip_smoke.py::_strategy_hashes`
    at capacity 2^22: repeats, 6,000 rows on one home slot, 10% null keys,
    the last eighth padding);
  - K15 over a sparse build: 10% of 2^25 valid, at random;
  - K16 at Q7's shape: K15's Q7 table (15,000,000 valid rows at random
    places in capacity 2^25, T = 2^27, S = 167,772,160) probed by
    67,108,864 rows laid out as K14's Q7 probe (each valid build row's
    hash 1-7 times in build order, 18,475,075 of them ok, every ok row a
    hit);
  - K16 at Size512: 4,194,304 build rows (repeats), 4,194,304 probe rows
    from their hashes, all ok;
  - K16 with phase 2c's one-home cluster (`_strategy_hashes` at capacity
    2^22) probed by 2^22 rows, 70% from the build's valid hashes, 95% ok;
  - K16 over a sparse build: 10% of 2^25 valid, 2^26 probe rows, half of
    them ok, half the ok ones on a build hash.
K15's `order` is `torch.argsort(stable=True)` of the (invalid, home, hash)
key, the order K6 gives it in the build; K16's tables are placed by the
checkout's own K15. Per cell: the kernel's ms (CUDA events around the
wrapper, median of 20 after a warm-up), whether it equals its plain
version bit for bit and gives the same bits twice, the bound
(`chip_smoke.py::work`: bytes at 3.35 TB/s) and, for K14, the library call
of the kernel table (`torch.searchsorted` twice). A checkout whose K14
keeps a bucket directory reports its bits and keys a bucket. A checkout
whose K16 still takes the probe's home slots (the parent of the one-pass
K16) gets them made before the timing, and K16's bound is also given as
counted with that array read (`bound_with_home_bytes`).

With --parent (a checkout of another commit, e.g. the parent unpacked with
`git archive` under `_data/`), each version runs in its own process in the
order parent, change, change, parent (--rounds times) on the same inputs;
`summary` gives each cell's median [min-max] over the runs. --explore
(this checkout only) splits every cell launch by launch under
`torch.profiler`, and times K14 with the directory at 16, 4, 2 and 1
capacity keys a bucket beside the shipped choice. --cells runs only the
cells whose names start with PREFIX. Prints one JSON object
with the card's name and power limit; also written to --out. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys

from bench_agg_compact import smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory rate
SIZE512 = 4_194_304
INVALID_KEY = 1 << 33               # the SORT table's key of null keys and padding
M32 = 0xFFFFFFFF
# name: (cap, valid build rows, hot share, probe m, ok rows, hits among the
# ok rows, layout: "runs" of 1-7 rows a build key in build order, else random)
K14_CELLS = {
    "K14 Q7": (1 << 25, 15_000_000, 0.0, 1 << 26, 18_475_075, 1.0, "runs"),
    "K14 Size512": (SIZE512, SIZE512, 0.0, SIZE512, SIZE512, 1.0, "pool"),
    "K14 hot key (half the build one hash)": (1 << 24, 1 << 24, 0.5, 1 << 24, 1 << 24, 1.0,
                                              "hot"),
    "K14 sparse build (10% valid)": (1 << 25, 3_355_443, 0.0, 1 << 26, 1 << 25, 0.5, "random"),
}
# name: (cap, valid rows, hashes: "random", "pool" (repeats) or "cluster")
K15_CELLS = {
    "K15 Q7": (1 << 25, 15_000_000, "random"),
    "K15 Size512": (SIZE512, SIZE512, "pool"),
    "K15 one-home cluster (phase 2c's, 2^22)": (1 << 22, None, "cluster"),
    "K15 sparse build (10% valid)": (1 << 25, 3_355_443, "random"),
}
# name: (cap, valid build rows, hashes as K15_CELLS, probe m, ok rows, hits
# among the ok rows, layout as K14_CELLS)
K16_CELLS = {
    "K16 Q7": (1 << 25, 15_000_000, "random", 1 << 26, 18_475_075, 1.0, "runs"),
    "K16 Size512": (SIZE512, SIZE512, "pool", SIZE512, SIZE512, 1.0, "pool"),
    "K16 one-home cluster (phase 2c's, 2^22)": (1 << 22, None, "cluster", 1 << 22,
                                                3_984_588, 0.7, "pool"),
    "K16 sparse build (10% valid)": (1 << 25, 3_355_443, "random", 1 << 26, 1 << 25, 0.5,
                                     "pool"),
}
HOT_PROBES = 16
EXPLORE_KEYS = (16, 4, 2, 1)        # capacity keys a directory bucket, beside the shipped one


def cuda_ms(fn) -> float:
    return smoke().cuda_ms(fn, reps=20)


def equal(torch, a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


def random_hashes(torch, g, device, n: int) -> "torch.Tensor":
    return torch.randint(-2**31, 2**31, (n,), generator=g, device=device,
                         dtype=torch.int64).to(torch.int32)


def k14_inputs(torch, g, device, cap, valid, hot, m, ok_rows, hits, layout):
    """(hashes, ok, sorted_hash): the probe's hashes and ok mask, and the
    SORT table's sorted int64 keys (hash as unsigned, 2^33 past `valid`)."""
    pool = random_hashes(torch, g, device, cap)
    if layout in ("pool", "hot"):     # repeats: `cap` draws from `cap` values
        hb = pool[torch.randint(0, cap, (cap,), generator=g, device=device)]
    else:
        hb = pool
    if hot:
        hb[torch.rand(cap, generator=g, device=device) < hot] = 0x1234567
    key = torch.where(torch.arange(cap, device=device) < valid, hb.long() & M32, INVALID_KEY)
    sorted_hash = torch.sort(key).values
    hv = hb[:valid]
    if layout == "runs":
        lengths = torch.randint(1, 8, (valid,), generator=g, device=device)
        pick = torch.repeat_interleave(torch.arange(valid, device=device), lengths)[:m]
        real = pick.shape[0]
        ph = torch.full((m,), 12_345, dtype=torch.int32, device=device)
        ph[:real] = hv[pick]
        ok = torch.zeros(m, dtype=torch.bool, device=device)
        ok[torch.randperm(real, generator=g, device=device)[:ok_rows]] = True
        return ph, ok, sorted_hash
    ph = hv[torch.randint(0, valid, (m,), generator=g, device=device)]
    if layout == "hot":              # the hot hash only on HOT_PROBES rows
        ph = torch.where(ph == 0x1234567, ph + 1, ph)
        ph[torch.randperm(m, generator=g, device=device)[:HOT_PROBES]] = 0x1234567
    miss = torch.rand(m, generator=g, device=device) >= hits
    ph = torch.where(miss, random_hashes(torch, g, device, m), ph)
    ok = torch.zeros(m, dtype=torch.bool, device=device)
    ok[torch.randperm(m, generator=g, device=device)[:ok_rows]] = True
    return ph, ok, sorted_hash


def k15_inputs(torch, g, device, cap, valid, hashes):
    """(order, home, hashes, ok, S) of an OA build: `order` the stable sort
    by (invalid, home, hash)."""
    import numpy as np

    from datafusion_parallelism_tpu_torch.ops.hash_table import (oa_slots_for, slot_of,
                                                                 table_size_for)
    T = table_size_for(cap)
    if hashes == "cluster":
        seed = int(torch.randint(0, 2**31, (1,), generator=g, device=device))
        h, ok, _ = smoke()._strategy_hashes(np.random.default_rng(seed), cap, T, device)
    else:
        pool = random_hashes(torch, g, device, cap)
        h = pool if hashes == "random" else pool[torch.randint(0, cap, (cap,), generator=g,
                                                               device=device)]
        ok = torch.zeros(cap, dtype=torch.bool, device=device)
        ok[torch.randperm(cap, generator=g, device=device)[:valid]] = True
    home = slot_of(h, T)
    key = torch.where(ok, (home.long() << 32) | (h.long() & M32), 1 << 62)
    order = torch.argsort(key, stable=True).to(torch.int32)
    return order, home, h, ok, oa_slots_for(T)


def k16_inputs(torch, g, device, k15, cap, valid, hashes, m, ok_rows, hits, layout):
    """(hashes, ok, slots): probe rows against an OA table placed by the
    checkout's K15 (`k15_inputs`' build), the probe laid out as K14's
    cells lay theirs out over the table's valid rows."""
    build = k15_inputs(torch, g, device, cap, valid, hashes)
    slots, _ = k15.oa_place(*build)
    _, _, h, bok, _ = build
    hv = h[bok]
    n = hv.shape[0]
    if layout == "runs":
        lengths = torch.randint(1, 8, (n,), generator=g, device=device)
        pick = torch.repeat_interleave(torch.arange(n, device=device), lengths)[:m]
        real = pick.shape[0]
        ph = torch.full((m,), 12_345, dtype=torch.int32, device=device)
        ph[:real] = hv[pick]
        ok = torch.zeros(m, dtype=torch.bool, device=device)
        ok[torch.randperm(real, generator=g, device=device)[:ok_rows]] = True
        return ph, ok, slots
    ph = hv[torch.randint(0, n, (m,), generator=g, device=device)]
    miss = torch.rand(m, generator=g, device=device) >= hits
    ph = torch.where(miss, random_hashes(torch, g, device, m), ph)
    ok = torch.zeros(m, dtype=torch.bool, device=device)
    ok[torch.randperm(m, generator=g, device=device)[:ok_rows]] = True
    return ph, ok, slots


def k16_call(k16, args):
    """A call of the checkout's K16 on (hashes, ok, slots): the parent's
    K16 takes the probe's home slots first, made here before any timing."""
    from datafusion_parallelism_tpu_torch.ops.hash_table import slot_of
    hashes, ok, slots = args
    if "home" in inspect.signature(k16.oa_probe).parameters:
        home = slot_of(hashes, 4 * slots.shape[0] // 5)
        return (lambda: k16.oa_probe(home, *args)), (lambda: k16.oa_probe_plain(home, *args))
    return (lambda: k16.oa_probe(*args)), (lambda: k16.oa_probe_plain(*args))


def k16_cell(torch, k16, args, explore: bool) -> dict:
    sm = smoke()
    kernel, plain = k16_call(k16, args)
    got = kernel()
    again = kernel()
    want = plain()
    hashes, ok, slots = args
    nbytes = sm.work(("join", "oa_probe"), args, got)[0]
    cell = {"shape": {"m": hashes.shape[0], "ok_rows": int(ok.sum()), "S": slots.shape[0],
                      "table_rows": int((slots != 0).sum()), "total": int(got[3]),
                      "longest_run": int(got[1].max())},
            "equal_plain": equal(torch, got, want), "same_bits_twice": equal(torch, got, again),
            "ms": cuda_ms(kernel), "bound_bytes": nbytes,
            "bound_with_home_bytes": nbytes + hashes.nbytes}
    if explore:
        from profile_csr_call import launch_split
        cell["launches"] = launch_split(torch, kernel, ())
    return cell


def k14_cell(torch, k14, args, explore: bool) -> dict:
    sm = smoke()
    got = k14.sorted_probe(*args)
    again = k14.sorted_probe(*args)
    want = k14.sorted_probe_plain(*args)
    hashes, ok, sorted_hash = args
    cap = sorted_hash.shape[0]
    shape = {"m": hashes.shape[0], "ok_rows": int(ok.sum()), "cap": cap,
             "valid_keys": int((sorted_hash < 2**32).sum()), "total": int(got[3])}
    if hasattr(k14, "directory_bits"):
        bits = k14.directory_bits(cap)
        shape.update(directory_bits=bits, capacity_keys_a_bucket=cap / 2**bits,
                     valid_keys_a_bucket=shape["valid_keys"] / 2**bits)
    cell = {"shape": shape, "equal_plain": equal(torch, got, want),
            "same_bits_twice": equal(torch, got, again),
            "ms": cuda_ms(lambda: k14.sorted_probe(*args)),
            "bound_bytes": sm.work(("join", "sorted_probe"), args, got)[0],
            "library_ms": cuda_ms(sm.library_call(("join", "sorted_probe"), args))}
    if explore:
        from profile_csr_call import launch_split
        cell["launches"] = launch_split(torch, k14.sorted_probe, args)
        if hasattr(k14, "directory_bits"):
            shipped = k14.directory_bits
            try:
                for keys in EXPLORE_KEYS:
                    bits = max(0, min(k14.MAX_DIRECTORY_BITS,
                                      (max(cap // keys, 1) - 1).bit_length()))
                    k14.directory_bits = lambda c, b=bits: b
                    cell[f"{keys} keys a bucket (bits {bits}) equal_plain"] = equal(
                        torch, k14.sorted_probe(*args), want)
                    cell[f"{keys} keys a bucket (bits {bits}) ms"] = cuda_ms(
                        lambda: k14.sorted_probe(*args))
            finally:
                k14.directory_bits = shipped
    return cell


def k15_cell(torch, k15, args, explore: bool) -> dict:
    sm = smoke()
    got = k15.oa_place(*args)
    again = k15.oa_place(*args)
    want = k15.oa_place_plain(*args)
    order, home, hashes, ok, S = args
    cell = {"shape": {"cap": order.shape[0], "n_valid": int(ok.sum()), "S": S,
                      "max_displacement": int(((torch.nonzero(want[0]).flatten()
                                                - home[want[1][want[0] != 0].long()])).max())
                      if int(ok.sum()) else 0},
            "equal_plain": equal(torch, got, want), "same_bits_twice": equal(torch, got, again),
            "ms": cuda_ms(lambda: k15.oa_place(*args)),
            "bound_bytes": sm.work(("join", "oa_place"), args, got)[0]}
    if explore:
        from profile_csr_call import launch_split
        cell["launches"] = launch_split(torch, k15.oa_place, args)
    return cell


def child(root: str, seed: int, explore: bool, cells_prefix: str = "") -> dict:
    sys.path.insert(0, os.path.abspath(root))
    sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))
    os.environ["DFP_NO_CAP_STORE"] = "1"
    import torch

    from datafusion_parallelism_tpu_torch.kernels import _build
    from datafusion_parallelism_tpu_torch.kernels import oa_place as k15
    from datafusion_parallelism_tpu_torch.kernels import oa_probe as k16
    from datafusion_parallelism_tpu_torch.kernels import sorted_probe as k14
    _build.build()
    device = torch.device("cuda", 0)
    cells = {}
    for table, make, run in ((K14_CELLS, k14_inputs, lambda a: k14_cell(torch, k14, a, explore)),
                             (K15_CELLS, k15_inputs, lambda a: k15_cell(torch, k15, a, explore)),
                             (K16_CELLS, lambda *a: k16_inputs(*a[:3], k15, *a[3:]),
                              lambda a: k16_cell(torch, k16, a, explore))):
        for name, spec in table.items():
            if not name.startswith(cells_prefix):
                continue
            # each cell's inputs from its own seed, so that --cells keeps them
            g = torch.Generator(device=device).manual_seed(seed * 1000 + list(table).index(name)
                                                           + 100 * (table is K16_CELLS))
            args = make(torch, g, device, *spec)
            cells[name] = run(args)
            del args
            torch.cuda.empty_cache()
    return {"root": os.path.abspath(root), "cells": cells}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None, help="another checkout, run in turn with this one")
    ap.add_argument("--root", default=None, help=argparse.SUPPRESS)   # one process's version
    ap.add_argument("--seed", type=int, default=14)
    ap.add_argument("--rounds", type=int, default=1, help="turns of the four-run order")
    ap.add_argument("--explore", action="store_true",
                    help="also split every cell launch by launch and time K14's directory "
                         "at other sizes (this checkout)")
    ap.add_argument("--cells", default="", help="only the cells whose names start so")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.root is not None:
        print(json.dumps(child(args.root, args.seed, args.explore, args.cells)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("bench_strategies: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    order = ([("parent", args.parent), ("change", REPO), ("change", REPO),
              ("parent", args.parent)] if args.parent else [("change", REPO)]) * args.rounds
    runs = []
    for label, root in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--root", root, "--seed", str(args.seed),
               "--cells", args.cells]
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
            for k in [k for k in c if k.endswith("_bytes") and k.startswith("bound")]:
                c[k[:-len("_bytes")] + "_ms"] = c[k] / HBM_BYTES_PER_S * 1e3
            cell = spread.setdefault(name, {}).setdefault(r["label"], {})
            for k, v in c.items():
                if k == "ms" or k.endswith("_ms") or k.endswith(" ms"):
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
