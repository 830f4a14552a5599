#!/usr/bin/env python3
"""K2 csr_build and K3 probe_expand timed at their SQL shapes, on one NVIDIA GPU.

    python3 tools/bench_csr_join.py [--parent DIR] [--rounds N] [--explore] [--out FILE]

Cells (seeded data made on the card; the shapes of `tools/profile_csr_call.py`
at the SQL calls phase 15 replays):
  - K2 at Size512 (n 4,194,304, T 4 n, R 2 narrow rows, uniform slots);
  - K2 at Q9 (n 33,554,432, T 134,217,728, R 3; 3,147,082 rows valid, the
    rest, a capacity-padded table's padding, in bucket T at the end);
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
    word);
  - K3 at a hot probe key: one probe row owning 4,194,304 candidates among
    4,194,304 probe rows.
Per cell: the kernel's ms (CUDA events around the wrapper, median of 20
after a warm-up), whether it equals its plain version bit for bit, the
bound (bytes the call must move at 3.35 TB/s, a view's bytes once) and
partial yardsticks, not the same function: `torch.argsort(slot,
stable=True)` for K2's perm alone; two `index_select`s of the offsets and
`torch.cumsum` for K3's pass 1.

With --parent (a checkout of another commit, e.g. the parent unpacked with
`git archive` under `_data/`), each version runs in its own process in the
order parent, change, change, parent (--rounds times), so both are
compared on one card in one call; `summary` gives each cell's median
[min-max] over the runs. --explore (this checkout only) also times K2
without its narrow rows (R 0: what its row gather costs) and K2 at R 0
followed by K5's gather of the rows, and splits K2 at Q9 and K3 at Q7
launch by launch under `torch.profiler`. Prints one JSON object with the card's name and power
limit; also written to --out. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory rate
SIZE512 = 4_194_304

# name: (n, T, R, valid rows, where the valid rows are, hot share)
K2_CELLS = {
    "K2 Size512": (SIZE512, 4 * SIZE512, 2, SIZE512, "all", 0.0),
    "K2 Q9": (1 << 25, 1 << 27, 3, 3_147_082, "head", 0.0),
    "K2 sparse (10% valid)": (1 << 25, 1 << 27, 1, 3_355_443, "random", 0.0),
    "K2 hot key (half the rows)": (1 << 24, 1 << 26, 2, 1 << 24, "all", 0.5),
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
    for name, (n, T, R, valid, where, hot) in K2_CELLS.items():
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


def k3_inputs(torch, g, device, n, T, valid, m, ok_rows, hot, layout):
    """The build's table (K2 over seeded slots, with one key word and its
    validity word as narrow rows) and the probe's slots, ok mask and words.
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
    return offsets, start_count, bwords, pslot, ok, pwords


def k3_cells(torch, g, device):
    from datafusion_parallelism_tpu_torch.kernels import probe_expand as k3
    out = {}
    by_offsets = "offsets" in inspect.signature(k3.probe_ranges).parameters
    compares = [([0], [0], (1, 0), (1, 0))]
    for name, (n, T, valid, m, ok_rows, out_cap, hot, layout) in K3_CELLS.items():
        offsets, start_count, bwords, pslot, ok, pwords = k3_inputs(
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
        out[name] = cell
        del offsets, start_count, bwords, pslot, ok, pwords, got, want, got_x, want_x
        torch.cuda.empty_cache()
    return out


def splits(torch, g, device):
    """--explore: K2 at Q9 and K3 at Q7, launch by launch."""
    from profile_csr_call import launch_split

    from datafusion_parallelism_tpu_torch.kernels import csr_build as k2
    from datafusion_parallelism_tpu_torch.kernels import probe_expand as k3
    out = {}
    slot, rows = k2_inputs(torch, g, device, *K2_CELLS["K2 Q9"])
    out["K2 Q9"] = launch_split(torch, k2.csr_build, (slot, K2_CELLS["K2 Q9"][1], rows))
    del slot, rows
    n, T, valid, m, ok_rows, out_cap, hot, layout = K3_CELLS["K3 Q7"]
    offsets, _, bwords, pslot, ok, pwords = k3_inputs(torch, g, device, n, T, valid, m,
                                                      ok_rows, hot, layout)
    got = k3.probe_ranges(pslot, ok, offsets)
    out["K3 Q7 probe_ranges"] = launch_split(torch, k3.probe_ranges, (pslot, ok, offsets))
    out["K3 Q7 expand_ranges"] = launch_split(
        torch, k3.expand_ranges, (*got, pwords, bwords, [([0], [0], (1, 0), (1, 0))], out_cap))
    torch.cuda.empty_cache()
    return out


def child(root: str, seed: int, explore: bool) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))
    os.environ["DFP_NO_CAP_STORE"] = "1"
    import torch
    from datafusion_parallelism_tpu_torch.kernels import _build
    _build.build()
    device = torch.device("cuda", 0)
    g = torch.Generator(device=device).manual_seed(seed)
    cells = {**k2_cells(torch, g, device, explore), **k3_cells(torch, g, device)}
    res = {"root": os.path.abspath(root), "cells": cells}
    if explore:
        res["splits"] = splits(torch, g, device)
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None, help="another checkout, run in turn with this one")
    ap.add_argument("--root", default=None, help=argparse.SUPPRESS)   # one process's version
    ap.add_argument("--seed", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=1, help="turns of the four-run order")
    ap.add_argument("--explore", action="store_true",
                    help="also time K2's row gathers, and split the "
                         "Q9 and Q7 calls (this checkout)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.root is not None:
        print(json.dumps(child(args.root, args.seed, args.explore)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("bench_csr_join: no CUDA device", file=sys.stderr)
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
             if "equal" in k)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
