#!/usr/bin/env python3
"""K8 direct_agg and K5's compaction (filter_compact) timed at their SQL
shapes, on one NVIDIA GPU.

    python3 tools/bench_agg_compact.py [--parent DIR] [--rounds N] [--explore]
                                       [--calls FILE] [--out FILE]

Cells:
  - K8 at Q1's and Q6's SF10 calls and K5 at Q19's, captured from the
    first run of each query through SQL at SF10, as `chip_smoke.py` phase 15
    captures them (`tools/profile_agg_compact_call.py`; --calls reads a file
    that `--save` wrote, else they are captured first and kept in
    `_data/agg_compact_calls.pt`);
  - K8 over 2^26 rows in 64 groups (two keys of domains 7 and 7, 10% of
    their codes NULL) with the sum, min and max of two float64 columns
    (NaN, +-inf and -0.0 among the values, 5% NULL) and a count;
  - K5 over 2^26 rows of 8 words at 1%, 50% and 100% selectivity
    (out_cap = cap), and at 50% with out_cap 2^24 (half the survivors
    drop).
Per cell: the kernel's ms (CUDA events around the wrapper, median of 20
after a warm-up); whether it equals its plain version by `chip_smoke.py`'s
checks (K5 bit for bit; K8 `k8_close`: integers bit for bit, float64 sums
within rtol 1e-9 + 1e-12 sum|x|, min and max equal as numbers) and gives
the same bits twice; the bound (the bytes of its inputs and outputs, a
view's bytes once, at 3.35 TB/s) and chip_smoke's yardstick: for K5
`words[:, mask]` and `f64[:, mask]` (a boolean index: the host reads the
count inside the timing; no zero tail), for K8 a partial one, an
`index_add_` or `scatter_reduce_` a request over group ids made before
the timing. The checks and yardsticks are this checkout's in both turns.

With --parent (a checkout of another commit, e.g. the parent unpacked with
`git archive` under `_data/`), each version runs in its own process in the
order parent, change, change, parent (--rounds times) on the same inputs;
`summary` gives each cell's median [min-max] over the runs. --explore
(this checkout only) also gives each K8 cell's launch plan and splits the
K8 Q1 and Q6 and K5 Q19 calls launch by launch under `torch.profiler`. Prints one JSON
object with the card's name and power limit; also written to --out.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory rate
BIG = 1 << 26
# name: (selectivity, words, out_cap as a share of the rows)
K5_CELLS = {"K5 1% of 2^26 x 8 words": (0.01, 8, 1.0),
            "K5 50% of 2^26 x 8 words": (0.5, 8, 1.0),
            "K5 100% of 2^26 x 8 words": (1.0, 8, 1.0),
            "K5 50%, out_cap 2^24 (survivors drop)": (0.5, 8, 0.25)}


def smoke():
    """This checkout's chip_smoke.py, by its path (a parent run imports the
    parent's package, but the checks and yardsticks stay these)."""
    if "bench_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location("bench_smoke",
                                                      os.path.join(REPO, "chip_smoke.py"))
        module = importlib.util.module_from_spec(spec)
        sys.modules["bench_smoke"] = module
        spec.loader.exec_module(module)
    return sys.modules["bench_smoke"]


def cuda_ms(fn) -> float:
    return smoke().cuda_ms(fn, reps=20)


def agrees(check, *args) -> bool:
    """Whether chip_smoke's check passes (it raises where not)."""
    try:
        check(*args)
        return True
    except AssertionError:
        return False


def k8_cell(torch, args, explore: bool) -> dict:
    from datafusion_parallelism_tpu_torch.kernels import direct_agg as k8
    sm = smoke()
    keys, doms, num_rows, row_filter, reqs, cap = args
    got = k8.direct_agg(*args)
    again = k8.direct_agg(*args)
    want = k8.direct_agg_plain(*args)
    cell = {"shape": {"cap": cap, "num_rows": int(num_rows), "G": k8.n_groups_of(doms),
                      "R": len(reqs) + 1, "ops": [f"{f} {str(v.dtype)[6:]}" for f, v, _ in reqs]},
            "equal_plain": agrees(sm.k8_close, got, want, reqs),
            "same_bits_twice": agrees(sm.max_abs_err, got, again),
            "ms": cuda_ms(lambda: k8.direct_agg(*args)),
            "bound_bytes": sm._bytes([args, got]),
            "library_ms": cuda_ms(sm.partial_call(("chain", "direct_agg"), args))}
    if explore:
        cell["plan (T, smem, blocks, per SM; warps' sets)"] = k8.launch_plans(*args)
    return cell


def k5_cell(torch, args) -> dict:
    from datafusion_parallelism_tpu_torch.kernels import filter_compact as k5
    sm = smoke()
    mask, words, f64, out_cap = args
    got = k5.filter_compact(*args)
    cell = {"shape": {"cap": mask.shape[0], "W": words.shape[0], "F": f64.shape[0],
                      "out_cap": out_cap, "survivors": int(got[2])},
            "equal_plain": agrees(sm.max_abs_err, got, k5.filter_compact_plain(*args)),
            "same_bits_twice": agrees(sm.max_abs_err, got, k5.filter_compact(*args)),
            "ms": cuda_ms(lambda: k5.filter_compact(*args)),
            "library_ms": cuda_ms(sm.library_call(("chain", "filter_compact"), args))}
    # the mask, each kept survivor's row read and written, the tail written
    k = min(int(got[2]), out_cap)
    row = 4 * words.shape[0] + 8 * f64.shape[0]
    cell["bound_bytes"] = mask.nbytes + k * row + out_cap * row + 8
    return cell


def synthetic_k8(torch, g, device):
    """2^26 rows in 64 groups: two int32 keys of domain 7 (10% NULL), the
    sum, min and max of two float64 columns (NaN, +-inf, -0.0 among them,
    5% NULL) and a count; every row in the table, no filter."""
    keys = []
    for _ in range(2):
        codes = torch.randint(0, 7, (BIG,), generator=g, device=device, dtype=torch.int32)
        keys.append((codes, torch.rand(BIG, generator=g, device=device) >= 0.1))
    reqs = []
    for _ in range(2):
        x = torch.randn(BIG, generator=g, device=device, dtype=torch.float64) * 1e3
        special = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0],
                               dtype=torch.float64, device=device)
        pick = torch.randint(0, 4, (BIG,), generator=g, device=device)
        x = torch.where(torch.rand(BIG, generator=g, device=device) < 1e-6, special[pick], x)
        valid = torch.rand(BIG, generator=g, device=device) >= 0.05
        reqs += [("sum", x, valid), ("min", x, valid), ("max", x, valid)]
    reqs.append(("count", reqs[0][1], reqs[0][2]))
    return (keys, [7, 7], torch.tensor(BIG, dtype=torch.int32, device=device), None, reqs,
            BIG)


def synthetic_k5(torch, g, device, share, W, out_cap):
    mask = torch.rand(BIG, generator=g, device=device) < share
    words = torch.randint(-2**31, 2**31, (W, BIG), generator=g, device=device,
                          dtype=torch.int64).to(torch.int32)
    return mask, words, torch.empty((0, BIG), dtype=torch.float64, device=device), out_cap


def run_cells(torch, captured: dict, g, device, explore: bool) -> dict:
    """Every cell: the captured calls, then the synthetic ones made from
    `g` on `device`."""
    cells = {}
    for label, args in captured.items():
        cells[label] = (k8_cell(torch, args, explore) if label.startswith("K8")
                        else k5_cell(torch, args))
    cells["K8 64 groups, float64 sums/min/max over 2^26"] = k8_cell(
        torch, synthetic_k8(torch, g, device), explore)
    for name, (share, W, out_share) in K5_CELLS.items():
        cells[name] = k5_cell(torch, synthetic_k5(torch, g, device, share, W,
                                                  int(BIG * out_share)))
    return cells


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
    res = {"root": os.path.abspath(root),
           "cells": run_cells(torch, captured, g, device, explore)}
    if explore:
        from profile_csr_call import launch_split

        from datafusion_parallelism_tpu_torch.kernels import direct_agg as k8
        from datafusion_parallelism_tpu_torch.kernels import filter_compact as k5
        res["splits"] = {"K8 Q1": launch_split(torch, k8.direct_agg, captured["K8 Q1"]),
                         "K8 Q6": launch_split(torch, k8.direct_agg, captured["K8 Q6"]),
                         "K5 compaction Q19": launch_split(torch, k5.filter_compact,
                                                           captured["K5 compaction Q19"])}
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None, help="another checkout, run in turn with this one")
    ap.add_argument("--root", default=None, help=argparse.SUPPRESS)   # one process's version
    ap.add_argument("--calls", default=None, help="captured calls (profile_agg_compact_call.py --save)")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--rounds", type=int, default=1, help="turns of the four-run order")
    ap.add_argument("--explore", action="store_true",
                    help="also give K8's plans and split Q1, Q6 and Q19 by launch (this checkout)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.root is not None:
        print(json.dumps(child(args.root, args.calls, args.seed, args.explore)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("bench_agg_compact: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    calls = args.calls
    if calls is None:
        calls = os.path.join(REPO, "_data", "agg_compact_calls.pt")
        os.makedirs(os.path.dirname(calls), exist_ok=True)
        cmd = [sys.executable, os.path.join(REPO, "tools", "profile_agg_compact_call.py"),
               "--save", calls, "--no-profile"]
        proc = subprocess.run(cmd, capture_output=True, text=True)
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
            cell = spread.setdefault(name, {}).setdefault(r["label"], {})
            for k, v in c.items():
                if k.endswith(" ms") or k.endswith("_ms") or k == "ms":
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
