#!/usr/bin/env python3
"""The CSR join's build (K2 csr_build) and probe (K3 probe_ranges,
expand_ranges) at their largest SQL calls and at Size512, split launch by
launch on one NVIDIA GPU.

    python3 tools/profile_csr_call.py [--root DIR] [--k2-query 9] [--k3-query 7] [--out FILE]

Imports `datafusion_parallelism_tpu_torch` and `chip_smoke.py` from --root
(this checkout by default; a checkout of another commit, e.g. the parent
unpacked with `git archive` under `_data/`, splits that version). Captures
the arguments of K2 and K3's calls in the Size512 INNER join (4,194,304 x
4,194,304 uniform int32 keys, `entry.make_tables`) and, at TPC-H SF10
(the port's copied generator, the first run of a query: the capacities
the planner seeds, as `chip_smoke.py` phase 15 replays them), the largest
`csr_build` call of --k2-query and the largest `probe_ranges` and
`expand_ranges` calls of --k3-query. Per call it prints its shape (K2: n,
T, R, the rows in bucket T; K3: m, T, total, out_cap, the key groups),
its time by CUDA events (median of 5) and each of its device activities
(kernels, copies, memsets) in launch order, the median over 3 calls under
`torch.profiler`. Prints one JSON object with the card's name and power
limit, also written to --out. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def launch_split(torch, fn, args, iters: int = 3):
    """[(device activity name, median us)] of one call of fn(*args), in
    launch order, from `iters` profiled calls."""
    fn(*args)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            with torch.profiler.record_function("call"):
                fn(*args)
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    calls = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation" and e["name"] == "call")
    per_call = [[] for _ in calls]
    for e in events:
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        if e.get("cat") not in DEVICE_CATS or ts is None:
            continue
        for k, (s, t) in enumerate(calls):
            if s <= ts <= t:
                per_call[k].append((ts, e["ts"], e["name"], e["dur"]))
    per_call = [sorted(c) for c in per_call]
    if len(calls) != iters or len({len(c) for c in per_call}) != 1 or not per_call[0]:
        raise RuntimeError(f"{len(calls)} profiled calls with {[len(c) for c in per_call]} "
                           "device activities")
    return [(per_call[0][i][2][:90], statistics.median(c[i][3] for c in per_call))
            for i in range(len(per_call[0]))]


def shape(torch, entry: str, args) -> dict:
    if entry == "csr_build":
        slot, T, rows = args[:3]
        return {"n": slot.shape[0], "T": T, "R": rows.shape[0], "bits_T": T.bit_length(),
                "row_major": bool(args[3]) if len(args) > 3 else False,
                "rows_in_bucket_T": int((slot == T).sum())}
    if entry == "probe_ranges":
        slot, ok, table = args
        T = table.shape[-1] - 1 if table.dim() == 2 else table.shape[0] - 2
        return {"m": slot.shape[0], "T": T, "ok_rows": int(ok.sum())}
    start, count, base, total, pwords, bwords, compares, out_cap = args
    return {"m": start.shape[0], "total": int(total), "out_cap": out_cap,
            "bwords": list(bwords.shape), "bwords_strides": list(bwords.stride()),
            "pwords": list(pwords.shape),
            "keys": len(compares), "key_words": sum(len(c[0]) for c in compares)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--k2-query", type=int, default=9)
    ap.add_argument("--k3-query", type=int, default=7)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    os.environ["DFP_NO_CAP_STORE"] = "1"
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_csr_call: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from datafusion_parallelism_tpu_torch import SessionContext
    from datafusion_parallelism_tpu_torch.entry import make_tables
    from datafusion_parallelism_tpu_torch.ops.join import KERNELS, inner_csr_join
    from datafusion_parallelism_tpu_torch.tpch import QUERIES, generate_tables
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    chip_smoke.phase_build()
    device = torch.device("cuda", 0)
    entries = ("csr_build", "probe_ranges", "expand_ranges")
    captured = {}

    rec = chip_smoke.LargestCalls(capture=True, keep=lambda key: key[1] in entries)
    rec.on = True
    build, probe = make_tables(np.random.default_rng(0), chip_smoke.SIZE512,
                               chip_smoke.SIZE512, chip_smoke.SIZE512, device=device)
    inner_csr_join(build, probe, ["b_key"], ["p_key"], chip_smoke.SIZE512_OUT_CAP, rec.join)
    for e in entries:
        captured[f"Size512 {e}"] = (e, rec.calls[("join", e)])
    del rec, build, probe

    ctx = SessionContext(device="cuda")
    for name, t in generate_tables(sf=chip_smoke.TPCH_SF).items():
        ctx.register_table(name, t)
    for q, want in ((args.k2_query, ("csr_build",)),
                    (args.k3_query, ("probe_ranges", "expand_ranges"))):
        rec = chip_smoke.LargestCalls(capture=True, keep=lambda key: key[1] in want)
        rec.on = True
        ctx.sql(QUERIES[q], kernels=rec.join, chain=rec.chain).collect()
        for e in want:
            captured[f"Q{q} {e}"] = (e, rec.calls[("join", e)])
        del rec
    for reg in ctx.catalog.tables.values():
        reg.release_device()
    del ctx
    torch.cuda.empty_cache()

    result = {"card": card, "root": os.path.abspath(args.root), "calls": {}}
    for label, (entry, call) in captured.items():
        fn = getattr(KERNELS, entry)
        cell = {"shape": shape(torch, entry, call), "ms": chip_smoke.cuda_ms(fn, *call, reps=5),
                "launches": launch_split(torch, fn, call)}
        result["calls"][label] = cell
        print(f"{label}: {cell['shape']} {cell['ms']:.3f} ms", flush=True)
        for name, us in cell["launches"]:
            print(f"  {us:10.1f} us  {name}", flush=True)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
