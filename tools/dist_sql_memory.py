#!/usr/bin/env python3
"""Peak device memory and time of the 22 TPC-H queries through the port's
distributed executor at P = 8 in process on one NVIDIA GPU, at several
values of the shuffle's received-bytes budget.

    python3 tools/dist_sql_memory.py [--out _data/dist_sql_memory.json] \
        [--budget GIB ...] [--query N ...]

Generates TPC-H at SF10 with the port's copied generator (as
`chip_smoke.py` phase 14), registers it in
`SessionContext(SessionConfig(target_partitions=8), device=cuda)` and runs
each query once per budget: `parallel/shuffle.py`'s RECV_BUDGET_BYTES set
to each `--budget` in GiB (0: every send block sized from K18's counts;
`none`: the JAX package's static send capacities everywhere; by default
the committed value, then none). Per query and budget: one collect() that
settles the capacities, its seconds and the peak device memory over it,
then one more collect() (ms, peak), the retries, staged or not; a run that
exhausts the device memory is reported as such with its peak, and the
next query starts from a freed device. The full result goes to --out as
JSON. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from datafusion_parallelism_tpu_torch import SessionConfig, SessionContext  # noqa: E402
from datafusion_parallelism_tpu_torch.kernels import _build  # noqa: E402
from datafusion_parallelism_tpu_torch.parallel import shuffle  # noqa: E402
from datafusion_parallelism_tpu_torch.tpch import QUERIES  # noqa: E402
from datafusion_parallelism_tpu_torch.tpch.datagen import generate_tables  # noqa: E402

SF = 10
P = 8
NO_BUDGET = 1 << 62


def run(ctx, dev, q) -> dict:
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    handle = ctx.sql(QUERIES[q])
    out = {"base_bytes": base}
    t0 = time.perf_counter()
    try:
        handle.collect()
        torch.cuda.synchronize(dev)
        out["first_s"] = time.perf_counter() - t0
        out["first_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        handle.collect()
        torch.cuda.synchronize(dev)
        out["ms"] = (time.perf_counter() - t0) * 1e3
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        out.update(retries=handle.metrics.retries, staged=handle.metrics.staged)
    except torch.OutOfMemoryError:
        out["out_of_memory_after_s"] = time.perf_counter() - t0
        out["first_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    del handle
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="_data/dist_sql_memory.json")
    ap.add_argument("--query", type=int, action="append")
    ap.add_argument("--budget", action="append",
                    help="GiB, or none (repeatable; default: the committed value, then none)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dist_sql_memory: no CUDA device", file=sys.stderr)
        return 1
    os.environ["DFP_NO_CAP_STORE"] = "1"
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    _build.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    tables = generate_tables(sf=SF)
    result = {"card": smi, "sf": SF, "partitions": P, "queries": {}}
    budgets = {}
    for b in args.budget or [str(shuffle.RECV_BUDGET_BYTES / 2**30), "none"]:
        budgets[f"budget {b}"] = NO_BUDGET if b == "none" else int(float(b) * 2**30)
    for label, budget in budgets.items():
        shuffle.RECV_BUDGET_BYTES = budget
        ctx = SessionContext(SessionConfig(target_partitions=P), device=dev)
        for name, t in tables.items():
            ctx.register_table(name, t)
        for q in args.query or sorted(QUERIES):
            r = run(ctx, dev, q)
            result["queries"].setdefault(q, {})[label] = r
            print(f"Q{q} {label}: " + ", ".join(f"{k} {v}" for k, v in r.items()), flush=True)
        del ctx
        gc.collect()
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
