#!/usr/bin/env python3
"""Device-time breakdown of the port's INNER CSR hash join on one NVIDIA GPU.

    python3 tools/profile_join.py [--out _data/profile_join.json]

Runs the join of `chip_smoke.py`'s two cells (Size512, and the SF10-shaped
orders x lineitem join at its grown out_cap) through the four kernels under
`torch.profiler`, exports the trace and reads it. Each kernel wrapper runs
inside a `record_function` range; a device activity (kernel, copy, memset)
belongs to the stage whose range holds the host call that launched it, and
to the layout glue (pack/unpack and the other plain torch ops) when no
stage holds it. Per join, it prints:

  window_ms    from the join's host start to the end of its last device work
  busy_ms      the union of the join's device activity intervals
  busy_share   busy_ms / window_ms
  stage_ms     device ms of K1-K4 and of the glue (device time only: K3's
               host read of the candidate total is not in it)
  top          the device kernels that took the most time
  kernel_ms    device ms of every kernel (and copy, memset) by name

The full result goes to --out as JSON. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from datafusion_parallelism_tpu_torch.entry import make_tables  # noqa: E402
from datafusion_parallelism_tpu_torch.ops.join import (KERNELS, JoinKernels,  # noqa: E402
                                                       JoinType, hash_join, inner_csr_join)
from datafusion_parallelism_tpu_torch.utils.columnar import round_capacity  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
GLUE = "glue"


def staged_kernels() -> JoinKernels:
    """KERNELS, each call inside a `stage:<name>` profiler range."""
    def wrap(name, fn):
        def run(*args):
            with torch.profiler.record_function(f"stage:{name}"):
                return fn(*args)
        return run
    return JoinKernels(*(wrap(n, f) for n, f in zip(JoinKernels._fields, KERNELS)))


def _union_ms(intervals) -> float:
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def _holder(ranges, ts):
    for s, e, name in ranges:
        if s <= ts <= e:
            return name
    return None


def breakdown(trace: dict, iters: int, stage_names=JoinKernels._fields,
              window: str = "join") -> dict:
    """Per-run numbers from a chrome trace of `iters` runs, each in a
    `window` range, with `stage:<name>` ranges for the stage names."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    joins = [(s, e, i) for i, (s, e) in enumerate(sorted(
        (e["ts"], e["ts"] + e["dur"]) for e in events
        if e.get("cat") == "user_annotation" and e["name"] == window))]
    stages = [(e["ts"], e["ts"] + e["dur"], e["name"].split(":", 1)[1]) for e in events
              if e.get("cat") == "user_annotation" and e["name"].startswith("stage:")]
    per_join = {i: [] for _, _, i in joins}
    stage_us = {name: 0.0 for name in tuple(stage_names) + (GLUE,)}
    kernel_us = {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        j = _holder(joins, ts) if ts is not None else None
        if j is None:
            continue
        per_join[j].append((e["ts"], e["ts"] + e["dur"]))
        stage_us[_holder(stages, ts) or GLUE] += e["dur"]
        kernel_us[e["name"]] = kernel_us.get(e["name"], 0.0) + e["dur"]
    if len(joins) != iters or not any(per_join.values()):
        raise RuntimeError(f"trace holds {len(joins)} {window} ranges (expected {iters}) and "
                           f"{sum(map(len, per_join.values()))} device events in them")
    windows = [(max([e] + [d for _, d in per_join[i]]) - s) / 1e3 for s, e, i in joins]
    busy = [_union_ms(per_join[i]) for _, _, i in joins]
    top = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:12]
    return {"iters": iters,
            "window_ms": statistics.median(windows),
            "busy_ms": statistics.median(busy),
            "busy_share": statistics.median(b / w for b, w in zip(busy, windows)),
            "stage_ms": {k: v / 1e3 / iters for k, v in stage_us.items()},
            "top": [(name[:100], us / 1e3 / iters) for name, us in top],
            "kernel_ms": {name: us / 1e3 / iters for name, us in kernel_us.items()}}


def profile(run, iters: int, trace_path: str, stage_names=JoinKernels._fields,
            window: str = "join") -> dict:
    """Profile `iters` calls of run() (after one warm-up), each in a
    `window` range and followed by a synchronize."""
    run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            with torch.profiler.record_function(window):
                run()
            torch.cuda.synchronize()
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        return breakdown(json.load(f), iters, stage_names, window)


def grown_out_cap(build, probe, keys) -> int:
    """The SF10-shaped cell's out_cap: chip_smoke's seed capacity, grown as
    the executor grows it until the candidate total fits."""
    out_cap = min(max(256, build.capacity, probe.capacity), chip_smoke.SEED_CAP_CEILING)
    while True:
        _, total = hash_join(build, probe, *keys, JoinType.INNER, out_cap)
        if int(total) <= out_cap:
            return out_cap
        out_cap = round_capacity(int(total), minimum=1024)


def report(cell: str, res: dict, unit: str = "join") -> None:
    stages = ", ".join(f"{k} {v:.3f}" for k, v in res["stage_ms"].items())
    print(f"{cell}: per {unit} (median of {res['iters']}) window {res['window_ms']:.3f} ms, "
          f"device busy {res['busy_ms']:.3f} ms, busy share {res['busy_share']:.3f}; "
          f"device ms by stage: {stages}", flush=True)
    for name, ms in res["top"]:
        print(f"  {ms:9.3f} ms  {name}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("_data", "profile_join.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_join: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    trace_path = os.path.splitext(args.out)[0] + ".trace.json"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    kernels = staged_kernels()
    result = {"card": smi}

    build, probe = make_tables(np.random.default_rng(0), chip_smoke.SIZE512,
                               chip_smoke.SIZE512, chip_smoke.SIZE512, device=device)
    result["size512"] = profile(
        lambda: inner_csr_join(build, probe, ["b_key"], ["p_key"],
                               chip_smoke.SIZE512_OUT_CAP, kernels), 5, trace_path)
    report("Size512", result["size512"])
    del build, probe

    orders, lineitem, _, _ = chip_smoke.sf10_tables(np.random.default_rng(10), device)
    keys = (["o_orderkey"], ["l_orderkey"])
    out_cap = grown_out_cap(orders, lineitem, keys)
    result["sf10"] = profile(
        lambda: inner_csr_join(orders, lineitem, *keys, out_cap, kernels), 3, trace_path)
    result["sf10"]["out_cap"] = out_cap
    report(f"SF10-shaped (out_cap {out_cap})", result["sf10"])
    os.remove(trace_path)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
