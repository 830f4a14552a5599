#!/usr/bin/env python3
"""Host packing of a streamed chunk's shards, one thread against one a
shard, through the port's distributed morsel streaming at P = 8 in process
on one NVIDIA GPU.

    python3 tools/bench_stream_pack.py [--out _data/bench_stream_pack.json] \
        [--query N ...] [--rounds R]

Generates TPC-H at SF10 with the port's copied generator (as
`chip_smoke.py` phase 14) and registers it in
`SessionContext(SessionConfig(target_partitions=8), device=cuda)`. Under
`chip_smoke.py`'s OOC_ENV (phase 16's and 22's thresholds) each query
(default Q1, Q3 and Q10) streams lineitem in 15 chunks; per round it runs
with `ChunkUploader.PACK_THREADS` 1, the default, the default, 1 (a new
handle each: one settling collect(), then one timed from a synchronize to a
synchronize), and records the timed ms, the host packing seconds, the
upload seconds and the seconds blocked on the chunks' totals. The full
result goes to --out as JSON. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from datafusion_parallelism_tpu_torch import SessionConfig, SessionContext  # noqa: E402
from datafusion_parallelism_tpu_torch.kernels import _build  # noqa: E402
from datafusion_parallelism_tpu_torch.runtime.streaming import ChunkUploader  # noqa: E402
from datafusion_parallelism_tpu_torch.tpch import QUERIES  # noqa: E402
from datafusion_parallelism_tpu_torch.tpch.datagen import generate_tables  # noqa: E402


def timed(ctx, dev, q, threads) -> dict:
    ChunkUploader.PACK_THREADS = threads
    with chip_smoke.ooc_env():
        handle = ctx.sql(QUERIES[q])
        handle.collect()
        m = handle.metrics
        pack0, up0, wait0 = m.host_pack_s, m.upload_s, m.run_time_s
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        handle.collect()
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
    if not m.route.startswith("streamed"):
        raise AssertionError(f"Q{q} ran {m.route}")
    return {"threads": threads, "ms": ms, "host_pack_s": m.host_pack_s - pack0,
            "upload_s": m.upload_s - up0, "blocked_s": m.run_time_s - wait0,
            "chunks": m.streamed_chunks}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="_data/bench_stream_pack.json")
    ap.add_argument("--query", type=int, action="append")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_stream_pack: no CUDA device", file=sys.stderr)
        return 1
    os.environ["DFP_NO_CAP_STORE"] = "1"
    dev = torch.device("cuda", 0)
    _build.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    ctx = SessionContext(SessionConfig(target_partitions=chip_smoke.DIST_P), device=dev)
    for name, t in generate_tables(sf=chip_smoke.TPCH_SF).items():
        ctx.register_table(name, t)
    default = ChunkUploader.PACK_THREADS
    runs, summary = {}, {}
    for q in args.query or [1, 3, 10]:
        runs[q] = [timed(ctx, dev, q, threads) for _ in range(args.rounds)
                   for threads in (1, default, default, 1)]
        summary[q] = {t: {k: statistics.median(r[k] for r in runs[q] if r["threads"] == t)
                          for k in ("ms", "host_pack_s", "blocked_s")}
                      for t in (1, default)}
        print(f"Q{q}: " + "; ".join(
            f"{t} thread(s) {v['ms']:.1f} ms, host pack {v['host_pack_s']:.3f} s, blocked "
            f"{v['blocked_s']:.3f} s" for t, v in summary[q].items()), flush=True)
    ChunkUploader.PACK_THREADS = default
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "sf": chip_smoke.TPCH_SF, "partitions": chip_smoke.DIST_P,
                   "default_threads": default, "runs": runs, "summary": summary}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
