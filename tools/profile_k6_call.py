#!/usr/bin/env python3
"""K6 radix_sort's largest call of one TPC-H query, captured and profiled on
one NVIDIA GPU.

    python3 tools/profile_k6_call.py [--query 18]

Generates TPC-H at SF10 with the port's copied generator, runs the query
once through `SessionContext(device=cuda)` (the first run: the capacities
the planner seeds, as `chip_smoke.py` phase 15 replays them) and captures
the arguments of its largest chain `radix_sort` call. Prints the call's
shape, its plan (each word's varying bits), how many rows equal its last
row (a capacity-padded table's padding), its time by CUDA events (median
of 5, as phase 15 times it) and the device time of each of its kernels
over 3 calls under `torch.profiler`. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["DFP_NO_CAP_STORE"] = "1"

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402

from datafusion_parallelism_tpu_torch import SessionContext  # noqa: E402
from datafusion_parallelism_tpu_torch.kernels import radix_sort as k6  # noqa: E402
from datafusion_parallelism_tpu_torch.tpch import QUERIES, generate_tables  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--query", type=int, default=18)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_k6_call: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.phase_build(), flush=True)
    ctx = SessionContext(device="cuda")
    for name, t in generate_tables(sf=chip_smoke.TPCH_SF).items():
        ctx.register_table(name, t)
    rec = chip_smoke.LargestCalls(capture=True)
    rec.on, rec.query = True, args.query
    ctx.sql(QUERIES[args.query], kernels=rec.join, chain=rec.chain).collect()
    rec.on = False
    words, signed = rec.calls[("chain", "radix_sort")]
    del rec, ctx
    torch.cuda.empty_cache()
    plan = k6.planned(words, signed)
    print("shape", tuple(words.shape), "signed", signed, "masks",
          [hex(m) for m in plan.masks], "bits", plan.bits, "passes", len(plan.passes))
    padding = int((words == words[:, -1:]).all(0).sum())
    print("rows equal to the last row", padding, "of", words.shape[1])
    print("cuda_ms", chip_smoke.cuda_ms(k6.radix_sort, words, signed, reps=5), flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            k6.radix_sort(words, signed)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=8,
                                    max_name_column_width=70))
    return 0


if __name__ == "__main__":
    sys.exit(main())
