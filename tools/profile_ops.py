#!/usr/bin/env python3
"""Device-time breakdown of the port's single-table chains on one NVIDIA GPU.

    python3 tools/profile_ops.py [--out _data/profile_ops.json]

Generates TPC-H lineitem with the port's copied generator (SF10: about
60 M rows at capacity 67,108,864, as `chip_smoke.py` phase 10) and runs
its Q1 and Q18-shaped chains (`chip_smoke.q1_steps`, `q18_steps`) under
`torch.profiler`. The chains run on `staged()` kernels: every K5-K8 entry
point (and K1's) inside a `stage:<kernel>` range, so each device activity is charged to the kernel
whose wrapper launched it, or to the plain torch glue (masks, row bounds,
the capacity checks) when no wrapper did. Per chain it prints,
as `tools/profile_join.py` does for the join: the window from the chain's
host start to its last device work, the device busy time and share, device
ms per kernel and of the glue, and the device kernels that took the most
time. The full result goes to --out as JSON. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import profile_join  # noqa: E402

from datafusion_parallelism_tpu_torch.kernels.chain import (KERNEL_OF, KERNELS,  # noqa: E402
                                                           ChainKernels)
from datafusion_parallelism_tpu_torch.ops.plan import run_steps  # noqa: E402

STAGES = tuple(dict.fromkeys(KERNEL_OF.values()))
CHAINS = {"Q1": chip_smoke.q1_steps, "Q18-shaped": chip_smoke.q18_steps}


def staged() -> ChainKernels:
    """The chain's kernels, each call inside a `stage:<kernel>` profiler
    range."""
    def wrap(entry, fn):
        def run(*args):
            with torch.profiler.record_function(f"stage:{KERNEL_OF[entry]}"):
                return fn(*args)
        return run

    return ChainKernels(*(wrap(e, fn) for e, fn in zip(ChainKernels._fields, KERNELS)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("_data", "profile_ops.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_ops: no CUDA device", file=sys.stderr)
        return 1
    from datafusion_parallelism_tpu_torch.tpch.datagen import generate_tables
    device = torch.device("cuda", 0)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    trace_path = os.path.splitext(args.out)[0] + ".trace.json"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    host = generate_tables(sf=chip_smoke.TPCH_SF)["lineitem"]
    li = chip_smoke.qualify(host.to_device(chip_smoke.LINEITEM_CAP, device=device), "lineitem")
    result = {"card": smi, "sf": chip_smoke.TPCH_SF, "lineitem_rows": host.num_rows,
              "capacity": li.capacity}
    kernels = staged()
    for name, make in CHAINS.items():
        steps, caps = make(), {}
        run_steps(li, steps, caps)   # learns the grown capacities
        result[name] = profile_join.profile(lambda: run_steps(li, steps, caps, kernels),
                                            3, trace_path, STAGES, "chain")
        profile_join.report(name, result[name], "chain")
    os.remove(trace_path)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
