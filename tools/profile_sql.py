#!/usr/bin/env python3
"""Device-time breakdown of the 22 TPC-H queries through the port's SQL
surface on one NVIDIA GPU.

    python3 tools/profile_sql.py [--out _data/profile_sql.json] [--query N ...]

Generates TPC-H at SF10 with the port's copied generator (as
`chip_smoke.py` phase 14), registers it in `SessionContext(device=cuda)`
and, per query, settles the capacities with one collect() and then
profiles 3 more under `torch.profiler`. Every kernel entry point of both
kernel tables (the join's and the chain's) runs inside a `stage:<kernel>`
range, so each device activity is charged to the kernel whose wrapper
launched it, or to the plain torch glue (masks, row bounds, the capacity
checks) when no wrapper did. Per query it prints, as
`tools/profile_join.py` does for the join: the window from collect()'s
start to its last device work, the device busy time and share, and device
ms per kernel and of the glue, K5's stage split by its kernels' names
into its compaction and its row gather, K7's into its pass and its
zero tail, and K12's by its caller: the join (a call made inside
`ops/join.py`: its packs, the unpack of its pairs, the outer joins'
concatenations and the semi and anti joins' filters) against everything
else; then the sums over the queries.
The full result goes to --out as JSON. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import profile_join  # noqa: E402

from datafusion_parallelism_tpu_torch import SessionContext  # noqa: E402
from datafusion_parallelism_tpu_torch.kernels.chain import KERNEL_OF as CHAIN_OF  # noqa: E402
from datafusion_parallelism_tpu_torch.kernels.chain import KERNELS as CHAIN  # noqa: E402
from datafusion_parallelism_tpu_torch.kernels.chain import ChainKernels  # noqa: E402
from datafusion_parallelism_tpu_torch.ops.join import KERNEL_OF as JOIN_OF  # noqa: E402
from datafusion_parallelism_tpu_torch.ops.join import KERNELS as JOIN  # noqa: E402
from datafusion_parallelism_tpu_torch.ops.join import JoinKernels  # noqa: E402
from datafusion_parallelism_tpu_torch.tpch import QUERIES  # noqa: E402

# the kernels the SQL path launches (the distributed join's are not on it)
STAGES = tuple(k for k in chip_smoke.KERNEL_INFO if k not in chip_smoke.DIST_KERNELS)
# K12's calls from inside the join: a stage of their own in the trace until
# `join_caller` folds them into K12's
JOIN_K12 = "pack_rows@join"
JOIN_SOURCE = os.path.join("ops", "join.py")


# the stages split by the names of their device kernels: K5's by entry
# point (csrc/filter_compact.cu), K7's into its pass and its zero tail
# (csrc/segment_agg.cu)
SPLITS = {"filter_compact": {"compaction": ("compact_kernel", "zero_tail_kernel"),
                             "gather": ("row_gather_kernel", "row_gather_word4_kernel")},
          "segment_agg": {"pass": ("seg_pass_kernel",), "zero tail": ("seg_zero_tail_kernel",)}}


def bare_name(name: str) -> str:
    """A device kernel's name without its namespace, template arguments and
    parameters: 'void (anonymous namespace)::row_gather_kernel<4>(int
    const*, ...)' -> 'row_gather_kernel'."""
    m = re.match(r"(?:void\s+)?(?:[\w:]*::)?(\w+)", name.replace("(anonymous namespace)::", ""))
    return m.group(1) if m else name


def stage_split(stage: str, stage_ms: float, kernel_ms: dict) -> dict:
    """A stage of SPLITS (`stage_ms`, device ms) as the device ms of each of
    its parts' kernels, read from the device ms by kernel name (kernel_ms);
    `other` is the rest of the stage (memsets)."""
    split = {part: sum(ms for name, ms in kernel_ms.items() if bare_name(name) in names)
             for part, names in SPLITS[stage].items()}
    split["other"] = stage_ms - sum(split.values())
    return split


def _from_join() -> bool:
    """Whether a frame of `ops/join.py` is on the calling stack."""
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_filename.endswith(JOIN_SOURCE):
            return True
        frame = frame.f_back
    return False


def _wrap(kernel, fn):
    def run(*args):
        stage = JOIN_K12 if kernel == "pack_rows" and _from_join() else kernel
        with torch.profiler.record_function(f"stage:{stage}"):
            return fn(*args)
    return run


def join_caller(stage_ms: dict) -> dict:
    """K12's stage split by caller: the join's calls (JOIN_K12's stage,
    folded here into K12's) and the others'."""
    join = stage_ms.pop(JOIN_K12)
    split = {"join": join, "other": stage_ms["pack_rows"]}
    stage_ms["pack_rows"] += join
    return split


def staged():
    """(JoinKernels, ChainKernels): every entry point inside a
    `stage:<kernel>` profiler range."""
    join = JoinKernels(*(_wrap(JOIN_OF[e], fn) for e, fn in JOIN._asdict().items()))
    chain = ChainKernels(*(_wrap(CHAIN_OF[e], fn) for e, fn in CHAIN._asdict().items()))
    return join, chain


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("_data", "profile_sql.json"))
    ap.add_argument("--query", type=int, action="append", help="only these queries")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_sql: no CUDA device", file=sys.stderr)
        return 1
    from datafusion_parallelism_tpu_torch.tpch.datagen import generate_tables
    os.environ["DFP_NO_CAP_STORE"] = "1"
    device = torch.device("cuda", 0)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    trace_path = os.path.splitext(args.out)[0] + ".trace.json"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    ctx = SessionContext(device=device)
    for name, t in generate_tables(sf=chip_smoke.TPCH_SF).items():
        ctx.register_table(name, t)
    join, chain = staged()
    result = {"card": smi, "sf": chip_smoke.TPCH_SF, "queries": {}}
    total = {k: 0.0 for k in ("window_ms", "busy_ms")}
    stage_total = {}
    split_total = {stage: {} for stage in (*SPLITS, "pack_rows")}
    for q in args.query or sorted(QUERIES):
        handle = ctx.sql(QUERIES[q], kernels=join, chain=chain)
        handle.collect()   # settles the capacities
        res = profile_join.profile(handle.collect, 3, trace_path, STAGES + (JOIN_K12,), "query")
        kernel_ms = res.pop("kernel_ms")
        res["splits"] = {stage: stage_split(stage, res["stage_ms"][stage], kernel_ms)
                         for stage in SPLITS}
        res["splits"]["pack_rows"] = join_caller(res["stage_ms"])
        result["queries"][q] = res
        profile_join.report(f"Q{q}", res, "query")
        for stage, split in res["splits"].items():
            print(f"  {stage}: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()) + " ms",
                  flush=True)
            for k, v in split.items():
                split_total[stage][k] = split_total[stage].get(k, 0.0) + v
        for k in total:
            total[k] += res[k]
        for k, v in res["stage_ms"].items():
            stage_total[k] = stage_total.get(k, 0.0) + v
    os.remove(trace_path)
    result["sum"] = {**total, "busy_share": total["busy_ms"] / total["window_ms"],
                     "stage_ms": stage_total, "splits": split_total}
    print(f"sum over {len(result['queries'])} queries: window {total['window_ms']:.3f} ms, "
          f"device busy {total['busy_ms']:.3f} ms, busy share "
          f"{result['sum']['busy_share']:.3f}; device ms by stage: "
          + ", ".join(f"{k} {v:.3f}" for k, v in stage_total.items())
          + "".join(f"; {stage}: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
                    for stage, split in split_total.items()), flush=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
