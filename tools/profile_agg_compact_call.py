#!/usr/bin/env python3
"""K8 direct_agg and K5's compaction (filter_compact) at their largest SQL
calls, split launch by launch on one NVIDIA GPU.

    python3 tools/profile_agg_compact_call.py [--root DIR] [--save FILE] [--out FILE]

Imports `datafusion_parallelism_tpu_torch` and `chip_smoke.py` from --root
(this checkout by default; a checkout of another commit, e.g. the parent
unpacked with `git archive` under `_data/`, splits that version).
Generates TPC-H at SF10 with the port's copied generator and captures,
from the first run of each query (the capacities the planner seeds, as
`chip_smoke.py` phase 15 replays them), the largest `direct_agg` call of
Q1 and of Q6 and the largest `filter_compact` call of Q19. Per call it
prints its shape (K8: capacity, rows, domains and groups, each request's
function and input type, the rows the filter keeps, the bytes a row of
its distinct input columns, and how many distinct groups a warp's 32 rows
hold; K5: capacity, words, sidecars, out_cap and
survivors), its time by CUDA events (median of 5) and each of its device
activities (kernels, copies, memsets) in launch order, the median over 3
calls under `torch.profiler`. --save writes the captured calls (on the
host, with `torch.save`) for `tools/bench_agg_compact.py --calls`
(--no-profile: and stops there). Prints
one JSON object with the card's name and power limit, also written to
--out. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# label: (query, chain entry point)
CALLS = {"K8 Q1": (1, "direct_agg"), "K8 Q6": (6, "direct_agg"),
         "K5 compaction Q19": (19, "filter_compact")}


def capture(torch, sf: float, device) -> dict:
    """{label: the arguments of that query's largest call of the entry
    point} from the first run of each query over TPC-H at `sf`."""
    import chip_smoke
    from datafusion_parallelism_tpu_torch import SessionContext
    from datafusion_parallelism_tpu_torch.tpch import QUERIES, generate_tables
    ctx = SessionContext(device=device)
    for name, t in generate_tables(sf=sf).items():
        ctx.register_table(name, t)
    out = {}
    for label, (q, entry) in CALLS.items():
        rec = chip_smoke.LargestCalls(capture=True, keep=lambda key, e=entry: key[1] == e)
        rec.on = True
        ctx.sql(QUERIES[q], kernels=rec.join, chain=rec.chain).collect()
        out[label] = rec.calls[("chain", entry)]
        del rec
    for reg in ctx.catalog.tables.values():
        reg.release_device()
    del ctx
    torch.cuda.empty_cache()
    return out


def to_device(torch, x, device, _seen=None):
    """A captured call's arguments with every tensor on `device`; a tensor
    that appears twice (a count and a sum of one column) is moved once."""
    seen = {} if _seen is None else _seen
    if isinstance(x, torch.Tensor):
        if id(x) not in seen:
            seen[id(x)] = x.to(device)
        return seen[id(x)]
    if isinstance(x, (list, tuple)):
        return type(x)(to_device(torch, y, device, seen) for y in x)
    if isinstance(x, dict):
        return {k: to_device(torch, v, device, seen) for k, v in x.items()}
    return x


def k8_shape(torch, args) -> dict:
    from datafusion_parallelism_tpu_torch.kernels import direct_agg as k8
    keys, doms, num_rows, row_filter, reqs, cap = args
    gid = k8._group_ids(keys, doms, num_rows, row_filter, cap)
    G = k8.n_groups_of(doms)
    kept = int((gid < G).sum())
    # distinct groups among the kept rows of each 32-row warp step
    steps = torch.nn.functional.pad(gid, (0, -cap % 32), value=G).view(-1, 32)
    s = steps.sort(dim=1).values
    distinct = ((s[:, 1:] != s[:, :-1]) & (s[:, 1:] < G)).sum(1) + (s[:, 0] < G).long()
    busy = distinct > 0
    return {"cap": cap, "num_rows": int(num_rows), "doms": list(doms), "G": G,
            "requests": [(f, str(v.dtype).replace("torch.", ""), m is not None)
                         for f, v, m in reqs],
            "R": len(reqs) + 1, "row_filter": row_filter is not None, "rows_kept": kept,
            "staged_bytes_a_row": k8.stream_bytes(keys, reqs, row_filter),
            "warp_steps_with_rows": int(busy.sum()),
            "mean_groups_a_warp_step": float(distinct[busy].double().mean()) if kept else 0.0}


def k5_shape(args) -> dict:
    mask, words, f64, out_cap = args
    return {"cap": mask.shape[0], "W": words.shape[0], "F": f64.shape[0], "out_cap": out_cap,
            "survivors": int(mask.sum())}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--save", default=None, help="write the captured calls here (torch.save)")
    ap.add_argument("--no-profile", action="store_true", help="capture (and --save) only")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))
    os.environ["DFP_NO_CAP_STORE"] = "1"
    import torch
    if not torch.cuda.is_available():
        print("profile_agg_compact_call: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from profile_csr_call import launch_split

    from datafusion_parallelism_tpu_torch.kernels.chain import KERNELS
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    chip_smoke.phase_build()
    device = torch.device("cuda", 0)
    captured = capture(torch, chip_smoke.TPCH_SF, device)
    if args.save:
        torch.save(to_device(torch, captured, "cpu"), args.save)
    if args.no_profile:
        return 0
    result = {"card": card, "root": os.path.abspath(args.root), "calls": {}}
    for label, call in captured.items():
        entry = CALLS[label][1]
        fn = getattr(KERNELS, entry)
        cell = {"shape": k8_shape(torch, call) if entry == "direct_agg" else k5_shape(call),
                "ms": chip_smoke.cuda_ms(fn, *call, reps=5),
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
