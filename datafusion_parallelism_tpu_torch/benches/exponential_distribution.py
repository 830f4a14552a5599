"""Skewed-key join benchmark (reference benches/exponential_distribution.rs).
Counterpart of the root `benches/exponential_distribution.py`: build keys
drawn from the exponential distribution y = (16^x - 1)/15, probing a
uniform side.

    python -m datafusion_parallelism_tpu_torch.benches.exponential_distribution \
        [--rows N] [--scenario all_equal larger_probe] [--partitions P] \
        [--iters K] [--device cuda|cpu]

With no `--partitions` (or 0) the single-device INNER `hash_join` runs at
out_cap = 8 x the probe rows (K1-K4). `--partitions P` (the JAX bench's
`--mesh`) runs `parallel.distributed_hash_join` over P partitions in
process on the device, in the `partitioned` and `skew_salted` modes (K18
routes the shuffles, K19 makes the salted mode's histogram). Each line
reports `matches`, the join's output rows, and `candidates`, its
candidate total (what the JAX bench's single-device line calls
`matches`). Check: the match count and the sum of the matched rows'
`b_val` equal numpy's exact key-match answer (the sum in float64 within
rtol 1e-6), in every scenario and mode.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.join import JoinType, hash_join
from ..parallel import DistJoinConfig, distributed_hash_join, make_mesh
from ..utils.columnar import HostTable
from .bench_lib import (check, device_of, make_exponential_int_array, report_stats,
                        timeit_stats)

SCENARIOS = ("all_equal", "larger_probe")
MODES = ("partitioned", "skew_salted")
SUM_RTOL = 1e-6


def make_scenario(rows: int, scenario: str):
    """(build, probe) HostTables: the JAX bench's draws from seed 0."""
    n_build = rows
    n_probe = rows * (4 if scenario == "larger_probe" else 1)
    rng = np.random.default_rng(0)
    bk = make_exponential_int_array(rng, n_build, n_build).astype(np.int32)
    pk = rng.integers(0, n_build, n_probe).astype(np.int32)
    bv = rng.random(n_build).astype(np.float32)
    pv = rng.random(n_probe).astype(np.float32)
    return (HostTable.from_numpy({"b_key": bk, "b_val": bv}),
            HostTable.from_numpy({"p_key": pk, "p_val": pv}))


def expected(build: HostTable, probe: HostTable):
    """(matches, sum of b_val over the matched pairs in float64): numpy's
    exact key match."""
    bk, bv = build.columns["b_key"][0], build.columns["b_val"][0]
    pk = probe.columns["p_key"][0]
    size = max(int(bk.max()), int(pk.max())) + 1
    counts = np.bincount(bk, minlength=size)
    sums = np.bincount(bk, weights=bv.astype(np.float64), minlength=size)
    return int(counts[pk].sum()), float(sums[pk].sum())


def _check(label, matches, total, want) -> None:
    check(matches == want[0], f"{label}: {matches} matches, numpy {want[0]}")
    check(abs(total - want[1]) <= SUM_RTOL * abs(want[1]),
          f"{label}: sum(b_val) {total!r}, numpy {want[1]!r}")


def run_single(build, probe, scenario, device, iters) -> dict:
    bt, pt = build.to_device(device=device), probe.to_device(device=device)
    out_cap = 8 * probe.num_rows

    def step():
        out, total = hash_join(bt, pt, ["b_key"], ["p_key"], JoinType.INNER, out_cap)
        v, valid = out.column("b_val")
        return out.num_rows, total, torch.where(valid & out.row_mask(), v.double(), 0.0).sum()

    n, total, s = step()
    check(int(total) <= out_cap, f"candidate total {int(total)} past out_cap {out_cap}")
    _check(f"exp_dist/{scenario}/single", int(n), float(s), expected(build, probe))
    stats = timeit_stats(step, device, iters=iters)
    return report_stats(f"exp_dist/{scenario}/single", build.num_rows + probe.num_rows, stats,
                        device, {"matches": int(n), "candidates": int(total),
                                 "sum_b_val": float(s)})


def run_partitioned(build, probe, scenario, device, P, iters) -> list:
    mesh = make_mesh(P, device)
    want = expected(build, probe)
    out = []
    for mode in MODES:
        cfg = DistJoinConfig(mode=mode, join_type=JoinType.INNER, out_cap=8 * probe.num_rows)
        # the first call sizes the capacities
        res, cfg = distributed_hash_join(mesh, build, probe, ["b_key"], ["p_key"], cfg)
        v, valid = res.columns["b_val"]
        s = float(v[valid].astype(np.float64).sum())
        label = f"exp_dist/{scenario}/{mode}/partitions{P}"
        _check(label, res.num_rows, s, want)
        stats = timeit_stats(
            lambda: distributed_hash_join(mesh, build, probe, ["b_key"], ["p_key"], cfg),
            device, warmup=1, iters=iters)
        out.append(report_stats(label, build.num_rows + probe.num_rows, stats, device,
                                {"matches": res.num_rows, "sum_b_val": s,
                                 "out_cap": cfg.out_cap}))
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--scenario", nargs="+", default=list(SCENARIOS), choices=SCENARIOS)
    ap.add_argument("--partitions", type=int, default=0,
                    help="P > 0: the distributed join over P partitions in process")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_of(args.device)

    out = []
    for scenario in args.scenario:
        build, probe = make_scenario(args.rows, scenario)
        if args.partitions:
            out += run_partitioned(build, probe, scenario, device, args.partitions, args.iters)
        else:
            out.append(run_single(build, probe, scenario, device, args.iters))
    return out


if __name__ == "__main__":
    main()
