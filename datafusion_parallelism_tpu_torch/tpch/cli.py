"""TPC-H benchmark CLI (torch).

Copied from the JAX package's `tpch/cli.py`, which mirrors the reference
harness `tpc/src/main.rs`: the same flags (--concurrency --iterations
--query --from-memory --memory-partitions --print-plan, reference
tpc/src/main.rs:59-114), the same Results JSON (system_time, engine
version, config, args, register_tables_time, query_times — reference
tpc/src/main.rs:116-141,271-285), per-query CSV timings, and
first-iteration answer CSVs for checking. Every key of the JAX CLI's
results.json is kept. The port compiles no query, so `compiles` and
`compile_time_s` read 0; the CUDA kernels are built by nvcc at their
first launch, inside iteration 0, which the median of the warm iterations
leaves out. Each query's metrics also carry its `route` ("resident",
"streamed", "grace agg", ...) and `peak_device_bytes`, the most device
memory its iterations held (None off the card).

`--device` (default "cuda") names the session's device; "cuda" raises
when there is no GPU, and "cpu" runs the kernels' plain versions.
`--concurrency P` runs every query over P partitions in this process
(runtime/distributed_executor.py). The load and the registration run under
the spans "tpch.load" and "tpch.register" (utils/tracing.py).

Usage:
    python -m datafusion_parallelism_tpu_torch.tpch.cli \
        --scale-factor 0.01 --query 5 --iterations 3 --output-path results/
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import time
from datetime import datetime

import torch

from .. import SessionConfig, SessionContext, __version__
from ..ops.hash_table import JoinStrategy
from ..utils.tracing import span
from .datagen import generate_tables
from .oracle import oracle_query
from .queries import QUERIES


def load_data_path(path: str) -> dict:
    """Load TPC-H tables from a directory: per table, probed in this order,
    a <name>/ directory of the native generator's binary columns
    (memmapped), <name>.parquet, a <name>/ directory of parquet parts, or
    <name>.tbl."""
    from ..utils.binfmt import is_bin_table_dir, read_bin_table
    from ..utils.parquet_io import read_parquet
    from .datagen import TABLE_NAMES
    from .tbl_loader import load_tbl

    tables = {}
    for name in TABLE_NAMES:
        pq_file = os.path.join(path, f"{name}.parquet")
        pq_dir = os.path.join(path, name)
        tbl = os.path.join(path, f"{name}.tbl")
        if os.path.isdir(pq_dir) and is_bin_table_dir(pq_dir):
            # native binary columnar (memmapped: SF100 opens instantly and
            # the streaming executor reads only the touched chunk pages)
            tables[name] = read_bin_table(pq_dir)
        elif os.path.isfile(pq_file):
            tables[name] = read_parquet(pq_file)
        elif os.path.isdir(pq_dir):
            tables[name] = read_parquet(pq_dir)
        elif os.path.isfile(tbl):
            tables[name] = load_tbl(tbl, name)
        else:
            raise FileNotFoundError(f"no data for table {name!r} under {path}")
    return tables


def apply_config_file(cfg, path: str) -> None:
    """key=value lines -> SessionConfig attributes (values parse as python
    literals when possible; '#' comments and blank lines skipped)."""
    import ast
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            key, _, val = line.partition("=")
            key, val = key.strip(), val.strip()
            if not hasattr(cfg, key):
                raise KeyError(f"unknown config key {key!r} in {path}")
            try:
                parsed = ast.literal_eval(val)
            except (ValueError, SyntaxError):
                parsed = val
            setattr(cfg, key, parsed)


def run(argv=None) -> dict:
    ap = argparse.ArgumentParser("tpch")
    ap.add_argument("--concurrency", type=int, default=1,
                    help="target partitions (mesh width for distributed runs)")
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--query", type=int, action="append", default=None,
                    help="query number 1-22; repeatable; default all")
    ap.add_argument("--scale-factor", type=float, default=0.01)
    ap.add_argument("--from-memory", action="store_true", default=True)
    ap.add_argument("--memory-partitions", type=int, default=None)
    ap.add_argument("--join-strategy", default="csr",
                    choices=[s.value for s in JoinStrategy],
                    help="analog of the reference's --new-join-replacement")
    ap.add_argument("--print-plan", action="store_true")
    ap.add_argument("--check", action="store_true",
                    help="validate results against the Python oracle")
    ap.add_argument("--output-path", default=None)
    ap.add_argument("--data-path", default=None,
                    help="directory of <table>.parquet files / <table>/ part "
                    "dirs / <table>.tbl instead of generating data "
                    "(reference tpc/src/main.rs --data-path)")
    ap.add_argument("--config-path", default=None,
                    help="key=value file applied to SessionConfig "
                    "(reference tpc/src/main.rs:160-177)")
    ap.add_argument("--device", default="cuda",
                    help="the session's device: cuda (raises without a GPU) "
                    "or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)

    queries = args.query or sorted(QUERIES)
    cfg = SessionConfig(target_partitions=args.concurrency,
                        join_strategy=JoinStrategy(args.join_strategy))
    if args.config_path:
        apply_config_file(cfg, args.config_path)
    ctx = SessionContext(cfg, device=args.device)
    t0 = time.time()
    with span("tpch.load"):
        if args.data_path:
            tables = load_data_path(args.data_path)
        else:
            tables = generate_tables(sf=args.scale_factor)
    with span("tpch.register"):
        for n, t in tables.items():
            ctx.register_table(n, t, getattr(t, "statistics_hint", None))
    register_time = time.time() - t0

    results = {
        "system_time": datetime.now().isoformat(),
        "engine": "datafusion_parallelism_tpu_torch",
        "engine_version": __version__,
        "config": {"scale_factor": args.scale_factor,
                   "join_strategy": args.join_strategy},
        "args": vars(args),
        "register_tables_time_s": register_time,
        "query_times_ms": {},
        "query_summary": {},
        "query_metrics": {},
        "checked": {},
    }

    outdir = args.output_path
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        # MERGE with any prior results.json in this directory: partial
        # invocations (per-query runs, crashed suites) accumulate into ONE
        # consolidated artifact instead of overwriting each other — queries
        # run now replace their own old entries only
        prior_path = os.path.join(outdir, "results.json")
        if os.path.exists(prior_path):
            try:
                with open(prior_path) as f:
                    prior = json.load(f)
                for sect in ("query_times_ms", "query_summary",
                             "query_metrics", "checked"):
                    results[sect] = {int(k): v
                                     for k, v in prior.get(sect, {}).items()}
            except (ValueError, OSError):
                pass

    for q in queries:
        # this invocation owns q's entries now; stale merged ones go
        for sect in ("query_times_ms", "query_summary", "query_metrics",
                     "checked"):
            results[sect].pop(q, None)
        handle = ctx.sql(QUERIES[q])
        if args.print_plan:
            print(f"-- Q{q} plan --\n{handle.explain()}")
        times = []
        first_rows = None
        if ctx.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(ctx.device)
        try:
            for it in range(args.iterations):
                t0 = time.time()
                out = handle.collect()
                times.append((time.time() - t0) * 1000)
                if it == 0:
                    first_rows = out.to_pylist()
        except Exception as e:       # keep the suite going; record the error
            import traceback
            traceback.print_exc()
            results["query_metrics"][q] = {"error": f"{type(e).__name__}: {e}"}
            print(f"Q{q}: FAILED ({type(e).__name__})", flush=True)
            continue
        results["query_times_ms"][q] = times
        m = handle.metrics
        results["query_metrics"][q] = {
            "compiles": 0, "compile_time_s": 0.0,
            "retries": m.retries, "route": m.route,
            "peak_device_bytes": (torch.cuda.max_memory_allocated(ctx.device)
                                  if ctx.device.type == "cuda" else None),
            # distributed send-cap keys are (join_id, side) tuples — JSON
            # object keys must be strings
            "join_caps": {str(k): v for k, v in m.join_caps.items()},
            "streamed_chunks": m.streamed_chunks,
            # per-query time decomposition: wall = device/sync windows
            # (run_time_s) + host packing + uploads + python/dispatch rest
            "launches": m.launches,
            "run_time_s": m.run_time_s,
            "host_pack_s": m.host_pack_s,
            "wall_s": sum(times) / 1000.0,
            "decomposition": {
                "compile_s": 0.0,
                "device_and_sync_s": round(m.run_time_s, 3),
                "host_pack_s": round(m.host_pack_s, 3),
                "upload_s": round(m.upload_s, 3),
                "dispatch_other_s": round(
                    max(0.0, sum(times) / 1000.0
                        - m.run_time_s - m.host_pack_s - m.upload_s), 3),
            }}
        if args.concurrency > 1:
            # distributed scaling proxies: the collectives' bytes a partition
            # receives and each join's per-partition work balance
            results["query_metrics"][q]["comm_bytes"] = m.comm_bytes
            results["query_metrics"][q]["balance"] = \
                {str(k): v for k, v in m.balance.items()}
            if m.stage_bytes:
                results["query_metrics"][q]["stage_bytes"] = m.stage_bytes
        # steady-state summary: iteration 0 pays the kernels' builds and
        # the uploads and is NEVER reported as the query time (reference
        # methodology runs 100 iterations, tpc/scripts/_run_benchmark.sh:74;
        # the median of the warm iterations is its drift-robust analog)
        import statistics
        warm = times[1:] if len(times) > 1 else times
        results["query_summary"][q] = {
            "iterations": len(times),
            "median_warm_ms": statistics.median(warm),
            "stdev_warm_ms": (statistics.stdev(warm)
                              if len(warm) > 1 else 0.0),
            "min_ms": min(times),
        }
        status = ""
        if args.check:
            t0 = time.time()
            expected = oracle_query(q, tables)
            # the host-side oracle's wall clock: the per-query CPU anchor
            results["query_summary"][q]["oracle_ms"] = \
                (time.time() - t0) * 1000
            ok = _rows_match(first_rows, expected)
            results["checked"][q] = ok
            status = " check=" + ("PASS" if ok else "FAIL")
        print(f"Q{q}: median-warm "
              f"{results['query_summary'][q]['median_warm_ms']:.1f} ms over "
              f"{len(times)} iters (best {min(times):.1f}, route {m.route}, "
              f"retries {m.retries}){status}",
              flush=True)
        if outdir and first_rows is not None:
            with open(os.path.join(outdir, f"q{q}.csv"), "w", newline="") as f:
                if first_rows:
                    w = csv.DictWriter(f, fieldnames=list(first_rows[0]))
                    w.writeheader()
                    w.writerows(first_rows)
        if outdir:
            # write incrementally: long runs may be killed mid-suite
            with open(os.path.join(outdir, "results.json"), "w") as f:
                json.dump(results, f, indent=2, default=str)

    if outdir:
        with open(os.path.join(outdir, "results.json"), "w") as f:
            json.dump(results, f, indent=2, default=str)
        with open(os.path.join(outdir, "timings.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["query", "iteration", "ms", "warm",
                        "median_warm_ms", "stdev_warm_ms", "oracle_ms"])
            for q, ts in results["query_times_ms"].items():
                s = results["query_summary"].get(q, {})
                for i, ms in enumerate(ts):
                    w.writerow([q, i, ms, int(i > 0 or len(ts) == 1),
                                s.get("median_warm_ms", ""),
                                s.get("stdev_warm_ms", ""),
                                s.get("oracle_ms", "")])
    return results


def _rows_match(actual, expected) -> bool:
    import math

    def key(r):
        return tuple(sorted((k, repr(v)) for k, v in r.items()))

    if len(actual) != len(expected):
        return False

    def norm(rows):
        names = sorted({k for r in rows for k in r})
        out = []
        for r in rows:
            row = []
            for n in names:
                v = r.get(n)
                if isinstance(v, float):
                    # absolute 4-decimal rounding for small magnitudes;
                    # relative (8 significant digits) for large sums, where
                    # float64 summation-order error exceeds 1e-4 (SF10 Q1
                    # sums reach 1e13)
                    v = round(v, 4) if abs(v) < 1e6 else float(f"{v:.8g}")
                row.append((n, v))
            out.append(tuple(row))
        return sorted(out)

    a, e = norm(actual), norm(expected)
    for ra, re_ in zip(a, e):
        for (na, va), (ne, ve) in zip(ra, re_):
            if na != ne:
                return False
            if isinstance(va, float) and isinstance(ve, float):
                if not math.isclose(va, ve, rel_tol=1e-6, abs_tol=1e-4):
                    return False
            elif va != ve:
                return False
    return True


if __name__ == "__main__":
    run()
