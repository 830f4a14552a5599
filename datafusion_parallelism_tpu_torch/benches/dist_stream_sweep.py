"""Streamed x distributed sweep: morsel streaming through P partitions
(`runtime/distributed_streaming.py`) over the stream-eligible TPC-H
queries, each checked against the oracle. Counterpart of the root
`benches/dist_stream_sweep.py`.

    python -m datafusion_parallelism_tpu_torch.benches.dist_stream_sweep \
        [--scale-factor 1] [--concurrency 8] [--chunk-rows 1048576] \
        [--query 1 3 4 5 10 12 13 14 19 22] [--iterations 1] [--out FILE] \
        [--device cuda|cpu]

Every query runs under `DFP_STREAM_THRESHOLD_BYTES=0` and
`DFP_STREAM_CHUNK_ROWS=--chunk-rows` (restored afterwards) at
`SessionConfig(target_partitions=--concurrency)`, in process on the device,
over the port's generator's tables (`tpch.generate_tables`). One collect()
settles the capacities, then --iterations are timed; each result is held
to `tpch/oracle.py` by `tpch/diff_results.py`'s rule. The overlap
statistic reads the device-side flags each chunk's `pack_upload` timeline
event carries (`busy_t0`, `busy_t1`: whether the device was still on the
previous chunk's step when the pack opened and when it closed; always
False on the CPU), not host-time windows. Each query prints one JSON line
(`rows`: lineitem's rows, the scale); the whole sweep, timelines included,
is written to --out (default `bench_out/dist_stream_sweep.json` under the
repo, which git ignores). Exits non-zero when a query fails its check.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os

from ..api import SessionConfig, SessionContext
from ..tpch import QUERIES, generate_tables
from ..tpch.diff_results import _norm, _rows_match
from ..tpch.oracle import oracle_query
from .bench_lib import OUT_DIR, Mismatch, device_of, report_stats, timeit_stats

DEFAULT_OUT = os.path.join(OUT_DIR, "dist_stream_sweep.json")
# the JAX sweep's stream-eligible queries (benches/dist_stream_sweep.py:13)
DEFAULT_QUERIES = (1, 3, 4, 5, 10, 12, 13, 14, 19, 22)


@contextlib.contextmanager
def stream_env(chunk_rows: int):
    """Every scan streams, in chunks of `chunk_rows`; the caller's values
    come back after."""
    new = {"DFP_STREAM_THRESHOLD_BYTES": "0", "DFP_STREAM_CHUNK_ROWS": str(chunk_rows)}
    saved = {k: os.environ.get(k) for k in new}
    os.environ.update(new)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def rows_match(got, want) -> bool:
    """tpch/diff_results.py's rule over the rows as the CLI's CSVs hold them
    (each value its text, NULL empty)."""
    def text(rows):
        return _norm([{k: "" if v is None else str(v) for k, v in r.items()} for r in rows])
    return _rows_match(text(got), text(want))


def overlap_stats(timeline) -> dict:
    """Chunks after the first whose pack and upload opened / closed while the
    device still ran the previous chunk's step, and the share of them whose
    pack was hidden whole (closed while the device was busy)."""
    packs = [e for e in timeline if e["event"] == "pack_upload" and e["chunk"] > 0]
    opened = sum(bool(e["busy_t0"]) for e in packs)
    closed = sum(bool(e["busy_t1"]) for e in packs)
    return {"overlap_opened": opened, "overlap_closed": closed,
            "overlap_fraction": closed / len(packs) if packs else 0.0}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale-factor", type=float, default=1.0)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--chunk-rows", type=int, default=1 << 20)
    ap.add_argument("--query", type=int, nargs="+", default=list(DEFAULT_QUERIES))
    ap.add_argument("--iterations", type=int, default=1)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_of(args.device)

    tables = generate_tables(sf=args.scale_factor)
    scale_rows = tables["lineitem"].num_rows
    out = {"scale_factor": args.scale_factor, "concurrency": args.concurrency,
           "chunk_rows": args.chunk_rows, "queries": {}}
    failed = []
    with stream_env(args.chunk_rows):
        ctx = SessionContext(SessionConfig(target_partitions=args.concurrency), device=device)
        for name, t in tables.items():
            ctx.register_table(name, t)
        for q in args.query:
            handle = ctx.sql(QUERIES[q])
            rows = handle.collect().to_pylist()
            ok = rows_match(rows, oracle_query(q, tables))
            m = handle.metrics
            settle_retries = m.retries
            stats = timeit_stats(handle.collect, device, warmup=0, iters=args.iterations)
            entry = {"checked": ok, "route": m.route, "streamed_chunks": m.streamed_chunks,
                     "comm_bytes": m.comm_bytes, "retries": settle_retries,
                     "timed_retries": m.retries - settle_retries,
                     **overlap_stats(m.stream_timeline or []),
                     "timeline": m.stream_timeline}
            out["queries"][str(q)] = entry
            line = report_stats(f"dist_stream_sweep/Q{q}/partitions{args.concurrency}",
                                scale_rows, stats, device,
                                {k: v for k, v in entry.items() if k != "timeline"})
            out["queries"][str(q)]["line"] = line
            if not ok:
                failed.append(q)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=str)
    if failed:
        raise Mismatch(f"queries {failed} differ from the oracle")
    return out


if __name__ == "__main__":
    main()
