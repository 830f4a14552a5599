"""TPC-H dataset generator CLI — analog of the reference's
tpc/scripts/generate.sh (tpchgen-cli -> parquet, SF10 default, reference
generate.sh:9-12,100-103; no cloud upload). Copied from the JAX package's
`tpch/generate.py`.

    python -m datafusion_parallelism_tpu_torch.tpch.generate \
        --scale-factor 1 --output data/tpch_sf1 [--format parquet|tbl|bin]

The directory it writes is what the benchmark CLI's --data-path consumes.
"""

from __future__ import annotations

import argparse
import os
import time

from .datagen import generate_tables


def _write_tbl(table, path: str) -> None:
    """HostTable -> dbgen-style pipe-delimited .tbl (row-terminating '|')."""
    from ..utils.columnar import Kind

    fields = table.schema.fields
    cols = []
    for f in fields:
        vals, valid = table.columns[f.name]
        if f.dtype.kind is Kind.STRING:
            strs = f.dictionary.values[vals]
            cols.append([("" if not ok else s) for s, ok in zip(strs, valid)])
        elif f.dtype.kind is Kind.DECIMAL:
            scale = 10 ** f.dtype.scale
            cols.append([("" if not ok else f"{v / scale:.{f.dtype.scale}f}")
                         for v, ok in zip(vals.tolist(), valid)])
        elif f.dtype.kind is Kind.DATE32:
            import datetime
            epoch = datetime.date(1970, 1, 1)
            cols.append([
                "" if not ok else
                (epoch + datetime.timedelta(days=int(v))).isoformat()
                for v, ok in zip(vals.tolist(), valid)])
        else:
            cols.append([("" if not ok else str(v))
                         for v, ok in zip(vals.tolist(), valid)])
    with open(path, "w") as f:
        for row in zip(*cols):
            f.write("|".join(row) + "|\n")


def run(argv=None) -> dict:
    ap = argparse.ArgumentParser("tpch-generate")
    ap.add_argument("--scale-factor", type=float, default=10.0,
                    help="reference generate.sh defaults to SF=10")
    ap.add_argument("--output", required=True)
    ap.add_argument("--format", default="parquet",
                    choices=["parquet", "tbl", "bin"],
                    help="bin = native C++ generator -> binary columnar "
                    "(memmap-loadable; ~40x faster generation, the only "
                    "practical route to SF100)")
    ap.add_argument("--tables", nargs="*", default=None,
                    help="subset of table names; default all")
    ap.add_argument("--seed", type=int, default=19940315)
    args = ap.parse_args(argv)

    os.makedirs(args.output, exist_ok=True)
    if args.format == "bin":
        from ..utils.binfmt import generate_native
        t0 = time.time()
        generate_native(args.scale_factor, args.output, args.seed)
        print(f"generated sf={args.scale_factor} (native) "
              f"in {time.time() - t0:.1f}s -> {args.output}", flush=True)
        return {}
    t0 = time.time()
    tables = generate_tables(sf=args.scale_factor)
    gen_s = time.time() - t0
    written = {}
    for name, t in tables.items():
        if args.tables and name not in args.tables:
            continue
        t0 = time.time()
        if args.format == "parquet":
            from ..utils.parquet_io import write_parquet
            path = os.path.join(args.output, f"{name}.parquet")
            write_parquet(t, path)
        else:
            path = os.path.join(args.output, f"{name}.tbl")
            _write_tbl(t, path)
        written[name] = {"rows": t.num_rows, "path": path,
                         "write_s": round(time.time() - t0, 2)}
        print(f"{name}: {t.num_rows} rows -> {path}", flush=True)
    print(f"generated sf={args.scale_factor} in {gen_s:.1f}s")
    return written


if __name__ == "__main__":
    run()
