"""Render the roofline JSON (`roofline --out`) as a table in PERF.md.
Counterpart of the root `benches/roofline_report.py`, which writes the
JAX package's RESULTS.md; this one writes the port's PERF.md and nothing
else.

    python -m datafusion_parallelism_tpu_torch.benches.roofline_report \
        [--json FILE] [--perf FILE]

Replaces the text between the ROOFLINE:BEGIN / ROOFLINE:END markers in
--perf (default PERF.md at the repo root) with the table, so the two
cannot disagree; without the markers it prints the block and exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .bench_lib import OUT_DIR
from .roofline import DEFAULT_OUT

BEGIN = ("<!-- ROOFLINE:BEGIN (generated by python -m "
         "datafusion_parallelism_tpu_torch.benches.roofline_report) -->")
END = "<!-- ROOFLINE:END -->"


def render(art: dict) -> str:
    p = art["primitives"]
    power = art.get("power_limit_w")
    lines = [
        BEGIN,
        "",
        f"`python -m datafusion_parallelism_tpu_torch.benches.roofline` on {art['device']}"
        f" ({'power limit ' + format(power, '.2f') + ' W' if power else 'no power limit read'}),"
        f" {art['rows']:,} rows, the least of {art['rounds']} interleaved rounds of "
        f"{art['iters']} calls each ({art['timer']}); {art['candidates']:,} candidates and "
        f"{art['matches']:,} matches in the join, {art['survivors']:,} rows kept by the "
        f"filter, {art['groups']:,} groups.",
        "",
        f"Primitives (torch calls, less the launch floor of {p['launch_s'] * 1e3:.4f} ms): "
        f"gather {p['gather_ns']:.4f} ns/idx, W=4 rows {p['gather4_ns']:.4f}, [2, 4N] "
        f"descriptors {p['gather2big_ns']:.4f}, W=13 rows {p['rowgather13_ns']:.4f}, "
        f"scatter-add {p['scatter_ns']:.4f} ns/idx, int32 argsort "
        f"{p['sort_s'] * 1e3:.4f} ms, 2-key sort {p['sort2key_s'] * 1e3:.4f} ms, int64 "
        f"cumsum {p['cumsum_s'] * 1e3:.4f} ms.",
        "",
        "| operator | measured ms | bytes | byte bound ms | x bound | primitive model ms | "
        "x model |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in art["operators"]:
        lines.append(f"| {r['op']} | {r['measured_ms']:.4f} | {r['bytes']:,} | "
                     f"{r['byte_bound_ms']:.4f} | {r['ratio_bound']:.2f} | "
                     f"{r['model_ms']:.4f} | {r['ratio_model']:.2f} |")
    lines += ["", END]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=DEFAULT_OUT)
    ap.add_argument("--perf", default=os.path.join(os.path.dirname(OUT_DIR), "PERF.md"))
    args = ap.parse_args(argv)
    with open(args.json) as f:
        block = render(json.load(f))
    with open(args.perf) as f:
        md = f.read()
    if BEGIN not in md or END not in md:
        print(f"no ROOFLINE markers in {args.perf}; the block:\n")
        print(block)
        return 1
    pre, rest = md.split(BEGIN, 1)
    md = pre + block + rest.split(END, 1)[1]
    with open(args.perf, "w") as f:
        f.write(md)
    print(f"{args.perf}: roofline table rendered from {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
