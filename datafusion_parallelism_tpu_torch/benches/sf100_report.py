"""Render the consolidated SF100 artifact as a table in PERF.md.
Counterpart of the root `benches/sf100_report.py`, which writes the JAX
package's RESULTS.md; this one writes the port's PERF.md and nothing else.

    python -m datafusion_parallelism_tpu_torch.benches.sf100_report \
        [--results DIR] [--perf FILE]

Reads --results (default `results/sf100_torch/`: the `merge_sf100` output)
`results.json` and `eligibility.json`, and replaces the text between the
SF100:BEGIN / SF100:END markers in --perf (default PERF.md at the repo root)
with one row a query: wall s, chunks or partitions, retries, oracle s, the
out-of-core path, the run it was measured in, the check; a query whose
only entry is an error gets an error row. The closing line names the card
and power limit of each run, as recorded in the artifact. Without the
markers it prints the block and exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BEGIN = ("<!-- SF100:BEGIN (generated by python -m "
         "datafusion_parallelism_tpu_torch.benches.sf100_report) -->")
END = "<!-- SF100:END -->"


def path_of(e: dict) -> str:
    """The out-of-core path an eligibility entry names."""
    if e.get("via_grace"):
        return f"grace/{e.get('merge', '?')}"
    if e.get("via_side_swap"):
        return "stream+swap"
    if e.get("eligible"):
        return "stream"
    return "resident"


def rows(d: dict, elig: dict) -> list:
    """The table's lines, the root report's rows one for one."""
    lines = [
        "| query | wall s | chunks/parts | retries | oracle s | path | round | check |",
        "|---|---|---|---|---|---|---|---|",
    ]
    rounds = d.get("measured_in_round", {})
    for q in sorted(d.get("query_summary", {}), key=int):
        s = d["query_summary"][q]
        m = d.get("query_metrics", {}).get(q, {})
        ok = d.get("checked", {}).get(q)
        lines.append(
            f"| Q{q} | {s['median_warm_ms'] / 1000:.0f} "
            f"| {m.get('streamed_chunks', 0)} | {m.get('retries', 0)} "
            f"| {s.get('oracle_ms', 0) / 1000:.0f} | {path_of(elig.get(q, {}))} "
            f"| r{rounds.get(q, '?')} "
            f"| {'PASS' if ok else 'FAIL' if ok is False else '—'} |")
    for q in sorted(d.get("query_metrics", {}), key=int):
        if "error" in d["query_metrics"][q] and q not in d.get("query_summary", {}):
            lines.append(f"| Q{q} | — | — | — | — | — | — | "
                         f"{d['query_metrics'][q]['error'][:40]} |")
    return lines


def closing(d: dict) -> str:
    """How many queries passed, at which scale, on which cards."""
    checked = sum(bool(ok) for ok in d.get("checked", {}).values())
    by_card = {}
    for label, rec in d.get("device_by_run", {}).items():
        by_card.setdefault(rec.get("nvidia_smi", "card not recorded"), []).append(label)
    cards = "; ".join(f"{card} (run {', '.join(labels)})"
                      for card, labels in by_card.items()) or "card not recorded"
    sf = d.get("config", {}).get("scale_factor")
    scale = f"SF{sf:g}" if isinstance(sf, (int, float)) else "an unrecorded scale"
    return f"{checked} of 22 queries oracle-checked at {scale} on one {cards}."


def render(results_dir: str) -> str:
    with open(os.path.join(results_dir, "results.json")) as f:
        d = json.load(f)
    elig = {}
    ep = os.path.join(results_dir, "eligibility.json")
    if os.path.exists(ep):
        with open(ep) as f:
            elig = json.load(f).get("queries", {})
    return "\n".join(rows(d, elig) + ["", closing(d)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--results", default=os.path.join(ROOT, "results", "sf100_torch"))
    ap.add_argument("--perf", default=os.path.join(ROOT, "PERF.md"))
    args = ap.parse_args(argv)
    block = render(args.results)
    with open(args.perf) as f:
        md = f.read()
    if BEGIN not in md or END not in md:
        print(f"no SF100 markers in {args.perf}; the block:\n")
        print(block)
        return 1
    pre, rest = md.split(BEGIN, 1)
    md = pre + BEGIN + "\n" + block + "\n" + END + rest.split(END, 1)[1]
    with open(args.perf, "w") as f:
        f.write(md)
    print(f"{args.perf}: SF100 table rendered from {args.results}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
