"""Merge SF100 run directories into one consolidated results.json.
Counterpart of the root `benches/merge_sf100.py`, which merges the JAX
package's round-5 runs into `results/sf100/`; this one takes its runs and
its output from flags.

    python -m datafusion_parallelism_tpu_torch.benches.merge_sf100 \
        --run DIR [--run DIR ...] [--label L ...] --out DIR

Each --run is an output directory of `tools/sf100_run.py` (or of
`tpch.cli --output-path`), merged in the order given: the first run's
results.json is the base, and a query a later run ran (any entry of it in
`query_times_ms`, `query_summary`, `query_metrics` or `checked`) replaces
all of that query's earlier entries, as the CLI's own merge does
(`tpch/cli.py`). Each measured query is tagged under `measured_in_round`
with the label of the run it was measured in (--label, one a run, default
the run directory's name). --out receives results.json, each query's
answer CSV from the run that measured it, the last run's eligibility.json,
and each run's device record (`device.json`) under `device_by_run`.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

SECTIONS = ("query_times_ms", "query_summary", "query_metrics", "checked")


def _load(run_dir: str) -> dict:
    with open(os.path.join(run_dir, "results.json")) as f:
        return json.load(f)


def merge(runs, labels) -> dict:
    """The consolidated results of `runs` (directories, oldest first), each
    measured query tagged with its run's label."""
    out = _load(runs[0])
    for sect in SECTIONS:
        out.setdefault(sect, {})
    rounds = out.setdefault("measured_in_round", {})
    for q in out["query_summary"]:
        rounds.setdefault(q, labels[0])
    for run, label in zip(runs[1:], labels[1:]):
        later = _load(run)
        ran = {q for sect in SECTIONS for q in later.get(sect, {})}
        for q in ran:
            for sect in SECTIONS:
                out[sect].pop(q, None)
            rounds.pop(q, None)
        for sect in SECTIONS:
            out[sect].update(later.get(sect, {}))
        for q in later.get("query_summary", {}):
            rounds[q] = label
    devices = dict(out.get("device_by_run", {}))
    for run, label in zip(runs, labels):
        path = os.path.join(run, "device.json")
        if os.path.exists(path):
            with open(path) as f:
                devices[str(label)] = json.load(f)
    if devices:
        out["device_by_run"] = devices
    return out


def _copy(src: str, out_dir: str) -> None:
    dst = os.path.join(out_dir, os.path.basename(src))
    if os.path.exists(src) and os.path.abspath(src) != os.path.abspath(dst):
        shutil.copyfile(src, dst)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", action="append", required=True,
                    help="a run's output directory; repeatable, oldest first")
    ap.add_argument("--label", action="append", default=None,
                    help="the run's label, one a --run (default: its directory's name)")
    ap.add_argument("--out", required=True, help="directory of the consolidated artifact")
    args = ap.parse_args(argv)
    labels = args.label or [os.path.basename(os.path.normpath(r)) for r in args.run]
    if len(labels) != len(args.run):
        ap.error(f"{len(args.run)} runs but {len(labels)} labels")
    out = merge(args.run, labels)
    os.makedirs(args.out, exist_ok=True)
    summaries = [_load(run).get("query_summary", {}) for run in args.run]
    for q in out["query_summary"]:
        run = next(r for r, s in zip(reversed(args.run), reversed(summaries)) if q in s)
        _copy(os.path.join(run, f"q{q}.csv"), args.out)
    for run in reversed(args.run):
        if os.path.exists(os.path.join(run, "eligibility.json")):
            _copy(os.path.join(run, "eligibility.json"), args.out)
            break
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(out, f, indent=2, default=str)
    done = sorted(int(q) for q in out["checked"] if out["checked"][q])
    print(f"consolidated: {len(done)}/22 checked -> {done}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
