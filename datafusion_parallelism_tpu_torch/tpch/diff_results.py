"""Diff two TPC-H result directories (q*.csv answer files).

The reference writes first-iteration result CSVs for answer checking
(reference tpc/src/main.rs:368-377); this compares two such directories —
ours vs ours across versions, or ours vs any engine emitting the same
layout — as unordered row multisets with float tolerance.

    python -m datafusion_parallelism_tpu_torch.tpch.diff_results results/a results/b

Copied from the JAX package's `tpch/diff_results.py`; `REL` and `ABS` name
its float tolerance, and `_norm` also sorts a column that holds both
numbers and text (a NULL beside numbers), where the copy raises.
"""

from __future__ import annotations

import csv
import math
import os
import sys


def _load(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _norm(rows):
    out = []
    for r in rows:
        row = []
        for k in sorted(r):
            v = r[k]
            try:
                row.append((k, round(float(v), 4)))
            except (TypeError, ValueError):
                row.append((k, v))
        out.append(tuple(row))
    # numbers before text within a column: a column holding both (a NULL,
    # written empty, beside numbers) sorts where plain tuples would raise
    return sorted(out, key=lambda row: tuple((k, not isinstance(v, float), v) for k, v in row))


REL, ABS = 1e-6, 1e-4


def _rows_match(a, b, rel=REL, abs_=ABS) -> bool:
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        for (ka, va), (kb, vb) in zip(ra, rb):
            if ka != kb:
                return False
            if isinstance(va, float) and isinstance(vb, float):
                if not math.isclose(va, vb, rel_tol=rel, abs_tol=abs_):
                    return False
            elif va != vb:
                return False
    return True


def diff_dirs(dir_a: str, dir_b: str) -> int:
    failures = 0
    queries = sorted(int(f[1:-4]) for f in os.listdir(dir_a)
                     if f.startswith("q") and f.endswith(".csv"))
    for q in queries:
        pa = os.path.join(dir_a, f"q{q}.csv")
        pb = os.path.join(dir_b, f"q{q}.csv")
        if not os.path.exists(pb):
            print(f"Q{q}: MISSING in {dir_b}")
            failures += 1
            continue
        a, b = _norm(_load(pa)), _norm(_load(pb))
        if _rows_match(a, b):
            print(f"Q{q}: MATCH ({len(a)} rows)")
        else:
            print(f"Q{q}: DIFFER ({len(a)} vs {len(b)} rows)")
            failures += 1
    return failures


if __name__ == "__main__":
    sys.exit(1 if diff_dirs(sys.argv[1], sys.argv[2]) else 0)
