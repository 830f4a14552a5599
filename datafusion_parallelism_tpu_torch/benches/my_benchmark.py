"""End-to-end four-way nested join benchmark, the reference's headline
criterion bench (reference benches/my_benchmark.rs:122-216, `Size256`).
Counterpart of the root `benches/my_benchmark.py`, whose scenario and SQL
are copied here:

  * base table: 10,000 batches x 1024 rows = 10,240,000 rows with id1..id4,
    each cycling 256 unique 1024-id blocks, id_k shifted by k so the columns
    differ; plus a constant string column.
  * four dim tables of 256 x 1024 = 262,144 rows, id shifted by the table
    number, plus a random 32-char string column (pruned by the projection).
  * query: the right-deep nested 4-join selecting the four id columns (every
    base row matches exactly once per dim table -> 10.24M output rows).

    python -m datafusion_parallelism_tpu_torch.benches.my_benchmark \
        [--base-batches 10000] [--iterations 5] [--device cuda|cpu]

The tables go through `HostTable.from_numpy`, each string column encoded
into a sorted dictionary exactly as `HostTable.from_pydict` encodes it
(whose per-value loops over 10.24 M rows would take minutes). One
`handle.run()` settles the capacities, then each timed iteration runs the
query again. The port compiles no program, so the line reports `retries`
where the JAX bench reports `compiles`. Check: the row count, and each
output id column's sum equals the base table's.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..api import SessionContext
from ..utils.columnar import STRING, Dictionary, HostTable
from .bench_lib import check, device_of, report_stats, timeit_stats

BATCHES = 256
BATCH_SIZE = 1024

SQL = """
SELECT result.id1, result.id2, result.id3, result.id4
  FROM small_table_4
  JOIN (
    SELECT result.id1, result.id2, result.id3, result.id4
    FROM small_table_3
    JOIN (
      SELECT result.id1, result.id2, result.id3, result.id4
      FROM small_table_2
      JOIN (
        SELECT base_table.id1, base_table.id2, base_table.id3, base_table.id4
        FROM small_table_1
        JOIN base_table
        ON base_table.id1 = small_table_1.id
      ) AS result
      ON result.id2 = small_table_2.id
    ) AS result
    ON result.id3 = small_table_3.id
  ) AS result
  ON result.id4 = small_table_4.id
"""


def make_tables(base_batches: int, rng):
    # base: batch i holds ids (i%256)*1024 .. +1024, column k shifted by k
    # (reference make_int_array_with_shift, api_utils.rs)
    i = np.arange(base_batches, dtype=np.int64) % BATCHES
    starts = np.repeat(i * BATCH_SIZE, BATCH_SIZE)
    offs = np.tile(np.arange(BATCH_SIZE, dtype=np.int64), base_batches)
    base_ids = (starts + offs).astype(np.int32)
    base = {f"id{k}": base_ids + k for k in range(1, 5)}
    base["note"] = ["hello"] * len(base_ids)

    dim_ids = np.arange(BATCHES * BATCH_SIZE, dtype=np.int32)
    dims = {}
    for k in range(1, 5):
        # the JAX bench's "".join over letters[draws], row by row, made in
        # one pass: each row's 32 letter bytes read as one ASCII string
        draws = rng.integers(0, 26, (len(dim_ids), 32))
        letters = (draws + ord("a")).astype(np.uint8)
        rand_str = letters.view("S32")[:, 0].astype("U32").tolist()
        dims[f"small_table_{k}"] = {"id": dim_ids + k, "payload": rand_str}
    return base, dims


def encode_strings(values: list):
    """(int32 codes, Dictionary) of a list of strings: the sorted distinct
    values and each value's index among them, as from_pydict encodes a
    string column without nulls."""
    uniq = sorted(set(values))
    index = {v: i for i, v in enumerate(uniq)}
    codes = np.fromiter(map(index.__getitem__, values), dtype=np.int32, count=len(values))
    return codes, Dictionary(np.array(uniq, dtype=object))


def host_table(data: dict) -> HostTable:
    """`data` (numpy int32 columns and lists of strings) as a HostTable,
    equal to HostTable.from_pydict(data)."""
    arrays, dtypes, dictionaries = {}, {}, {}
    for name, col in data.items():
        if isinstance(col, list):
            arrays[name], dictionaries[name] = encode_strings(col)
            dtypes[name] = STRING
        else:
            arrays[name] = col
    return HostTable.from_numpy(arrays, dtypes, dictionaries)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base-batches", type=int, default=10_000)
    ap.add_argument("--iterations", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_of(args.device)

    rng = np.random.default_rng(0)
    base, dims = make_tables(args.base_batches, rng)
    ctx = SessionContext(device=device)
    ctx.register_table("base_table", host_table(base))
    for name, data in dims.items():
        ctx.register_table(name, host_table(data))
    want = {f"id{k}": int(base[f"id{k}"].sum(dtype=np.int64)) for k in range(1, 5)}
    del base, dims

    handle = ctx.sql(SQL)
    n_base = args.base_batches * BATCH_SIZE
    out = handle.run()   # settles the capacities
    rows = int(out.num_rows)
    check(rows == n_base, f"expected {n_base} output rows, got {rows}")
    mask = out.row_mask()
    for name, total in want.items():
        v, valid = out.column(name)
        got = int(v[valid & mask].sum(dtype=torch.int64))
        check(got == total, f"sum({name}) {got} != the base table's {total}")
    del out, mask
    stats = timeit_stats(handle.run, device, warmup=0, iters=args.iterations)
    return [report_stats("my_benchmark/Size256/4way_nested_join", n_base, stats, device,
                         {"retries": handle.metrics.retries})]


if __name__ == "__main__":
    main()
