"""Sort carriage study (reference benches/sort.rs:337-416). Counterpart of
the root `benches/sort_bench.py`, whose contenders were TPU choices (a
multi-operand `lax.sort` against an argsort and one packed row gather).
On Hopper the question is how the payload columns ride the permutation:

    python -m datafusion_parallelism_tpu_torch.benches.sort_bench \
        [--rows N] [--cols K] [--iters I] [--device cuda|cpu]

  * `k6_perm`: the K6 permutation of the int32 key alone, the part every
    contender below but the library one shares;
  * `k6_column_gather`: the K6 permutation, then one K5 row gather a
    column (the key and each payload column, [1, N] each);
  * `k6_packed_gather`: the K6 permutation, then K12 packs the table
    (`pack_table`), one K5 gather of the packed [W, N] rows and K12's
    unpack (`unpack_table`): the carriage `ops/sort.py::sort_table` uses;
  * `torch_sort_index_select`: the library yardstick, `torch.sort(stable=
    True)` and one `index_select` a column. It is not part of the port.

Check: every contender's key and payload columns equal numpy's
`argsort(kind="stable")` gather.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..kernels import filter_compact as k5
from ..kernels import radix_sort as k6
from ..utils.columnar import HostTable, pack_table, unpack_table
from .bench_lib import check, device_of, report_stats, timeit_stats


def make_columns(rows: int, cols: int):
    """(key, [payload]) int32 numpy arrays: the JAX bench's draws from seed 0."""
    rng = np.random.default_rng(0)
    key = rng.integers(0, rows, rows).astype(np.int32)
    return key, [rng.integers(0, 1000, rows).astype(np.int32) for _ in range(cols)]


def contenders(key: torch.Tensor, payload: list):
    """name -> callable returning the sorted [key] + payload columns (the
    perm alone for k6_perm)."""
    n, dev = key.shape[0], key.device
    columns = [key] + payload
    names = ["key"] + [f"p{j}" for j in range(len(payload))]
    table = HostTable.from_numpy({name: c.cpu().numpy() for name, c in zip(names, columns)}
                                 ).to_device(n, device=dev)
    no_f64 = torch.empty((0, n), dtype=torch.float64, device=dev)

    def perm():
        return k6.radix_sort(key[None], [True])

    def column_gather():
        p = perm()
        return [k5.gather_rows(c[None], no_f64, p)[0][0] for c in columns]

    def packed_gather():
        out = unpack_table(pack_table(table).take_rows(perm()), table.schema, n)
        return [out.column(name)[0] for name in names]

    def library():
        p = torch.sort(key, stable=True).indices
        return [c.index_select(0, p) for c in columns]

    return {"k6_perm": perm, "k6_column_gather": column_gather,
            "k6_packed_gather": packed_gather, "torch_sort_index_select": library}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 22)
    ap.add_argument("--cols", type=int, default=6)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_of(args.device)

    n, k = args.rows, args.cols
    key_np, payload_np = make_columns(n, k)
    order = np.argsort(key_np, kind="stable")
    want = [c[order] for c in [key_np] + payload_np]
    key = torch.from_numpy(key_np).to(device)
    payload = [torch.from_numpy(p).to(device) for p in payload_np]

    out = []
    for name, fn in contenders(key, payload).items():
        got = fn()
        if name == "k6_perm":
            check(np.array_equal(got.cpu().numpy(), order), "K6's perm != numpy's stable argsort")
        else:
            for j, (g, w) in enumerate(zip(got, want)):
                check(np.array_equal(g.cpu().numpy(), w),
                      f"{name}: column {j} != numpy's stable argsort gather")
        stats = timeit_stats(fn, device, warmup=1, iters=args.iters)
        out.append(report_stats(f"sort/{name}/{k}cols", n, stats, device))
    return out


if __name__ == "__main__":
    main()
