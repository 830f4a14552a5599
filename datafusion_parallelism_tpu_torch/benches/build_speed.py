"""Hash-join BUILD microbenchmark (reference benches/build_speed.rs: Size512 =
512 batches x 8192 rows, build only). Counterpart of the root
`benches/build_speed.py`.

    python -m datafusion_parallelism_tpu_torch.benches.build_speed \
        [--strategy csr|sort|oa] [--rows N] [--iters K] [--device cuda|cpu]

The JAX bench times `hash_rows` + `build_join_table` over N uniform int32
keys. Here the same build runs through the port's build stage
(`ops/join.py::_build_table`, what `prepare_build` and every join run): K1
hashes the keys and buckets them, then K2 makes the CSR table; K6 sorts the
rows by hash for SORT; K6 orders them by (home slot, hash) and K15 places
them for OA (K5 puts the row ids in table order for both). Check: the
kernel path's table equals the plain path's bit for bit.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..kernels.chain import KERNELS as CHAIN
from ..kernels.chain import PLAIN as CHAIN_PLAIN
from ..ops.hash_table import JoinStrategy, JoinTable, table_size_for
from ..ops.hashing import key_words
from ..ops.join import KERNELS, PLAIN, _build_table
from .bench_lib import check, device_of, report_stats, timeit_stats

SIZE512 = 512 * 8192
# the table fields each strategy fills
FIELDS = {JoinStrategy.CSR: ("offsets", "perm", "start_count"),
          JoinStrategy.SORT: ("perm", "sorted_hash"),
          JoinStrategy.OA: ("perm", "sorted_hash")}


def build_table(keys: torch.Tensor, strategy: JoinStrategy, kernels=KERNELS,
                chain=CHAIN) -> JoinTable:
    """The strategy's table over int32 `keys`, every row valid, through the
    kernel tables `kernels` (ops/join.py) and `chain` (kernels/chain.py)."""
    n, dev = keys.shape[0], keys.device
    words, cols = key_words([(keys, torch.ones(n, dtype=torch.bool, device=dev))])
    no_rows = torch.empty((0, n), dtype=torch.int32, device=dev)
    table, _ = _build_table(strategy, kernels, chain, words, cols, table_size_for(n),
                            torch.tensor(n, dtype=torch.int32, device=dev), None, no_rows)
    return table


def check_tables(got: JoinTable, want: JoinTable, strategy: JoinStrategy) -> None:
    for f in FIELDS[strategy]:
        check(torch.equal(getattr(got, f), getattr(want, f)),
              f"{strategy.value} build: kernel path's {f} != plain path's")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=SIZE512)
    ap.add_argument("--strategy", default="csr", choices=["csr", "sort", "oa"])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_of(args.device)

    n = args.rows
    rng = np.random.default_rng(0)
    keys = torch.from_numpy(rng.integers(0, n, n).astype(np.int32)).to(device)
    strat = JoinStrategy(args.strategy)

    check_tables(build_table(keys, strat), build_table(keys, strat, PLAIN, CHAIN_PLAIN), strat)
    stats = timeit_stats(lambda: build_table(keys, strat), device, iters=args.iters)
    return [report_stats(f"build_speed/{args.strategy}/Size512", n, stats, device,
                         {"check": "kernel == plain, bit for bit"})]


if __name__ == "__main__":
    main()
