"""Hash-join PROBE microbenchmark over a pre-built table (reference
benches/lookup_speed.rs Size512). Counterpart of the root
`benches/lookup_speed.py`.

    python -m datafusion_parallelism_tpu_torch.benches.lookup_speed \
        [--strategy csr|sort|oa] [--rows N] [--iters K] [--device cuda|cpu]

The JAX bench composes `probe_candidates`, a standalone
`replicate_rows_exact` and a `take` of the table's perm. The port has no
standalone replication (its only callers were K3's and K9's bodies), so
the counterpart is the port's probe stage (`ops/join.py::_probe_table`):
K1 hashes the probe keys, then the candidate ranges come from K3's first
pass (CSR), K14 (SORT) or K16 (OA), and K3's second pass expands them
into candidate slots and reads each candidate's build row id from the
perm (no key recheck, as in the JAX bench). Each call gives the JAX
bench's number, the candidate total plus the sum of the candidates' build
indices (in int64 here; the JAX bench sums in int32, which wraps at
Size512). Check: the kernel path's number equals the plain path's.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..kernels.chain import PLAIN as CHAIN_PLAIN
from ..ops.hash_table import JoinStrategy, JoinTable, table_size_for
from ..ops.hashing import key_words
from ..ops.join import KERNELS, PLAIN, _probe_table
from .bench_lib import check, device_of, report_stats, timeit_stats
from .build_speed import SIZE512, build_table


def probe(table: JoinTable, pkeys: torch.Tensor, n_build: int, out_cap: int,
          kernels=KERNELS) -> torch.Tensor:
    """int64 0-dim: candidate total + sum of the candidates' build row ids
    of every probe row of `pkeys` (all valid) against `table`."""
    m, dev = pkeys.shape[0], pkeys.device
    ok = torch.ones(m, dtype=torch.bool, device=dev)
    words, cols = key_words([(pkeys, ok)])
    start, count, base, total = _probe_table(table, kernels, words, cols,
                                             table_size_for(n_build), ok)
    _, _, build_id = kernels.expand_ranges(start, count, base, total, words, table.perm[None],
                                           [], out_cap)
    # build_id is 0 past the total
    return total.to(torch.int64) + build_id.sum(dtype=torch.int64)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=SIZE512)
    ap.add_argument("--strategy", default="csr", choices=["csr", "sort", "oa"])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_of(args.device)

    n = args.rows
    out_cap = 2 * n
    rng = np.random.default_rng(0)
    bkeys = torch.from_numpy(rng.integers(0, n, n).astype(np.int32)).to(device)
    pkeys = torch.from_numpy(rng.integers(0, n, n).astype(np.int32)).to(device)
    strat = JoinStrategy(args.strategy)

    table = build_table(bkeys, strat)
    got = int(probe(table, pkeys, n, out_cap))
    want = int(probe(build_table(bkeys, strat, PLAIN, CHAIN_PLAIN), pkeys, n, out_cap, PLAIN))
    check(got == want, f"{args.strategy} lookup: kernel path {got} != plain path {want}")
    stats = timeit_stats(lambda: probe(table, pkeys, n, out_cap), device, iters=args.iters)
    return [report_stats(f"lookup_speed/{args.strategy}/Size512", n, stats, device,
                         {"answer": got, "check": "kernel == plain"})]


if __name__ == "__main__":
    main()
