"""Per-operator roofline on the card. Counterpart of the root
`benches/roofline.py`, re-derived for the H100.

    python -m datafusion_parallelism_tpu_torch.benches.roofline \
        [--rows N] [--iters I] [--rounds R] [--out FILE] [--device cuda|cpu]

The JAX bench models each operator on a TPU v5e by its per-index gather
cost, which means nothing on Hopper. Here the six operators it names run
through the port's ops at N = 4,194,304 rows (`build_csr`, `probe_expand`,
`inner_join_13col`, `filter_compact` at 50% selectivity, `hash_aggregate`
over 64k groups with a sum and a max, `sort_table_13col`), timed by CUDA
events in interleaved rounds (each item's least median over the rounds),
and each gets two floors:

  (i) a byte bound, `bytes_of`: the bytes the operation cannot avoid over
      3.35 TB/s, counted from the work, not from any kernel, so the count
      stays the same whatever kernel implements the op. Each input column
      is read once and each output column written once. A build, a
      compaction, an aggregate and a sort can each be done in passes that
      stream, so that is all they are charged. A probe reads each probe
      row's bucket and each candidate's build row id, and the join also
      each candidate's build key and each matched row's build columns, at
      places the data decides: each such random access of 4 or 8 bytes is
      charged one 32-byte sector. The candidate and match counts are this
      run's.
 (ii) the JAX bench's primitive model (`benches/roofline.py:306-333`), its
      primitives measured on the card in the same run: `index_select`s of
      W = 1, 4 and 13 rows, the [2, 4N] descriptor gather, `scatter_add_`,
      int32 `argsort`, the 2-key stable sort and the int64 `cumsum` (these
      torch calls are yardsticks, not part of the port), each less the
      launch floor, an empty kernel built with nvcc and called through
      ctypes as the wrappers call theirs (`tools/bench_flags_hist.py`).

Check: every operator's kernel path equals its plain path word for word.
Writes JSON with the card's name and power limit to --out (default
`bench_out/roofline.json` under the repo, which git ignores; render it
into PERF.md with `roofline_report`), prints the table and one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import tempfile
from typing import Sequence

import numpy as np
import torch

from ..kernels import _build
from ..kernels.chain import KERNELS as CHAIN
from ..kernels.chain import PLAIN as CHAIN_PLAIN
from ..ops import hash_table as ht
from ..ops.aggregate import AggSpec, hash_aggregate_counted
from ..ops.join import KERNELS, PLAIN, JoinType, hash_join
from ..ops.sort import SortKey, sort_table
from ..utils.columnar import DeviceTable, HostTable, filter_rows
from .bench_lib import OUT_DIR, card, check, device_of, timeit_stats

DEFAULT_OUT = os.path.join(OUT_DIR, "roofline.json")
N = 1 << 22                 # 4,194,304 rows, the Size512 headline scenario
ITERS = 10
ROUNDS = 3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
SECTOR = 32                 # bytes a random access of 4 or 8 bytes moves
GROUPS = 1 << 16
OPS = ("build_csr", "probe_expand", "inner_join_13col", "filter_compact", "hash_aggregate",
       "sort_table_13col")
EMPTY_SRC = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int dfp_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def bytes_of(op: str, n: int, c: int, widths: Sequence[int], *, out_rows: int = 0,
             out_widths: Sequence[int] = (), probe_widths: Sequence[int] = ()) -> int:
    """The bytes `op` cannot avoid over n input rows (module docstring).

    widths: the byte widths of the input columns (for the join, the build
    side's, its key first; `probe_widths` the probe side's, its key first,
    n rows each); c: the candidates of a probe; out_rows and out_widths:
    the output's rows and column widths where they are not the input's
    (the join's out_rows are its matches, its output every input column)."""
    w = sum(widths)
    if op == "build_csr":          # hashes in; perm and the T + 2 offsets out
        return n * w + 4 * n + 4 * (ht.table_size_for(n) + 2)
    if op == "probe_expand":       # hashes in; a bucket and c perm reads; pairs out
        return n * w + SECTOR * (n + c) + 8 * c
    if op == "inner_join_13col":
        k = out_rows
        return (n * widths[0] + n * sum(probe_widths)
                + SECTOR * (n + 2 * c + k * len(widths)) + k * (w + sum(probe_widths)))
    if op == "filter_compact":     # every column in; the survivors out
        return (n + out_rows) * w
    if op == "hash_aggregate":     # the key and values in; one row a group out
        return n * w + out_rows * sum(out_widths)
    if op == "sort_table_13col":   # every column in, every column out
        return 2 * n * w
    raise ValueError(f"unknown operator {op!r}")


class Interleaved:
    """Every item timed in `rounds` interleaved passes in one process (the
    median ms of `iters` calls after a warm one, bench_lib.timeit_stats);
    each keeps its least median, so primitives and operators both get their
    best window and their ratios hold when the card's clock drifts."""

    def __init__(self, device, iters: int, rounds: int):
        self.device, self.iters, self.rounds = device, iters, rounds
        self.items = []

    def add(self, name, fn):
        self.items.append((name, fn))

    def run(self) -> dict:
        best = {}
        for _ in range(self.rounds):
            for name, fn in self.items:
                t = timeit_stats(fn, self.device, warmup=1, iters=self.iters)["median_s"] * 1e3
                best[name] = min(best.get(name, t), t)
        return best


def empty_kernel(device):
    """A callable launching an empty kernel on the device's stream (built
    here with the library's nvcc flags); on the CPU a no-op."""
    if device.type != "cuda":
        return lambda: None
    with tempfile.TemporaryDirectory() as tmp:
        src, lib = os.path.join(tmp, "empty.cu"), os.path.join(tmp, "libempty.so")
        with open(src, "w") as f:
            f.write(EMPTY_SRC)
        subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared", "-o", lib, src],
                       check=True, capture_output=True)
        fn = ctypes.CDLL(lib).dfp_empty
    fn.argtypes, fn.restype = (_build.P,), ctypes.c_int

    def launch():
        _build.check(fn(_build.stream(device)), "empty")
    return launch


def register_primitives(il: Interleaved, rng, n: int, device) -> None:
    """The JAX bench's primitives as single torch calls on the card."""
    def dev(a):
        return torch.from_numpy(a).to(device)

    idx = dev(rng.integers(0, n, n).astype(np.int64))
    ivals = dev(rng.integers(0, 1 << 30, n).astype(np.int32))
    packed13 = dev(rng.integers(0, 1 << 30, (13, n)).astype(np.int32))
    packed4 = packed13[:4]
    big2 = dev(rng.integers(0, 1 << 30, (2, 4 * n)).astype(np.int32))
    bigidx = dev(rng.integers(0, 4 * n, n).astype(np.int64))
    ones = torch.ones(n, dtype=torch.int32, device=device)
    k2 = dev(rng.integers(0, 3, n).astype(np.int64))
    v64 = dev(rng.integers(0, 1000, n).astype(np.int64))

    il.add("launch", empty_kernel(device))
    il.add("g1", lambda: ivals.index_select(0, idx))
    il.add("g4", lambda: packed4.index_select(1, idx))
    il.add("g2b", lambda: big2.index_select(1, bigidx))
    il.add("rg13", lambda: packed13.index_select(1, idx))
    il.add("sc", lambda: torch.zeros(n, dtype=torch.int32, device=device).scatter_add_(
        0, idx, ones))
    il.add("srt", lambda: torch.argsort(ivals, stable=True))
    # the two-key stable sort with the row index as payload (the exact
    # grouping sort): both keys packed into one int64, then a stable sort
    il.add("srt2", lambda: torch.sort((k2 << 32) | ivals.long(), stable=True).indices)
    il.add("cs", lambda: torch.cumsum(v64, 0))


def finish_primitives(best: dict, n: int) -> dict:
    null = best["launch"] / 1e3

    def per_index_ns(name):
        return max(best[name] / 1e3 - null, 1e-12) / n * 1e9

    return {
        "launch_s": null,
        "gather_ns": per_index_ns("g1"),
        "gather4_ns": per_index_ns("g4"),
        "gather2big_ns": per_index_ns("g2b"),
        "rowgather13_ns": per_index_ns("rg13"),
        "scatter_ns": per_index_ns("sc"),
        "sort_s": max(best["srt"] / 1e3 - null, 1e-12),
        "sort2key_s": max(best["srt2"] / 1e3 - null, 1e-12),
        "cumsum_s": max(best["cs"] / 1e3 - null, 1e-12),
    }


def model_s(op: str, prim: dict, n: int, c: int) -> float:
    """The JAX bench's model of `op` (benches/roofline.py:306-333) in
    seconds, from this run's primitives, with c this run's candidates."""
    g = prim["gather_ns"] * 1e-9
    g4 = prim["gather4_ns"] * 1e-9
    g2b = prim["gather2big_ns"] * 1e-9
    rg = prim["rowgather13_ns"] * 1e-9
    sc = prim["scatter_ns"] * 1e-9
    srt, srt2, cs = prim["sort_s"], prim["sort2key_s"], prim["cumsum_s"]
    return {
        "build_csr": sc * n + srt,
        "probe_expand": g2b * n + cs + sc * n + 2 * g * c,
        "inner_join_13col": ((sc * n + srt) + g2b * n + g4 * n + (sc * n + g4 * c) + g4 * c
                             + (srt * c / n + g4 * c) + (rg * c + g4 * c)),
        "filter_compact": srt + rg * n,
        "hash_aggregate": srt2 + srt + g4 * n + 3 * cs,
        "sort_table_13col": srt + rg * n,
    }[op]


def make_inputs(n: int, device, seed: int = 1) -> dict:
    """The operators' inputs in the JAX bench's shapes, distributions and
    order of draws, from a generator of their own."""
    rng = np.random.default_rng(seed)
    bk = rng.integers(0, n, n).astype(np.int32)
    pk = rng.integers(0, n, n).astype(np.int32)
    cols = {f"c{j}": rng.integers(0, 1 << 30, n).astype(np.int32) for j in range(12)}
    pv = rng.random(n).astype(np.float32)
    bh = rng.integers(0, 1 << 31, n).astype(np.int32)
    ph = rng.integers(0, 1 << 31, n).astype(np.int32)
    gk = rng.integers(0, GROUPS, n).astype(np.int32)
    y = rng.random(n).astype(np.float32)
    return {
        "build": HostTable.from_numpy({"b_key": bk, **cols}).to_device(device=device),
        "probe": HostTable.from_numpy({"p_key": pk, "p_val": pv}).to_device(device=device),
        "bh": torch.from_numpy(bh).to(device), "ph": torch.from_numpy(ph).to(device),
        "agg": HostTable.from_numpy({"g": gk, "x": cols["c0"], "y": y}).to_device(
            device=device),
    }


def operators(inp: dict, n: int, plain: bool = False) -> dict:
    """op -> callable running it through the port's ops (the kernels, or
    with `plain` their plain versions). probe_expand returns the candidate
    total and the sum of the candidates' build row ids (int64 0-dim each),
    the join its table and candidate total, the others their output."""
    kernels, chain = (PLAIN, CHAIN_PLAIN) if plain else (KERNELS, CHAIN)
    device = inp["bh"].device
    ones = torch.ones(n, dtype=torch.bool, device=device)
    out_cap = n + n // 2
    build, probe, agg = inp["build"], inp["probe"], inp["agg"]
    T = ht.table_size_for(n)
    table = ht.build_csr(inp["bh"], ones, n, kernels.csr_build)

    def f_build():
        return ht.build_csr(inp["bh"], ones, n, kernels.csr_build)

    def f_probe():
        ph = inp["ph"]
        start, count, base, total = ht.table_ranges(table, ph, ht.slot_of(ph, T), ones,
                                                    kernels.probe_ranges)
        _, _, bid = kernels.expand_ranges(start, count, base, total, ph[None],
                                          table.perm[None], [], out_cap)
        return total.to(torch.int64), bid.sum(dtype=torch.int64)

    def f_join():
        return hash_join(build, probe, ["b_key"], ["p_key"], JoinType.INNER, out_cap,
                         kernels=kernels, chain=chain)

    def f_filter():
        mask = (build.column("c0")[0] & 1) == 0
        return filter_rows(build, mask & build.row_mask(), chain)

    def f_agg():
        return hash_aggregate_counted(agg, ["g"], [AggSpec("sum", "x", "sx"),
                                                   AggSpec("max", "y", "my")],
                                      1 << 17, None, chain)[0]

    def f_sort():
        return sort_table(build, [SortKey("b_key", True)], chain)

    return dict(zip(OPS, (f_build, f_probe, f_join, f_filter, f_agg, f_sort)))


def _words(x) -> list:
    """An operator's output as a list of tensors, compared word for word."""
    if isinstance(x, DeviceTable):
        return [x.num_rows] + [t for name in x.schema.names for t in x.column(name)]
    if isinstance(x, ht.JoinTable):
        return [x.offsets, x.perm, x.start_count]
    if isinstance(x, tuple):
        return [t for part in x for t in _words(part)]
    return [x]


def check_plain(inp: dict, n: int) -> dict:
    """Each operator's kernel path == its plain path word for word; returns
    this run's counts: candidates, matches, survivors, groups."""
    got, want = operators(inp, n), operators(inp, n, plain=True)
    counts = {}
    for op in OPS:
        a, b = got[op](), want[op]()
        wa, wb = _words(a), _words(b)
        check(len(wa) == len(wb) and all(torch.equal(x, y) for x, y in zip(wa, wb)),
              f"{op}: kernel path != plain path")
        if op == "inner_join_13col":
            counts["candidates"] = int(a[1])
            counts["matches"] = int(a[0].num_rows)
        elif op == "filter_compact":
            counts["survivors"] = int(a.num_rows)
        elif op == "hash_aggregate":
            counts["groups"] = int(a.num_rows)
    return counts


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=N)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_of(args.device)
    n = args.rows

    rng = np.random.default_rng(0)
    il = Interleaved(device, args.iters, args.rounds)
    register_primitives(il, rng, n, device)
    inp = make_inputs(n, device)
    counts = check_plain(inp, n)
    for op, fn in operators(inp, n).items():
        il.add(op, fn)
    best = il.run()
    prim = finish_primitives(best, n)

    c = counts["candidates"]
    widths13 = (4,) * 13
    nbytes = {
        "build_csr": bytes_of("build_csr", n, 0, (4,)),
        "probe_expand": bytes_of("probe_expand", n, c, (4,)),
        "inner_join_13col": bytes_of("inner_join_13col", n, c, widths13,
                                     out_rows=counts["matches"], probe_widths=(4, 4)),
        "filter_compact": bytes_of("filter_compact", n, 0, widths13,
                                   out_rows=counts["survivors"]),
        "hash_aggregate": bytes_of("hash_aggregate", n, 0, (4, 4, 4),
                                   out_rows=counts["groups"], out_widths=(4, 8, 4)),
        "sort_table_13col": bytes_of("sort_table_13col", n, 0, widths13),
    }
    rows = []
    for op in OPS:
        measured = best[op]
        bound = nbytes[op] / HBM_BYTES_PER_S * 1e3
        model = model_s(op, prim, n, c) * 1e3
        rows.append({"op": op, "measured_ms": measured, "bytes": nbytes[op],
                     "byte_bound_ms": bound, "model_ms": model,
                     "ratio_bound": measured / bound, "ratio_model": measured / model})
    art = {"rows": n, **card(device), "rounds": args.rounds, "iters": args.iters,
           "timer": "cuda_events" if device.type == "cuda" else "wall", **counts,
           "primitives": prim, "operators": rows}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(art, f, indent=2)

    print(f"primitives: launch {prim['launch_s'] * 1e3:.4f} ms, gather "
          f"{prim['gather_ns']:.4f} ns/idx, gather4 {prim['gather4_ns']:.4f}, gather2big "
          f"{prim['gather2big_ns']:.4f}, rowgather13 {prim['rowgather13_ns']:.4f} ns/row, "
          f"scatter {prim['scatter_ns']:.4f} ns/idx, argsort {prim['sort_s'] * 1e3:.4f} ms, "
          f"2-key sort {prim['sort2key_s'] * 1e3:.4f} ms, cumsum {prim['cumsum_s'] * 1e3:.4f} ms",
          flush=True)
    for line in table_lines(rows):
        print(line, flush=True)
    worst = max(rows, key=lambda r: r["ratio_bound"])
    line = {"bench": "roofline", "rows": n, "worst_op": worst["op"],
            "worst_ratio": round(worst["ratio_bound"], 3),
            "ratios": {r["op"]: round(r["ratio_bound"], 3) for r in rows},
            "model_ratios": {r["op"]: round(r["ratio_model"], 3) for r in rows},
            "out": args.out, **card(device)}
    print(json.dumps(line), flush=True)
    return art


def table_lines(rows) -> list:
    """The operator table: measured ms, both floors and both ratios."""
    lines = [f"{'op':18s} {'measured ms':>12s} {'byte bound ms':>14s} {'model ms':>10s} "
             f"{'x bound':>8s} {'x model':>8s}"]
    for r in rows:
        lines.append(f"{r['op']:18s} {r['measured_ms']:12.4f} {r['byte_bound_ms']:14.4f} "
                     f"{r['model_ms']:10.4f} {r['ratio_bound']:8.2f} {r['ratio_model']:8.2f}")
    return lines


if __name__ == "__main__":
    main()
