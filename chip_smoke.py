#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives `datafusion_parallelism_tpu_torch`'s two main paths through their
eight hand-written CUDA kernels and holds every result against the plain
torch versions: the single-device INNER CSR hash join (K1-K4) and the
single-table chain filter -> project -> hash aggregate -> sort -> limit
(K5-K8, with K1 for multi-column group keys). Phases, one line each:

  1. build the kernels with nvcc; print the card's name and power limit
  2. K1-K4 against their plain versions on the card, exact, on seeded
     inputs (nulls, negative int64, a two-column key, padding, a hot key,
     no match, an overflowing out_cap, float keys, a non-power-of-two
     table size) and at the Size512 join's shapes,
     where each kernel is also timed against its plain version
  3. the `entry()` twin on the card against the same step on the CPU
  4. Size512 (4,194,304 build and probe rows): kernel path == plain path
     word for word, match count == a numpy count, rows/s of both paths
  5. a TPC-H SF10-shaped orders x lineitem join on an int64 key, run ->
     check overflow -> grow -> rerun, kernel path == plain path
  6. every kernel of the join launched during phases 3-5
  7. K1-K4 against their plain versions at the SF10-shaped join's shapes,
     exact, and timed
  8. K5-K8 against their plain versions on seeded inputs through the
     operators (nulls in keys and values, every row filtered out, one
     group holding every row, an overflowing out_cap, -0.0 and NaN sort
     keys, int64 extremes, G = 1 and G = 64); K7 timed on 16,777,216
     sorted rows in one group beside the same rows over uniform keys
  9. the reference roofline harness's three single-table operations at
     4,194,304 rows (filter_compact, hash_aggregate, sort_table_13col):
     kernel path == plain path, each kernel's ms against its plain ms
 10. TPC-H lineitem from the copied generator at SF10 (about 60 M rows at
     capacity 67,108,864): Q1, Q6 and Q18- and Q20-shaped chains run as
     models/physical.py runs them, checked against the copied numpy
     oracle (Q1, Q6) or an independent numpy computation, and against the
     plain path; ms, rows/s and peak memory of each chain
 11. every kernel of the chain launched during phase 10's first runs
 12. K5-K8 against their plain versions at the shapes phase 10 gave them,
     and timed

Exact means bit for bit, except float64 sums (and the averages built on
them), which K7 and K8 add in another order than the plain versions:
those agree within rtol 1e-9 + 1e-12 * sum|x| (a chain's outputs within
rtol 1e-9).

The last line is {"ok": true, "device": {...}}, printed only when every
phase passed; the line before it lists the kernels with their launches,
errors and times. Without a CUDA device the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np

SIZE512 = 512 * 8192                  # bench.py's N_ROWS
SIZE512_OUT_CAP = SIZE512 + SIZE512 // 2
SF10_ORDERS = 15_000_000
SEED_CAP_CEILING = 1 << 25            # models/physical.py's seed-capacity ceiling
TIMING_ITERS = 20
FLOAT_SUM_RTOL = 1e-5                 # float32 sums in another reduction order

KERNEL_INFO = {
    # name: (source, the JAX function it replaces)
    "hash_slot": ("datafusion_parallelism_tpu_torch/csrc/hash_slot.cu",
                  "datafusion_parallelism_tpu/ops/hashing.py:70"),
    "csr_build": ("datafusion_parallelism_tpu_torch/csrc/csr_build.cu",
                  "datafusion_parallelism_tpu/ops/hash_table.py:110"),
    "probe_expand": ("datafusion_parallelism_tpu_torch/csrc/probe_expand.cu",
                     "datafusion_parallelism_tpu/ops/join.py:277"),
    "compact_gather": ("datafusion_parallelism_tpu_torch/csrc/compact_gather.cu",
                       "datafusion_parallelism_tpu/ops/join.py:393"),
    "filter_compact": ("datafusion_parallelism_tpu_torch/csrc/filter_compact.cu",
                       "datafusion_parallelism_tpu/utils/columnar.py:418"),
    "radix_sort": ("datafusion_parallelism_tpu_torch/csrc/radix_sort.cu",
                   "datafusion_parallelism_tpu/ops/sort.py:31"),
    "segment_agg": ("datafusion_parallelism_tpu_torch/csrc/segment_agg.cu",
                    "datafusion_parallelism_tpu/ops/aggregate.py:338"),
    "direct_agg": ("datafusion_parallelism_tpu_torch/csrc/direct_agg.cu",
                   "datafusion_parallelism_tpu/ops/aggregate.py:108"),
}
AGG_KERNELS = ("filter_compact", "radix_sort", "segment_agg", "direct_agg")   # K5-K8
ROOFLINE_N = 4_194_304                # benches/roofline.py's N
K7_ROWS = 16_777_216
TPCH_SF = 10
LINEITEM_CAP = 67_108_864


def log(msg: str) -> None:
    print(msg, flush=True)


def _flat(x):
    if isinstance(x, (tuple, list)):
        for y in x:
            yield from _flat(y)
    elif x is not None:
        yield x


def max_abs_err(got, want) -> float:
    """Max |got - want| over every tensor of two results; raises unless they
    are equal bit for bit (floats compared as their bits)."""
    import torch
    worst = 0.0
    for a, b in zip(_flat(got), _flat(want), strict=True):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"shape/dtype {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
        if a.numel() == 0:
            continue
        if a.is_floating_point():
            worst = max(worst, float((a - b).abs().max()))
            bits = torch.int64 if a.dtype == torch.float64 else torch.int32
            same = torch.equal(a.view(bits), b.view(bits))
        else:
            worst = max(worst, float((a.long() - b.long()).abs().max()))
            same = torch.equal(a, b)
        if not same:
            raise AssertionError(f"kernel and plain differ: max abs err {worst}")
    return worst


class Checked:
    """Stage functions that run the kernel AND its plain version on the same
    inputs, require equal results, and record each call's arguments."""

    def __init__(self):
        from datafusion_parallelism_tpu_torch.ops.join import KERNELS, PLAIN, JoinKernels
        self.calls = {name: [] for name in JoinKernels._fields}
        self.err = {name: 0.0 for name in JoinKernels._fields}

        def stage(name, kernel, plain):
            def run(*args):
                got = kernel(*args)
                self.err[name] = max(self.err[name], max_abs_err(got, plain(*args)))
                self.calls[name].append(args)
                return got
            return run

        self.stages = JoinKernels(*(stage(n, k, p) for n, k, p in
                                    zip(JoinKernels._fields, KERNELS, PLAIN)))


def tables_equal(a, b) -> None:
    """Two join outputs equal word for word: num_rows, every column's
    values (as bits) and validity over the whole capacity."""
    import torch
    if int(a.num_rows) != int(b.num_rows) or a.schema.names != b.schema.names:
        raise AssertionError(f"rows {int(a.num_rows)} vs {int(b.num_rows)}")
    for name in a.schema.names:
        (va, ma), (vb, mb) = a.column(name), b.column(name)
        if va.is_floating_point():
            bits = torch.int64 if va.dtype == torch.float64 else torch.int32
            va, vb = va.view(bits), vb.view(bits)
        if not (torch.equal(va, vb) and torch.equal(ma, mb)):
            raise AssertionError(f"column {name} differs")


def cuda_ms(fn, *args, reps: int = 10) -> float:
    """Median device time of fn(*args) by CUDA events, after one warm-up."""
    import torch
    fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_s(fn, iters: int) -> float:
    """Median seconds of fn() followed by a synchronize, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build() -> str:
    from datafusion_parallelism_tpu_torch.kernels import _build
    seconds = _build.build()
    _build.library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"phase 1 ok: kernels built in {seconds:.1f} s; card: {smi}")
    return smi


def _seeded_cases(rng, n, device):
    """(name, build, probe, build_keys, probe_keys, out_cap, overflows,
    matches) on the device: `overflows` says whether the candidate total
    exceeds out_cap, `matches` whether any row matches."""
    from datafusion_parallelism_tpu_torch.utils.columnar import HostTable
    cases = []
    keys = rng.integers(0, n // 2, n).astype(np.int32)
    nulls = rng.random(n) < 0.10
    b = HostTable.from_numpy({"bk": keys, "bv": rng.random(n)},
                             validity={"bk": ~nulls})
    p = HostTable.from_numpy({"pk": rng.integers(0, n // 2, n).astype(np.int32),
                              "pv": rng.random(n).astype(np.float32)},
                             validity={"pk": rng.random(n) >= 0.10})
    # padded to twice its rows
    cases.append(("int32 key, 10% nulls, padded 2x", b.to_device(2 * n, device=device),
                  p.to_device(device=device), ["bk"], ["pk"], 4 * n, False, True))
    neg = rng.integers(-(1 << 40), 1 << 40, n // 4)
    b = HostTable.from_numpy({"bk": rng.choice(neg, n), "bv": rng.integers(0, 9, n)})
    p = HostTable.from_numpy({"pk": rng.choice(neg, n), "pv": rng.random(n)})
    cases.append(("negative int64 key", b.to_device(device=device),
                  p.to_device(device=device), ["bk"], ["pk"], 8 * n, False, True))
    b = HostTable.from_numpy({"b1": rng.integers(0, 4096, n).astype(np.int32),
                              "b2": rng.integers(-64, 64, n), "bv": rng.random(n)})
    p = HostTable.from_numpy({"p1": rng.integers(0, 4096, n).astype(np.int32),
                              "p2": rng.integers(-64, 64, n)})
    cases.append(("two-column key", b.to_device(device=device), p.to_device(device=device),
                  ["b1", "b2"], ["p1", "p2"], 8 * n, False, True))
    hot = rng.integers(0, n, n).astype(np.int32)
    hot[rng.random(n) < 0.30] = 7
    b = HostTable.from_numpy({"bk": hot, "bv": rng.random(n).astype(np.float32)})
    pk = rng.integers(0, n, n // 64).astype(np.int32)
    pk[:8] = 7  # each owns every hot build row as a candidate
    p = HostTable.from_numpy({"pk": pk})
    cases.append(("hot key, 30% of the build rows", b.to_device(device=device),
                  p.to_device(device=device), ["bk"], ["pk"], 16 * n, False, True))
    b = HostTable.from_numpy({"bk": rng.integers(0, n, n).astype(np.int32)})
    p = HostTable.from_numpy({"pk": rng.integers(n, 2 * n, n).astype(np.int32)})
    cases.append(("no key in common", b.to_device(device=device), p.to_device(device=device),
                  ["bk"], ["pk"], n, False, False))
    b = HostTable.from_numpy({"bk": rng.integers(0, 64, n).astype(np.int32)})
    p = HostTable.from_numpy({"pk": rng.integers(0, 64, n // 16).astype(np.int32)})
    cases.append(("out_cap below the candidate total", b.to_device(device=device),
                  p.to_device(device=device), ["bk"], ["pk"], n, True, True))
    return cases


def phase_kernels_vs_plain(device, n: int = 1 << 18) -> None:
    import torch
    from datafusion_parallelism_tpu_torch.kernels import csr_build as k2
    from datafusion_parallelism_tpu_torch.kernels import hash_slot as k1
    from datafusion_parallelism_tpu_torch.ops.hashing import key_words
    from datafusion_parallelism_tpu_torch.ops.join import inner_csr_join

    rng = np.random.default_rng(1)
    names = []
    for name, b, p, bk, pk, out_cap, overflows, matches in _seeded_cases(rng, n, device):
        checked = Checked()
        out, total = inner_csr_join(b, p, bk, pk, out_cap, checked.stages)
        if (int(total) > out_cap) != overflows or (int(out.num_rows) > 0) != matches:
            raise AssertionError(f"{name}: candidate total {int(total)}, out_cap {out_cap}, "
                                 f"{int(out.num_rows)} rows")
        names.append(name)
    # float keys (K1 only: the join takes them on another path) with ±0.0
    f = torch.from_numpy(np.where(rng.random(n) < 0.2, -0.0, rng.normal(size=n))).to(device)
    cols = [(f.to(torch.float32), torch.ones(n, dtype=torch.bool, device=device)),
            (f, torch.from_numpy(rng.random(n) >= 0.1).to(device))]
    args = key_words(cols)   # (words, key columns)
    max_abs_err(k1.hash_slot(*args, 1 << 20), k1.hash_slot_plain(*args, 1 << 20))
    # a table size that is not a power of two (Lemire reduction)
    T = 3 * (1 << 20) + 7
    num_rows = torch.tensor(n - 5, dtype=torch.int32, device=device)
    _, slot = k1.hash_slot(*args, T, num_rows)
    max_abs_err(slot, k1.hash_slot_plain(*args, T, num_rows)[1])
    rows = torch.from_numpy(rng.integers(-9, 9, (2, n)).astype(np.int32)).to(device)
    max_abs_err(k2.csr_build(slot, T, rows), k2.csr_build_plain(slot, T, rows))
    log(f"phase 2a ok: K1-K4 == plain, exact, on {n}-row inputs: " + "; ".join(names)
        + "; float32/float64 keys with -0.0; non-pow2 T")


def phase_size512_kernels(device):
    """K1-K4 vs plain at the Size512 join's shapes, exact, and timed."""
    from datafusion_parallelism_tpu_torch.entry import make_tables
    from datafusion_parallelism_tpu_torch.ops.join import KERNELS, PLAIN, inner_csr_join
    build, probe = make_tables(np.random.default_rng(0), SIZE512, SIZE512, SIZE512,
                               device=device)
    checked = Checked()
    inner_csr_join(build, probe, ["b_key"], ["p_key"], SIZE512_OUT_CAP, checked.stages)
    timing = {}
    for i, name in enumerate(checked.calls):
        ms = sum(cuda_ms(KERNELS[i], *args) for args in checked.calls[name])
        plain_ms = sum(cuda_ms(PLAIN[i], *args) for args in checked.calls[name])
        timing[name] = (ms, plain_ms)
    log("phase 2b ok: K1-K4 == plain at the Size512 shapes; ms kernel/plain per join: "
        + ", ".join(f"{k} {a:.3f}/{b:.3f}" for k, (a, b) in timing.items()))
    return checked.err, timing


def phase_entry(device) -> None:
    import torch
    from datafusion_parallelism_tpu_torch.entry import entry
    step, args = entry(device)
    s, total = step(*args)
    torch.cuda.synchronize()
    cstep, cargs = entry("cpu")
    cs, ctotal = cstep(*cargs)
    if int(total) != int(ctotal):
        raise AssertionError(f"entry total {int(total)} vs cpu {int(ctotal)}")
    if not np.isclose(float(s), float(cs), rtol=FLOAT_SUM_RTOL, atol=0):
        raise AssertionError(f"entry sum {float(s)} vs cpu {float(cs)}")
    log(f"phase 3 ok: entry() on the card: sum {float(s)!r} total {int(total)}; "
        f"CPU: sum {float(cs)!r} total {int(ctotal)}")


def phase_size512(device) -> dict:
    from datafusion_parallelism_tpu_torch.entry import make_tables
    from datafusion_parallelism_tpu_torch.ops.join import (PLAIN, JoinType, hash_join,
                                                           inner_csr_join)
    rng = np.random.default_rng(0)
    build, probe = make_tables(rng, SIZE512, SIZE512, SIZE512, device=device)
    bk = build.column("b_key")[0].cpu().numpy()
    pk = probe.column("p_key")[0].cpu().numpy()
    expected = int(np.bincount(bk, minlength=SIZE512)[pk].sum())

    def kernel_path():
        return hash_join(build, probe, ["b_key"], ["p_key"], JoinType.INNER, SIZE512_OUT_CAP)

    def plain_path():
        return inner_csr_join(build, probe, ["b_key"], ["p_key"], SIZE512_OUT_CAP, PLAIN)

    out, total = kernel_path()
    ref, ref_total = plain_path()
    if int(total) > SIZE512_OUT_CAP or int(total) != int(ref_total):
        raise AssertionError(f"total {int(total)} (plain {int(ref_total)}), "
                             f"out_cap {SIZE512_OUT_CAP}")
    tables_equal(out, ref)
    if int(out.num_rows) != expected:
        raise AssertionError(f"{int(out.num_rows)} matches, numpy counts {expected}")
    t_kernel = wall_s(kernel_path, TIMING_ITERS)
    t_plain = wall_s(plain_path, TIMING_ITERS)
    res = {"matches": expected, "total": int(total), "kernel_s": t_kernel, "plain_s": t_plain,
           "kernel_rows_per_s": 2 * SIZE512 / t_kernel, "plain_rows_per_s": 2 * SIZE512 / t_plain}
    log(f"phase 4 ok: Size512 kernel == plain word for word, {expected} matches, "
        f"total {int(total)} <= {SIZE512_OUT_CAP}; median of {TIMING_ITERS}: kernel path "
        f"{t_kernel * 1e3:.3f} ms = {res['kernel_rows_per_s']:.1f} rows/s, plain path "
        f"{t_plain * 1e3:.3f} ms = {res['plain_rows_per_s']:.1f} rows/s")
    return res


def sf10_tables(rng, device):
    """orders (o_orderkey int64 in dbgen's sparse pattern, o_custkey int32,
    o_totalprice DECIMAL(2)) and lineitem (1-7 lines per order: l_orderkey
    int64, l_linenumber int32, l_extendedprice float64)."""
    from datafusion_parallelism_tpu_torch.utils.columnar import DECIMAL, HostTable
    i = np.arange(SF10_ORDERS, dtype=np.int64)
    o_orderkey = (i // 8) * 32 + i % 8 + 1
    o_totalprice = rng.integers(85_000, 55_000_000, SF10_ORDERS)
    lines = rng.integers(1, 8, SF10_ORDERS)
    n_lines = int(lines.sum())
    first = np.repeat(np.cumsum(lines) - lines, lines)
    orders = HostTable.from_numpy(
        {"o_orderkey": o_orderkey,
         "o_custkey": rng.integers(1, 1_500_001, SF10_ORDERS).astype(np.int32),
         "o_totalprice": o_totalprice},
        dtypes={"o_totalprice": DECIMAL(2)})
    lineitem = HostTable.from_numpy(
        {"l_orderkey": np.repeat(o_orderkey, lines),
         "l_linenumber": (np.arange(n_lines) - first + 1).astype(np.int32),
         "l_extendedprice": rng.random(n_lines) * 100_000.0})
    expected_price = int((o_totalprice * lines).sum())
    return (orders.to_device(device=device), lineitem.to_device(device=device),
            n_lines, expected_price)


def phase_sf10(device):
    import torch
    from datafusion_parallelism_tpu_torch.ops.join import (PLAIN, JoinType, hash_join,
                                                           inner_csr_join)
    from datafusion_parallelism_tpu_torch.utils.columnar import round_capacity
    orders, lineitem, n_lines, expected_price = sf10_tables(np.random.default_rng(10),
                                                            device)
    keys = (["o_orderkey"], ["l_orderkey"])
    # models/physical.py:247's seed capacity, runtime/executor.py:419-428's grow
    out_cap = min(max(256, orders.capacity, lineitem.capacity), SEED_CAP_CEILING)
    seed_cap, retries = out_cap, 0
    while True:
        out, total = hash_join(orders, lineitem, *keys, JoinType.INNER, out_cap)
        total = int(total)
        if total <= out_cap:
            break
        out_cap = round_capacity(max(total, 1), minimum=1024)
        retries += 1
    if retries < 1:
        raise AssertionError(f"seed capacity {seed_cap} did not overflow (total {total})")
    n = int(out.num_rows)
    price = int(out.column("o_totalprice")[0][:n].sum())
    if n != n_lines or price != expected_price:
        raise AssertionError(f"{n} rows (expected {n_lines}), price sum {price} "
                             f"(expected {expected_price})")
    del out

    def kernel_path():
        return hash_join(orders, lineitem, *keys, JoinType.INNER, out_cap)

    torch.cuda.reset_peak_memory_stats(device)
    t_kernel = wall_s(kernel_path, 3)
    peak = torch.cuda.max_memory_allocated(device)
    out, _ = kernel_path()
    ref, ref_total = inner_csr_join(orders, lineitem, *keys, out_cap, PLAIN)
    if int(ref_total) != total:
        raise AssertionError(f"plain total {int(ref_total)} vs {total}")
    tables_equal(out, ref)
    del out, ref
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inner_csr_join(orders, lineitem, *keys, out_cap, PLAIN)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    rows = orders.num_rows.item() + lineitem.num_rows.item()
    res = {"orders": SF10_ORDERS, "lineitem": n_lines, "seed_cap": seed_cap, "retries": retries,
           "out_cap": out_cap, "total": total, "kernel_s": t_kernel, "plain_s": t_plain,
           "kernel_rows_per_s": rows / t_kernel, "plain_rows_per_s": rows / t_plain,
           "peak_bytes": peak}
    log(f"phase 5 ok: SF10-shaped orders x lineitem ({SF10_ORDERS} x {n_lines} rows): seed "
        f"out_cap {seed_cap} overflowed (total {total}); {retries} grow retry -> out_cap "
        f"{out_cap}; {n} rows == lineitem rows, decimal sum exact; kernel == plain word "
        f"for word; kernel path {t_kernel * 1e3:.3f} ms = {res['kernel_rows_per_s']:.1f} "
        f"rows/s (median of 3), plain path {t_plain * 1e3:.3f} ms = "
        f"{res['plain_rows_per_s']:.1f} rows/s (one run); peak memory of the kernel path "
        f"{peak} bytes")
    return res, (orders, lineitem, keys, out_cap)


def phase_sf10_kernels(orders, lineitem, keys, out_cap) -> None:
    """K1-K4 vs plain at the SF10-shaped join's shapes, exact, and timed."""
    from datafusion_parallelism_tpu_torch.ops.join import KERNELS, PLAIN, inner_csr_join
    checked = Checked()
    inner_csr_join(orders, lineitem, *keys, out_cap, checked.stages)
    timing = {}
    for i, name in enumerate(checked.calls):
        ms = sum(cuda_ms(KERNELS[i], *args, reps=3) for args in checked.calls[name])
        plain_ms = sum(cuda_ms(PLAIN[i], *args, reps=3) for args in checked.calls[name])
        timing[name] = (ms, plain_ms)
    log("phase 7 ok: K1-K4 == plain at the SF10-shaped join's shapes; ms kernel/plain "
        "per join (median of 3): "
        + ", ".join(f"{k} {a:.3f}/{b:.3f}" for k, (a, b) in timing.items()))


# ---------------------------------------------------------------------------
# the single-table chain: K5-K8 recorded and compared
# ---------------------------------------------------------------------------

SUM_RTOL, SUM_ATOL_PER_ABS = 1e-9, 1e-12   # float64 sums in another order
CHAIN_RTOL = 1e-9                           # a chain's float outputs
ORACLE_REL, ORACLE_ABS = 1e-6, 1e-4         # tpch/diff_results.py's rule


def recorder(record):
    """The chain's kernels (kernels/chain.py KERNELS) with each call's
    arguments appended to record[entry point]."""
    from datafusion_parallelism_tpu_torch.kernels.chain import KERNELS, ChainKernels

    def stage(entry, fn):
        calls = record.setdefault(entry, [])

        def run(*args):
            calls.append(args)
            return fn(*args)
        return run

    return ChainKernels(*(stage(e, fn) for e, fn in zip(ChainKernels._fields, KERNELS)))


@contextlib.contextmanager
def no_launches():
    """Fails unless the chain's kernel wrappers launch nothing inside: the
    plain path must not reach a kernel past its `kernels` argument."""
    from datafusion_parallelism_tpu_torch.kernels.chain import KERNELS
    before = [fn.launches for fn in KERNELS]
    yield
    after = [fn.launches for fn in KERNELS]
    if after != before:
        raise AssertionError(f"the plain path launched kernels: {before} -> {after}")


def _diff(a, b):
    """|a - b| with equal values (infinities included) at 0."""
    import torch
    return torch.where(a == b, 0.0, (a.double() - b.double()).abs())


def agg_results_err(got, want, reqs) -> float:
    """Max error of K7/K8 per-request results against the plain ones:
    float64 sums within SUM_RTOL + SUM_ATOL_PER_ABS * sum|x|, the rest bit
    for bit."""
    import torch
    worst = 0.0
    for g, w, (func, values, validity) in zip(got, want, reqs, strict=True):
        if func == "sum" and values.is_floating_point():
            x = values.double().abs()
            if validity is not None:
                x = torch.where(validity, x, 0.0)
            diff = _diff(g, w)
            limit = SUM_ATOL_PER_ABS * float(x.sum()) + SUM_RTOL * w.abs()
            if bool((diff > limit).any()):
                raise AssertionError(f"float sum differs by {float(diff.max())}")
            worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
        else:
            max_abs_err(g, w)
    return worst


def entry_err(entry: str, args, got, want) -> float:
    """Error of one K5-K8 call against its plain version; raises past the
    tolerance."""
    if entry == "segment_agg":   # (starts, sizes, results, n_groups)
        max_abs_err((got[0], got[1], got[3]), (want[0], want[1], want[3]))
        return agg_results_err(got[2], want[2], args[3])
    if entry == "direct_agg":    # (rowcount, results)
        max_abs_err(got[0], want[0])
        return agg_results_err(got[1], want[1], args[4])
    max_abs_err(got, want)       # bit for bit, so the error is 0
    return 0.0


def check_calls(record, reps: int = 3, timed: bool = True):
    """Each recorded call run through the kernel and its plain version:
    {kernel name: [max error, kernel ms, plain ms]} (times summed over the
    calls, CUDA events, median of `reps`)."""
    from datafusion_parallelism_tpu_torch.kernels.chain import KERNEL_OF, KERNELS, PLAIN
    out = {}
    for entry, calls in record.items():
        if not calls:
            continue
        kernel, plain = getattr(KERNELS, entry), getattr(PLAIN, entry)
        acc = out.setdefault(KERNEL_OF[entry], [0.0, 0.0, 0.0])
        for args in calls:
            acc[0] = max(acc[0], entry_err(entry, args, kernel(*args), plain(*args)))
            if timed:
                acc[1] += cuda_ms(kernel, *args, reps=reps)
                acc[2] += cuda_ms(plain, *args, reps=reps)
    return out


def merge_timing(into, part):
    for name, (err, ms, plain_ms) in part.items():
        acc = into.setdefault(name, [0.0, 0.0, 0.0])
        acc[0] = max(acc[0], err)
        acc[1] += ms
        acc[2] += plain_ms


def _fmt_timing(timing) -> str:
    return ", ".join(f"{k} {v[1]:.3f}/{v[2]:.3f}" for k, v in timing.items())


def tables_close(a, b, rtol: float = CHAIN_RTOL) -> None:
    """Two operator outputs equal over their rows: validity bit for bit,
    integer values bit for bit, float values within rtol."""
    import torch
    n = int(a.num_rows)
    if n != int(b.num_rows) or a.schema.names != b.schema.names:
        raise AssertionError(f"rows {n} vs {int(b.num_rows)}")
    for name in a.schema.names:
        (va, ma), (vb, mb) = a.column(name), b.column(name)
        if not torch.equal(ma[:n], mb[:n]):
            raise AssertionError(f"column {name}: validity differs")
        x, y = va[:n][ma[:n]], vb[:n][ma[:n]]
        ok = (torch.allclose(x, y, rtol=rtol, atol=0.0, equal_nan=True)
              if x.is_floating_point() else torch.equal(x, y))
        if not ok:
            raise AssertionError(f"column {name} differs")


def qualify(t, label: str):
    """The table with every column named label.column, as the JAX
    executor hands a scan to the plan (runtime/executor.py:193)."""
    from datafusion_parallelism_tpu_torch.utils.columnar import DeviceTable, Schema
    fields = [f.with_name(f"{label}.{f.name}") for f in t.schema.fields]
    return DeviceTable(Schema(fields), {f"{label}.{n}": c for n, c in t.columns.items()},
                       t.num_rows)


def _li(name: str):
    from datafusion_parallelism_tpu_torch.ops.expressions import Col
    return Col(f"lineitem.{name}")


def _pass_through(names):
    """The planner's column-pruning projection over lineitem."""
    return ("project", [(_li(n), f"lineitem.{n}") for n in names])


def q1_steps():
    """TPC-H Q1 as the JAX planner plans it (tpch/queries.py, the plan of
    models/planner.py; tests/test_torch_tpch_data.py holds the two equal)."""
    from datafusion_parallelism_tpu_torch.ops.aggregate import AggSpec
    from datafusion_parallelism_tpu_torch.ops.expressions import BinOp, Col, Lit
    from datafusion_parallelism_tpu_torch.ops.sort import SortKey
    from datafusion_parallelism_tpu_torch.utils.columnar import DATE32, INT32
    one = Lit(1, INT32)
    disc_price = BinOp("*", _li("l_extendedprice"), BinOp("-", one, _li("l_discount")))
    cols = ["l_quantity", "l_extendedprice", "l_discount", "l_tax", "l_returnflag",
            "l_linestatus"]
    ins = [_li("l_returnflag"), _li("l_linestatus"), _li("l_quantity"),
           _li("l_extendedprice"), disc_price,
           BinOp("*", disc_price, BinOp("+", one, _li("l_tax"))),
           _li("l_quantity"), _li("l_extendedprice"), _li("l_discount")]
    names = ["__g0", "__g1"] + [f"__ain{i}" for i in range(7)]
    outs = ["l_returnflag", "l_linestatus", "sum_qty", "sum_base_price", "sum_disc_price",
            "sum_charge", "avg_qty", "avg_price", "avg_disc", "count_order"]
    aggs = ([AggSpec("sum", f"__ain{i}", f"__a{i}") for i in range(4)]
            + [AggSpec("avg", f"__ain{i}", f"__a{i}") for i in range(4, 7)]
            + [AggSpec("count_star", None, "__a7")])
    return [_pass_through(cols + ["l_shipdate"]),
            ("filter", BinOp("<=", _li("l_shipdate"), Lit(10471, DATE32))),
            _pass_through(cols),
            ("project", list(zip(ins, names))),
            ("aggregate", ["__g0", "__g1"], aggs),
            ("project", list(zip([Col(n) for n in ["__g0", "__g1"]]
                                 + [Col(f"__a{i}") for i in range(8)], outs))),
            ("sort", [SortKey("l_returnflag"), SortKey("l_linestatus")])]


def q6_steps():
    """TPC-H Q6 as the JAX planner plans it."""
    from datafusion_parallelism_tpu_torch.ops.aggregate import AggSpec
    from datafusion_parallelism_tpu_torch.ops.expressions import BinOp, Col, Lit
    from datafusion_parallelism_tpu_torch.utils.columnar import DATE32, DECIMAL
    dec = lambda v: Lit(v, DECIMAL(2), raw=True)   # noqa: E731
    pred = BinOp("and", BinOp("and", BinOp("and",
                 BinOp("<", _li("l_quantity"), dec(2400)),
                 BinOp("and", BinOp(">=", _li("l_discount"), dec(5)),
                       BinOp("<=", _li("l_discount"), dec(7)))),
                 BinOp("<", _li("l_shipdate"), Lit(9131, DATE32))),
                 BinOp(">=", _li("l_shipdate"), Lit(8766, DATE32)))
    return [_pass_through(["l_quantity", "l_extendedprice", "l_discount", "l_shipdate"]),
            ("filter", pred),
            _pass_through(["l_extendedprice", "l_discount"]),
            ("project", [(BinOp("*", _li("l_extendedprice"), _li("l_discount")), "__ain0")]),
            ("aggregate", [], [AggSpec("sum", "__ain0", "__a0")]),
            ("project", [(Col("__a0"), "revenue")])]


def q18_steps():
    """Q18's inner aggregate and HAVING over lineitem: sum(l_quantity) per
    order, orders above 300, largest first, the first 100."""
    from datafusion_parallelism_tpu_torch.ops.aggregate import AggSpec
    from datafusion_parallelism_tpu_torch.ops.expressions import BinOp, Col, Lit
    from datafusion_parallelism_tpu_torch.ops.sort import SortKey
    from datafusion_parallelism_tpu_torch.utils.columnar import DECIMAL
    return [_pass_through(["l_orderkey", "l_quantity"]),
            ("aggregate", ["lineitem.l_orderkey"],
             [AggSpec("sum", "lineitem.l_quantity", "sum_qty")]),
            ("filter", BinOp(">", Col("sum_qty"), Lit(30000, DECIMAL(2), raw=True))),
            ("sort", [SortKey("sum_qty", ascending=False), SortKey("lineitem.l_orderkey")]),
            ("limit", 100)]


def q20_steps():
    """Q20's lineitem aggregate: sum(l_quantity) per (part, supplier) over
    the lines shipped in 1994, a two-column key (K1's hash, K6, K7)."""
    from datafusion_parallelism_tpu_torch.ops.aggregate import AggSpec
    from datafusion_parallelism_tpu_torch.ops.expressions import BinOp, Lit
    from datafusion_parallelism_tpu_torch.utils.columnar import DATE32
    return [_pass_through(["l_partkey", "l_suppkey", "l_quantity", "l_shipdate"]),
            ("filter", BinOp("and", BinOp(">=", _li("l_shipdate"), Lit(8766, DATE32)),
                             BinOp("<", _li("l_shipdate"), Lit(9131, DATE32)))),
            ("aggregate", ["lineitem.l_partkey", "lineitem.l_suppkey"],
             [AggSpec("sum", "lineitem.l_quantity", "sum_qty")])]


def _seeded_agg_table(rng, device, n: int = 1 << 16):
    """Keys and values with NULLs, an int64 column at its extremes, a float
    column with -0.0, NaN and +-inf, a constant key, three 3-code string
    keys (64 direct groups) and a bool; padded to twice its rows."""
    from datafusion_parallelism_tpu_torch.utils.columnar import STRING, Dictionary, HostTable
    f = rng.normal(size=n)
    for value, share in ((-0.0, 0.1), (0.0, 0.1), (np.nan, 0.05), (np.inf, 0.02),
                         (-np.inf, 0.02)):
        f[rng.random(n) < share] = value
    big = np.iinfo(np.int64).max
    data = {"k": rng.integers(-50, 50, n).astype(np.int32),
            "l": rng.choice(np.array([-big, -(1 << 62), -1, 0, 1 << 40, big]), n),
            "f": f, "c": np.full(n, 7, np.int32), "b": rng.random(n) < 0.3,
            "v": rng.integers(-(1 << 40), 1 << 40, n), "x": rng.normal(size=n) * 1e3,
            "i": rng.integers(-1000, 1000, n).astype(np.int32)}
    codes = {s: rng.integers(0, 3, n).astype(np.int32) for s in ("s1", "s2", "s3")}
    abc = Dictionary(np.array(["a", "b", "c"], dtype=object))
    valid = {k: rng.random(n) >= 0.1 for k in ("k", "l", "f", "v", "x", "s1")}
    host = HostTable.from_numpy({**data, **codes}, dtypes={s: STRING for s in codes},
                                dictionaries={s: abc for s in codes}, validity=valid)
    return host.to_device(2 * n, device=device)


def phase_agg_kernels_vs_plain(device):
    """K5-K8 against their plain versions on seeded inputs, through the
    operators; then K7's one-group and uniform-key times."""
    import torch
    from datafusion_parallelism_tpu_torch.kernels import segment_agg as k7
    from datafusion_parallelism_tpu_torch.ops.aggregate import AggSpec, hash_aggregate_counted
    from datafusion_parallelism_tpu_torch.ops.expressions import BinOp, Col, Lit
    from datafusion_parallelism_tpu_torch.ops.filter import filter_table
    from datafusion_parallelism_tpu_torch.ops.hashing import key_words
    from datafusion_parallelism_tpu_torch.ops.sort import SortKey, sort_table
    from datafusion_parallelism_tpu_torch.utils.columnar import INT32

    rng = np.random.default_rng(8)
    t = _seeded_agg_table(rng, device)
    aggs = [AggSpec("sum", "v", "sv"), AggSpec("sum", "x", "sx"), AggSpec("min", "x", "mn"),
            AggSpec("max", "v", "mx"), AggSpec("min", "i", "mi"), AggSpec("count", "x", "cx"),
            AggSpec("avg", "v", "av"), AggSpec("count_star", None, "cs")]
    row_filter = torch.from_numpy(rng.random(t.capacity) < 0.5).to(device)
    record = {}
    rec = recorder(record)
    filter_table(t, BinOp(">", Col("k"), Lit(0, INT32)), None, rec)
    _, n = filter_table(t, BinOp(">", Col("k"), Lit(1000, INT32)), None, rec)
    if int(n) != 0:
        raise AssertionError("a predicate no row meets kept rows")
    _, n = filter_table(t, BinOp("<", Col("k"), Lit(40, INT32)), 1024, rec)
    if int(n) <= 1024:
        raise AssertionError("the out_cap case did not overflow")
    sort_table(t, [SortKey("f")], rec)
    sort_table(t, [SortKey("f", ascending=False, nulls_first=True), SortKey("k")], rec)
    sort_table(t, [SortKey("l", ascending=False), SortKey("s1", nulls_first=True)], rec)
    for keys, out_cap, rf in ((["k"], None, None), (["c"], None, None), (["k"], 16, None),
                              (["l", "f"], None, row_filter), (["c", "b"], None, None),
                              ([], None, row_filter), (["s1", "s2", "s3"], None, None)):
        _, n = hash_aggregate_counted(t, keys, aggs, out_cap, rf, rec)
        if keys == ["c"] and int(n) != 1:
            raise AssertionError(f"a constant key gave {int(n)} groups")
    errs = check_calls(record, timed=False)

    # one group holding every row, beside the same rows over uniform keys
    n = K7_ROWS
    ones = torch.ones(n, dtype=torch.bool, device=device)
    valid = torch.from_numpy(rng.random(n) >= 0.1).to(device)
    v = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, n)).to(device)
    x = torch.from_numpy(rng.normal(size=n)).to(device)
    reqs = [("count", x, valid), ("sum", v, valid), ("sum", x, valid), ("min", v, None),
            ("max", x, valid)]
    n_valid = torch.tensor(n, dtype=torch.int32, device=device)
    k7_ms = {}
    for label, key in (("one group", torch.zeros(n, dtype=torch.int32, device=device)),
                       ("uniform keys", torch.sort(torch.from_numpy(
                           rng.integers(0, 1 << 20, n).astype(np.int32)).to(device))[0])):
        words, cols = key_words([(key, ones)])
        args = (words, cols, n_valid, reqs, n)
        errs["segment_agg"][0] = max(errs["segment_agg"][0], entry_err(
            "segment_agg", args, k7.segment_agg(*args), k7.segment_agg_plain(*args)))
        k7_ms[label] = cuda_ms(k7.segment_agg, *args, reps=5)
    ratio = k7_ms["one group"] / k7_ms["uniform keys"]
    if ratio > 3:
        raise AssertionError(f"K7 one group {k7_ms['one group']:.3f} ms is {ratio:.2f}x its "
                             f"uniform-key time")
    log("phase 8 ok: K5-K8 == plain on seeded inputs (filters keeping some, no and too many "
        "rows; sorts on float keys with -0.0/NaN/inf and NULLs, int64 extremes DESC; "
        "aggregates on a nullable int32 key, one constant key, out_cap 16, a two-column "
        "int64 x float key with a row filter, G = 1, G = 64), max errors "
        + ", ".join(f"{k} {v[0]!r}" for k, v in errs.items())
        + f"; K7 on {n} sorted rows: one group {k7_ms['one group']:.3f} ms, uniform keys "
        f"{k7_ms['uniform keys']:.3f} ms (ratio {ratio:.2f})")
    return errs, k7_ms


def phase_roofline(device):
    """benches/roofline.py's filter_compact, hash_aggregate and
    sort_table_13col at its N: kernel path == plain path, and times."""
    from datafusion_parallelism_tpu_torch.kernels.chain import KERNELS, PLAIN
    from datafusion_parallelism_tpu_torch.ops.aggregate import AggSpec, hash_aggregate_counted
    from datafusion_parallelism_tpu_torch.ops.sort import SortKey, sort_table
    from datafusion_parallelism_tpu_torch.utils.columnar import HostTable, filter_rows

    n = ROOFLINE_N
    rng = np.random.default_rng(0)
    cols = {f"c{j}": rng.integers(0, 1 << 30, n).astype(np.int32) for j in range(12)}
    build = HostTable.from_numpy({"b_key": rng.integers(0, n, n).astype(np.int32), **cols}
                                 ).to_device(device=device)
    at = HostTable.from_numpy({"g": rng.integers(0, 1 << 16, n).astype(np.int32),
                               "x": cols["c0"], "y": rng.random(n).astype(np.float32)}
                              ).to_device(device=device)

    def f_filter(kernels):
        mask = (build.column("c0")[0] & 1) == 0
        return filter_rows(build, mask & build.row_mask(), kernels)

    def f_agg(kernels):
        return hash_aggregate_counted(at, ["g"], [AggSpec("sum", "x", "sx"),
                                                  AggSpec("max", "y", "my")], 1 << 17,
                                      None, kernels)[0]

    def f_sort(kernels):
        return sort_table(build, [SortKey("b_key")], kernels)

    timing, lines = {}, []
    for name, fn in (("filter_compact", f_filter), ("hash_aggregate", f_agg),
                     ("sort_table_13col", f_sort)):
        record = {}
        out = fn(recorder(record))
        with no_launches():
            ref = fn(PLAIN)
            t_plain = wall_s(lambda: fn(PLAIN), 3)
        tables_equal(out, ref)
        t_kernel = wall_s(lambda: fn(KERNELS), 5)
        per = check_calls(record, reps=5)
        merge_timing(timing, per)
        lines.append(f"{name} {t_kernel * 1e3:.3f}/{t_plain * 1e3:.3f} ms ({_fmt_timing(per)})")
        del out, ref
    log(f"phase 9 ok: roofline shapes at N={n}, kernel path == plain path word for word; "
        "path ms kernel/plain (kernel ms kernel/plain): " + "; ".join(lines))
    return timing


def _oracle_rows_match(got, want) -> None:
    """tpch/diff_results.py's rule: the same rows in the same order (both
    are ORDER BY results), floats within rel 1e-6 or abs 1e-4."""
    import math
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} rows, oracle {len(want)}")
    for g, w in zip(got, want):
        for k, wv in w.items():
            gv = g[k]
            if isinstance(wv, float) or isinstance(gv, float):
                ok = math.isclose(float(gv), float(wv), rel_tol=ORACLE_REL, abs_tol=ORACLE_ABS)
            else:
                ok = gv == wv
            if not ok:
                raise AssertionError(f"{k}: {gv!r} vs oracle {wv!r}")


def _np(t, name, n=None):
    v = t.column(name)[0]
    return (v if n is None else v[:n]).cpu().numpy()


def check_q18(out, li) -> int:
    okey, qty = li.columns["l_orderkey"][0], li.columns["l_quantity"][0]
    sums = np.bincount(okey, weights=qty).astype(np.int64)   # exact below 2^53
    keys = np.flatnonzero(sums > 30000)
    keys = keys[np.lexsort((keys, -sums[keys]))][:100]
    n = int(out.num_rows)
    if n != len(keys) or not (np.array_equal(_np(out, "lineitem.l_orderkey", n), keys)
                              and np.array_equal(_np(out, "sum_qty", n), sums[keys])):
        raise AssertionError("Q18-shaped result differs from numpy")
    return n


def check_q20(out, li) -> int:
    c = li.columns
    ship = c["l_shipdate"][0]
    m = (ship >= 8766) & (ship < 9131)
    pk, sk, q = (c[k][0][m].astype(np.int64) for k in ("l_partkey", "l_suppkey", "l_quantity"))
    stride = int(sk.max()) + 1
    uniq, inv = np.unique(pk * stride + sk, return_inverse=True)
    sums = np.bincount(inv, weights=q).astype(np.int64)
    n = int(out.num_rows)
    got_key = _np(out, "lineitem.l_partkey", n).astype(np.int64) * stride + _np(
        out, "lineitem.l_suppkey", n)
    order = np.argsort(got_key, kind="stable")
    if n != len(uniq) or not (np.array_equal(got_key[order], uniq)
                              and np.array_equal(_np(out, "sum_qty", n)[order], sums)):
        raise AssertionError("Q20-shaped result differs from numpy")
    return n


CHAINS = {"Q1": q1_steps, "Q6": q6_steps, "Q18-shaped": q18_steps, "Q20-shaped": q20_steps}


def phase_tpch_chains(device, counters):
    """The four lineitem chains at SF10. Counters are zeroed before their
    first runs and read after them. Returns (launches, per-chain results,
    the recorded kernel calls' timing)."""
    import torch
    from datafusion_parallelism_tpu_torch.kernels.chain import PLAIN
    from datafusion_parallelism_tpu_torch.ops.plan import run_steps
    from datafusion_parallelism_tpu_torch.tpch.datagen import generate_tables
    from datafusion_parallelism_tpu_torch.tpch.oracle import _q1_np, _q6_np

    t0 = time.perf_counter()
    tables = generate_tables(sf=TPCH_SF)
    gen_s = time.perf_counter() - t0
    host = tables["lineitem"]
    n_li = host.num_rows
    t0 = time.perf_counter()
    li = qualify(host.to_device(LINEITEM_CAP, device=device), "lineitem")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0

    steps = {name: make() for name, make in CHAINS.items()}
    caps = {name: {} for name in CHAINS}
    for w in counters.values():
        w.launches = 0
    outs = {name: run_steps(li, steps[name], caps[name]) for name in CHAINS}
    launches = {name: w.launches for name, w in counters.items()}

    _oracle_rows_match(outs["Q1"][0].to_host().to_pylist(), _q1_np(tables))
    _oracle_rows_match(outs["Q6"][0].to_host().to_pylist(), _q6_np(tables))
    rows = {"Q1": 4, "Q6": 1, "Q18-shaped": check_q18(outs["Q18-shaped"][0], host),
            "Q20-shaped": check_q20(outs["Q20-shaped"][0], host)}
    del tables

    res, timing, lines = {}, {}, []
    for name in CHAINS:
        out, retries = outs.pop(name)
        with no_launches():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref, _ = run_steps(li, steps[name], caps[name], PLAIN)
            torch.cuda.synchronize()
            t_plain = time.perf_counter() - t0
        tables_close(out, ref)
        del out, ref
        torch.cuda.reset_peak_memory_stats(device)
        t_kernel = wall_s(lambda: run_steps(li, steps[name], caps[name]), 3)
        peak = torch.cuda.max_memory_allocated(device)
        record = {}
        run_steps(li, steps[name], caps[name], recorder(record))
        per = check_calls(record, reps=3)
        del record
        merge_timing(timing, per)
        res[name] = {"rows_out": rows[name], "grow_retries": retries, "kernel_s": t_kernel,
                     "plain_s": t_plain, "kernel_rows_per_s": n_li / t_kernel,
                     "plain_rows_per_s": n_li / t_plain, "peak_bytes": peak,
                     "kernel_ms": {k: v[1] for k, v in per.items()},
                     "plain_kernel_ms": {k: v[2] for k, v in per.items()}}
        lines.append(f"{name}: {rows[name]} rows, {retries} grow retries, kernel path "
                     f"{t_kernel * 1e3:.3f} ms = {n_li / t_kernel:.1f} rows/s (median of 3), "
                     f"plain path {t_plain * 1e3:.3f} ms = {n_li / t_plain:.1f} rows/s (one "
                     f"run), peak {peak} bytes; kernel/plain ms {_fmt_timing(per)}")
    log(f"phase 10 ok: TPC-H SF{TPCH_SF} lineitem, {n_li} rows at capacity {LINEITEM_CAP} "
        f"(generated in {gen_s:.1f} s, uploaded in {upload_s:.1f} s); Q1 and Q6 == the numpy "
        "oracle, the Q18- and Q20-shaped chains == numpy, every chain == its plain path. "
        + " | ".join(lines))
    return launches, res, timing


def launch_counters():
    from datafusion_parallelism_tpu_torch.kernels import (compact_gather, csr_build,
                                                          hash_slot, probe_expand)
    return {"hash_slot": hash_slot.hash_slot, "csr_build": csr_build.csr_build,
            "probe_expand": probe_expand.probe_expand,
            "compact_gather": compact_gather.compact_gather}


def agg_counters():
    """The chain's launch counters: K5-K8's entry points and K1's."""
    from datafusion_parallelism_tpu_torch.kernels.chain import KERNELS
    return KERNELS._asdict()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = phase_build()
    phase_kernels_vs_plain(device)
    errs, timing = phase_size512_kernels(device)

    wrappers = launch_counters()
    for w in wrappers.values():
        w.launches = 0
    phase_entry(device)
    phase_size512(device)
    _, sf10 = phase_sf10(device)
    launches = {name: w.launches for name, w in wrappers.items()}
    missing = [name for name, n in launches.items() if n < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    log(f"phase 6 ok: launches during phases 3-5: {launches}")
    phase_sf10_kernels(*sf10)
    del sf10

    agg_errs, _ = phase_agg_kernels_vs_plain(device)
    roof = phase_roofline(device)
    agg_launches, _, chain_timing = phase_tpch_chains(device, agg_counters())
    missing = [name for name, n in agg_launches.items() if n < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the chains: {missing}")
    log(f"phase 11 ok: launches during phase 10's first runs: {agg_launches}")
    log("phase 12 ok: K5-K8 == plain at the shapes of the SF10 chains; ms kernel/plain "
        "summed over their calls: " + _fmt_timing(chain_timing))

    kernels = [{"name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
                "replaces": KERNEL_INFO[name][1], "launches": launches[name],
                "max_abs_err": errs[name], "ms": timing[name][0],
                "plain_ms": timing[name][1]} for name in wrappers]
    from datafusion_parallelism_tpu_torch.kernels.chain import KERNEL_OF
    for name in AGG_KERNELS:
        err = max(part[name][0] for part in (agg_errs, roof, chain_timing) if name in part)
        kernels.append({"name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
                        "replaces": KERNEL_INFO[name][1],
                        "launches": sum(n for e, n in agg_launches.items()
                                        if KERNEL_OF[e] == name),
                        "max_abs_err": err, "ms": chain_timing[name][1],
                        "plain_ms": chain_timing[name][2]})
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
