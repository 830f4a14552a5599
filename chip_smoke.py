#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives `datafusion_parallelism_tpu_torch`'s main path, the single-device
INNER CSR hash join, through its four hand-written CUDA kernels, and holds
every result against the plain torch versions. Phases, one line each:

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
  6. every kernel of the path launched during phases 3-5
  7. K1-K4 against their plain versions at the SF10-shaped join's shapes,
     exact, and timed

The last line is {"ok": true, "device": {...}}, printed only when every
phase passed; the line before it lists the kernels with their launches,
errors and times. Without a CUDA device the script exits non-zero and
prints no result.
"""

from __future__ import annotations

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
}


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


def launch_counters():
    from datafusion_parallelism_tpu_torch.kernels import (compact_gather, csr_build,
                                                          hash_slot, probe_expand)
    return {"hash_slot": hash_slot.hash_slot, "csr_build": csr_build.csr_build,
            "probe_expand": probe_expand.probe_expand,
            "compact_gather": compact_gather.compact_gather}


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

    kernels = [{"name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
                "replaces": KERNEL_INFO[name][1], "launches": launches[name],
                "max_abs_err": errs[name], "ms": timing[name][0],
                "plain_ms": timing[name][1]} for name in wrappers]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
