#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives `datafusion_parallelism_tpu_torch`'s seven main paths through its
nineteen hand-written CUDA kernels and holds every result against the
plain torch versions: the single-device INNER CSR hash join (K1-K4), the
single-table chain filter -> project -> hash aggregate -> sort -> limit
(K5-K8, with K1 for multi-column group keys), SQL through
`SessionContext`: the planner, the eager executor and all eight join types
(K9-K11 beside K1-K8), out-of-core execution: morsel streaming and grace
partitioning (K12 pack_rows packing and unpacking every table and chunk,
K13 append_rows, K10's accumulate mode), and the SORT and OA join
strategies (K14 sorted_probe, K15 oa_place, K16 oa_probe, K6 and K5 in
their builds, K3's second pass expand_ranges over their ranges), and the
distributed hash join over P partitions (K18 dest_pack, K19
key_histogram, with K1, K5, K11 and K12 around the exchange), and SQL
over 8 partitions (the distributed executor: every shard's operators
through K1-K12 and K17, the shuffles and owner-dedup through K5, K10,
K11, K18 and K19), in process and through a one-rank NCCL group holding
the 8 partitions, and streamed through the 8 partitions out of core
(frozen per-partition builds, K12 unpacking every chunk's shards); every
expression of every path is K17 expr_eval. Then the TPC-H CLI, as a user
runs it, drives the resident, out-of-core and 8-partition paths over the
native generator's memmapped SF10 tables (phase 23), the port's
microbenchmarks run at their full sizes (phase 24), and last the SF100
campaign's driver runs its path at SF1 (phase 25).
Phases, one line each:

  1. build the kernels with nvcc, one process per source, all at once,
     and meanwhile the native host libraries with g++; print the card's
     name and power limit
  2. K1-K4 against their plain versions on the card, exact, on seeded
     inputs (nulls, negative int64, a two-column key, padding, a hot key,
     no match, an overflowing out_cap, float keys, a non-power-of-two
     table size, K1's row mask), every join type, residual, late
     materialized and chain-fused variant through K1-K5 and K9-K11 (2a),
     and at the Size512 join's shapes (2b),
     where each kernel is also timed against its plain version; K14, K15,
     K16 and K3's expand_ranges on seeded hashes (repeats, null keys,
     padding, a one-home cluster displaced by thousands of slots) at a
     power-of-two and a Lemire table size, SORT and OA joins with every
     stage checked, K14-K16 on their edge cases twice (K16 also on a walk
     to the spill region's end, probes past a tile's multiple, one probe
     row and no probe row ok), and K17 on every expression class x dtype with NULLs,
     division by zero and negative operands, then at row counts around its
     tile (0, 1, 31, T - 1, T, T + 1, 1,000; values and masks) and with
     1, 5 and 64 registers up to more tiles than its grid holds (2c); K6
     on edge cases, bit
     for bit: one row, a pass tile's rows plus and minus one, 2^24 + 3
     rows, 0, 1, 32, 33, 64 and 96 varying bits, int64 extremes, sorted
     and reverse-sorted input, one value in every row, a hot digit (2d);
     K13 and K11 bit for bit on edge cases: K13 at acc_rows 0-3 mod 4, no
     rows, a partition capacity past acc_cap, rows dropped past it, a full
     accumulator, no float64 sidecar, more rows than the capacity and a
     4,194,304-row append of 13 words and 2 sidecars at an odd offset into
     16,777,216 rows; K11 with 1 and 8 parts, empty parts between full
     ones, part boundaries inside a tile (caps 4097, 1, 3), no sidecar and
     two large parts meeting at an unaligned row; K5's gather in both
     thread layouts: cap 0, m 0, n 0, n > m, idx out of range, words or
     sidecars only, sources below and above the L2 (2e); K2 and K3 bit for
     bit on edge cases: K2 at T = 1, 255, 2^20 and 4 x a capacity past
     64 M, bits(T) = 25, 28 and 31, n = 0, 1 and not a multiple of the
     tile, every row in bucket T, a sparse build, one bucket over many
     tiles, no narrow rows, and its row-major rows; K3's two passes with
     total 0, one probe row owning every candidate, out_cap below, equal
     to and above the total, m = 1, a hot key, five keys (and_match) and
     block boundaries inside probe rows' candidates, the second pass over
     word-major and row-major build rows, twice with the same bits; K4
     with n_match 0, every slot a match, total 0, total past out_cap, no
     total, an out_cap off its tile, 70 build columns (two launches) and
     every column kind with nulls (NaN payloads, -0.0, denormals, int64
     extremes), twice with the same bits (2f); K8 and K5's compaction on edge cases, each run twice with the
     same bits both times: K8 (integers bit for bit, float64 within rtol
     1e-9) at G = 1, 12 and 64, 33 requests (two launches), num_rows 0, a
     row filter all False, all-NULL groups, NaN, +-inf and -0.0 in its
     float64 column, every column but one at an odd offset (staged byte
     by byte beside a bulk copy), 2^24 + 3 rows; K5 bit for bit at cap 0 (into out_cap
     0 and 5), out_cap 0, none and all passing, survivors past out_cap, a
     cap off its 4,096-row tile, out_cap past cap, a mask at an odd offset,
     NaN payloads and denormals in its sidecars (2g); K7 (starts, sizes,
     the group count and integers bit for bit, float64 sums within rtol
     1e-9, each run twice with the same bits) at n_valid 0, 1 and a tile
     +-1, a capacity off its tile, one group over 2^24 + 3 rows, a group
     across one tile edge, groups dropped with the last kept one ending on
     a tile edge and at a window edge, out_cap 0 and above the group
     count, float keys with -0.0, NaN and NULLs, a 17-column key with 33
     requests, every input type, 4,473 valid rows in 2^25; its scratch
     bytes == kernels/segment_agg.py's layout (2h); K10 and K19 bit for
     bit, each run twice with the same bits: K10 under each flag selection
     (the visited flags, the probe flags, both) at n = 0, 1 and not a
     multiple of 16, total 0, mid and past n and none, slices at offsets
     1, 7 and 15 (its scalar head and tail), half the matches on one build
     row, no match and an incoming visited buffer; K19 over 1, 2, 3, 8
     and 64 shards (MAX_SHARDS), an empty shard, capacities not a multiple
     of 4, row counts below the capacity, past it and negative, validity
     masks, one and four hash buckets, hashes and validity off their
     16-byte boundary, 3 rows; its compiled plan == the wrapper's (2i)
  3. the `entry()` twin on the card against the same step on the CPU
  4. Size512 (4,194,304 build and probe rows): kernel path == plain path
     word for word, match count == a numpy count, rows/s of both paths
  5. a TPC-H SF10-shaped orders x lineitem join on an int64 key, run ->
     check overflow -> grow -> rerun, kernel path == plain path
  6. every kernel of the join launched during phases 3-5, and K12's pack
     and unpack not once (the deferred join reads the column buffers)
  7. K1-K4 against their plain versions at the SF10-shaped join's shapes,
     exact, and timed
  8. K5-K8 against their plain versions on seeded inputs through the
     operators (nulls in keys and values, every row filtered out, one
     group holding every row, an overflowing out_cap whose last kept
     group sums to the end of the rows, -0.0 and NaN sort keys, int64
     extremes, G = 1 and G = 64); K7 timed on 16,777,216 sorted rows in
     one group beside the same rows over uniform keys
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
 13. the eight join types at Size512 (4,194,304 x 4,194,304 uniform int32
     keys), INNER and LEFT_SEMI with the residual b_val < p_val, one
     float64-key and one int32 x int64-key join: kernel path == plain
     path word for word, row counts == numpy's counts of matches and of
     unmatched build and probe rows; ms of both paths
 14. all 22 TPC-H queries through `SessionContext(device=cuda).sql` at
     SF10 (the tables of phase 10): one collect() settles the
     capacities, then the median of 3 timed collect()s; each result ==
     the numpy oracle under tpch/diff_results.py's rule; per query ms,
     retries, staged or not, peak bytes and launches per kernel; every
     kernel K1-K12 launched during the phase
 16. all 22 TPC-H queries again on the same tables with the out-of-core
     thresholds scaled by SF10/SF100 (lineitem, orders and partsupp out of
     core, as at SF100 under the defaults): one collect() settles, one is
     timed; each result == phase 14's oracle answer; per query the route
     (resident / streamed / streamed after a side-swap / grace agg, union
     or mask), chunks, ms, host pack and upload seconds, peak bytes beside
     phase 14's; then Q20 once more under DFP_FORCE_GRACE (the mask
     merge, which no query takes at these thresholds); K12 and K13
     launched, and at least one query streamed, one after a side-swap, one
     grace agg, one grace union and one grace mask
 17. the 22 TPC-H queries through SQL at SF10 under the SORT strategy,
     then under OA, run on the card while phase 14's oracle computes: one
     collect() settles, the median of 3 timed ones and the peak over the
     tables already held, beside phase 14's CSR numbers; each result == the oracle's answer; then Q3
     (streamed) and Q18 (grace agg) under OOC_ENV, each == the oracle; K14
     launched under SORT, K15 and K16 under OA, K17 under both
 18. (run after 13) ROADMAP queue 3's four refusals at their smallest
     inputs (a 32-branch CASE, WHEREs of 33 and 65 disjuncts, joins on 5
     keys, 34 aggregate requests, GROUP BY 17 columns) through
     SessionContext on the card: each == the CPU session's rows, the same
     rows on a second run on the card, and == the JAX package's answer
 15. (run after 17) the largest call of every kernel entry point recorded
     in phase 14, the largest K12 pack and unpack, K13 and K10 accumulate
     calls of phase 16 and the largest K14-K16 and SORT/OA build-sort
     calls of phase 17, replayed through the kernel and its
     plain version: equal (K7 run twice, the same bits), and timed beside
     its bound (bytes moved at 3.35 TB/s; K5's gather: the rows below its
     count, and K7: its inputs below n_valid and its outputs, each beside
     the bound with every row read) and, where one PyTorch call computes the same
     function, that call (K5's gather: index_select, checked equal to the
     kernel first; K5's compaction: the boolean index words[:, mask], its
     survivors checked equal to the kernel's; K11 and K13: also with their
     device counts read inside the timing, as the kernels read them), and
     K8's partial yardstick (one index_add_ or scatter_reduce_ a request
     over group ids made before the timing) and K7's (unique_consecutive
     of the key words with its counts, one segment_reduce a float
     request); each K6 call with its rows, words,
     varying bits, key width and passes, each K11 and K13 call with its
     shapes and counts, K2's with n, T, R, its digit passes and its bound as
     counted before its outputs shared storage, K3's with m, T, total,
     out_cap and key groups, K10's with n, total, matches, bcap, mcap, the
     flags asked and its bound as counted before (every slot, both flags)
 19. (run after 18) the distributed hash join at P = 8 in process on the one card (the
     all-to-all a copy on the card, not NVLink): Size512 under all eight
     join types partitioned, INNER broadcast and skew_salted, partitioned
     and skew_salted with exponential probe keys (over the whole key range
     and over 64 keys, where buckets turn heavy), phase 5's SF10 orders x
     lineitem INNER join partitioned; rows == numpy's counts (and the
     price sum), INNER rows equal under the three modes, each retry
     logged; per run the step's ms, comm bytes and peak; K18 and K19
     launched, K19 once a histogram over the 8 shards (its launches and
     shards a launch printed), and both == their plain versions at the
     largest calls; then K18
     on its edge cases twice (P 1 and 1024, send_cap 0 and below the
     counts, a capacity off the tile, no rows, replicate flags, salted and
     heavy_to_all routes)
 20. (run after 19) a one-rank NCCL process group: the Size512 INNER join partitioned
     through ProcessGroupExchange == single-device hash_join row for row;
     then (run after 21) a one-rank NCCL group from
     init_multihost(..., local_device_count=8), whose Exchange holds the 8
     partitions: TPC-H Q5 and Q9 at SF10 through
     SessionConfig(target_partitions=8), both runs' rows == phase 21's
 21. (run after 15) SQL through SessionContext(SessionConfig(target_partitions=8))
     in process on the card: the 22 TPC-H queries at SF10 (the tables of
     phase 10), one collect() settling the capacities and one timed, each
     == the numpy oracle and == phase 14's rows; per query ms, staged or
     whole plan, retries, comm bytes, the largest max/min of a join's
     per-partition candidate totals, the largest stage's bytes a
     partition and the peak; nation LEFT JOIN supplier on a rare balance
     through the broadcast owner-dedup == numpy; LEFT, FULL, EXISTS and
     NOT EXISTS over phase 19's Size512 exponential-key tables under
     skew_salting, each join skew_salted, counts == numpy's; K5, K10,
     K11, K18 and K19 launched during the phase
 22. (run after 20's SQL) distributed morsel streaming at
     SessionConfig(target_partitions=8) in process: the TPC-H queries whose
     plans stream at SF10 under phase 16's thresholds and 4,194,304-row
     chunks (lineitem in 15 chunks of 524,288 rows a partition), then
     LEFT, NOT EXISTS and FULL over customer x orders (orders streamed
     against per-partition visited masks); one settling collect() and one
     timed, both == the numpy oracle and phase 14's rows (the cells: ==
     numpy); per query ms, chunks, retries, host pack and upload seconds,
     seconds blocked on totals, comm bytes, peak, and how many chunks
     were packed while the previous one computed; the synchronizing CUDA
     calls of the settling runs by site, those inside chunk steps apart;
     the queries that run resident; K1, K3 and K18 launched
 23. the TPC-H CLI (`tpch/cli.py`), as a user runs it: TPC-H SF10 written
     in the binary columnar format by the port's native generator
     (`tpch.generate --format bin`; the seconds and bytes) into a
     temporary directory, after a check of 8 GB free; the 22 queries
     through `cli.run(--data-path ... --iterations 2 --check)` over the
     memmapped tables, each checked against the numpy oracle, every
     kernel phase 14 launched launched again, no query's entry an error;
     Q1, Q3 and Q10 out of core under phase 16's thresholds (route
     "streamed", chunks read from the memmapped pages), their CSVs ==
     the resident run's under `diff_results.diff_dirs`, each `eligible`
     under `eligibility.classify`; Q5 and Q9 through `--concurrency 8`,
     == the resident run's CSVs, their comm bytes; `generate --format
     tbl` at SF 0.1 and Q6 over the `.tbl` files through the native
     parser with --check; one warm Q3 under `utils/tracing.profile` (the
     trace's bytes) and the spans of the load and the registration; the
     warm medians, oracle ms and route of every query
 24. the port's microbenchmarks (`datafusion_parallelism_tpu_torch/
     benches/`), each once at its default full size through its
     `main(argv)`, each checking its own answer: build_speed and
     lookup_speed at Size512 under CSR, SORT and OA, the skewed join
     (2^20 rows, both scenarios) on one device and at P = 8, the sort
     carriage study (2^22 rows x 6 columns), Size256's four-way nested
     join (10,240,000 rows), the roofline (N = 2^22; its JSON to
     bench_out/roofline.json) and the streamed x distributed sweep at
     SF1, P = 8, each at its defaults, nothing cut (BENCH_RUNS); each
     bench's lines printed, its kernels' launch counts zeroed before it
     and read after it, each kernel it runs launched
25. the SF100 campaign's path at SF1: `tools/sf100_run.py` over the
     native generator's SF1 tables under the out-of-core thresholds x
     1/100 (SF100's routes), Q1 (stream), Q2 (grace row-union), Q9
     (stream + side-swap), Q13 (stream over orders) and Q18 (grace
     aggregate), each in its own process with --check, after a first run
     in which Q18 is killed by a 0 s timeout (that run, which generates
     the tables and plans the routes on the host and leaves the card
     alone, is a process started before phase 24 and run beside it; the
     second takes its tables and routes); the two runs merged by
     `benches/merge_sf100` and rendered by `benches/sf100_report` into a
     stand-in PERF.md holding the SF100 markers (this script needs no
     PERF.md): the killed query an error entry, every check PASS,
     every route (of the 22 in the run's eligibility.json, and of each
     query run) that of `results/sf100/eligibility.json`, the merged Q18
     the second run's; the seconds, routes and peak device bytes

Exact means bit for bit, except float64 sums (and the averages built on
them), which K7 and K8 add in another order than the plain versions:
those agree within rtol 1e-9 + 1e-12 * sum|x| (a chain's outputs within
rtol 1e-9).

The last line is {"ok": true, "device": {...}}, printed only when every
phase passed; the line before it lists the kernels with their launches
(in phase 14, K12 and K13 in phase 16, K14-K16 in phase 17, K18 and K19
in phase 19) and phase 15's (K18, K19: phase 19's) errors, times,
bounds and library times (`library_sync_ms`: K11's and K13's with the
counts read inside the timing; `library_partial_ms`: K8's and K7's
partial yardsticks; `library_by_call`: each call's;
`bound_all_rows_ms`: K5's bound with every gathered row read, K7's with
every byte of its arguments and outputs). Without a
CUDA device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import logging
import os
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
    "pair_fetch": ("datafusion_parallelism_tpu_torch/csrc/pair_fetch.cu",
                   "datafusion_parallelism_tpu/ops/join.py:322"),
    "match_flags": ("datafusion_parallelism_tpu_torch/csrc/match_flags.cu",
                    "datafusion_parallelism_tpu/ops/join.py:363"),
    "concat_rows": ("datafusion_parallelism_tpu_torch/csrc/concat_rows.cu",
                    "datafusion_parallelism_tpu/utils/columnar.py:818"),
    "pack_rows": ("datafusion_parallelism_tpu_torch/csrc/pack_rows.cu",
                  "datafusion_parallelism_tpu/utils/columnar.py:753"),
    "append_rows": ("datafusion_parallelism_tpu_torch/csrc/append_rows.cu",
                    "datafusion_parallelism_tpu/runtime/grace.py:544"),
    "sorted_probe": ("datafusion_parallelism_tpu_torch/csrc/sorted_probe.cu",
                     "datafusion_parallelism_tpu/ops/hash_table.py:257"),
    "oa_place": ("datafusion_parallelism_tpu_torch/csrc/oa_place.cu",
                 "datafusion_parallelism_tpu/ops/hash_table.py:142"),
    "oa_probe": ("datafusion_parallelism_tpu_torch/csrc/oa_probe.cu",
                 "datafusion_parallelism_tpu/ops/hash_table.py:180"),
    "expr_eval": ("datafusion_parallelism_tpu_torch/csrc/expr_eval.cu",
                  "datafusion_parallelism_tpu/ops/expressions.py:84"),
    "dest_pack": ("datafusion_parallelism_tpu_torch/csrc/dest_pack.cu",
                  "datafusion_parallelism_tpu/parallel/shuffle.py:69"),
    "key_histogram": ("datafusion_parallelism_tpu_torch/csrc/key_histogram.cu",
                      "datafusion_parallelism_tpu/parallel/skew.py:49"),
}
# the kernels only the distributed join (phase 19) launches
DIST_KERNELS = ("dest_pack", "key_histogram")
# the kernels only the out-of-core path (phase 16) launches
OOC_KERNELS = ("append_rows",)
# the kernels only the SORT and OA strategies (phase 17) launch
STRATEGY_KERNELS = ("sorted_probe", "oa_place", "oa_probe")
# the entry points whose largest calls phase 15 takes from phase 17
STRATEGY_ENTRIES = {("join", "sorted_probe"), ("join", "oa_place"), ("join", "oa_probe"),
                    ("join", "table_sort"), ("join", "table_sort_oa")}
STRATEGY_TIMED_RUNS = 3
# the entry points whose largest calls phase 15 takes from phase 16
OOC_ENTRIES = {("chain", "pack_rows"), ("chain", "unpack_rows"), ("chain", "append_rows"),
               ("join", "match_flags_acc")}
# the out-of-core thresholds at SF10 that the JAX package's defaults are at
# SF100 (x 10/100): lineitem, orders and partsupp out of core, customer and
# part resident
OOC_ENV = {"DFP_STREAM_ROW_THRESHOLD": str((1 << 26) // 10),
           "DFP_STREAM_THRESHOLD_BYTES": str((6 << 30) // 10),
           "DFP_GRACE_RESIDENT_CEILING": str((96 << 20) // 10)}
ROOFLINE_N = 4_194_304                # benches/roofline.py's N
K7_ROWS = 16_777_216
K7_FEW_ROWS = 4473                    # Q18's outer grouping at SF10 (2^25 seeded rows)
TPCH_SF = 10
ORACLE_WORKERS = 3                    # processes computing the numpy oracle in phase 14
LINEITEM_CAP = 67_108_864
HBM_BYTES_PER_S = 3.35e12             # H100 SXM device memory rate
PEAK_OPS_PER_S = 67e12                # H100 SXM float32 outside the tensor cores


# ROADMAP queue 3's four refusals, each at its smallest input (seeded numpy
# data, the same in tests/test_torch_queue3.py): name -> (tables as
# pydicts, SQL, what is compared). QUEUE3_JAX holds the JAX package's
# answers on these inputs, which tests/test_torch_queue3.py recomputes.
def queue3_cases():
    rng = np.random.default_rng(3)
    n = 500
    a, b = rng.integers(0, 40, n), rng.integers(0, 8, n)
    v = rng.integers(-50, 50, n)
    s = [f"s{x}" for x in rng.integers(0, 5, n)]
    single = {"a": a.tolist(), "b": b.tolist(), "v": v.tolist(), "s": s}
    keys5 = {**{f"l{i}": rng.integers(0, 3, n).tolist() for i in range(5)},
             "lv": rng.integers(0, 100, n).tolist()}
    keys5r = {**{f"r{i}": rng.integers(0, 3, n).tolist() for i in range(5)},
              "rv": rng.integers(0, 100, n).tolist()}
    base = rng.integers(0, 4, (n, 17))
    wide = np.concatenate([base, base])[rng.permutation(2 * n)]
    wide17 = {f"c{i}": wide[:, i].tolist() for i in range(17)}
    case32 = " ".join(f"WHEN a = {i} THEN {3 * i}" for i in range(32))
    sums17 = ", ".join(f"SUM(v * {i}) AS s{i}" for i in range(17))
    cols17 = ", ".join(f"c{i}" for i in range(17))
    return {
        "case32": ({"t": single},
                   f"SELECT SUM(CASE {case32} ELSE 0 END) AS x FROM t", "x"),
        "or33": ({"t": single},
                 "SELECT COUNT(*) AS x FROM t WHERE "
                 + " OR ".join(f"(a = {i} AND b = {i % 8})" for i in range(33)), "x"),
        "or65": ({"t": single},
                 "SELECT COUNT(*) AS x FROM t WHERE "
                 + " OR ".join(f"a = {i}" for i in range(0, 130, 2)), "x"),
        "join5": ({"l": keys5, "r": keys5r},
                  "SELECT COUNT(*) AS x FROM l JOIN r ON "
                  + " AND ".join(f"l.l{i} = r.r{i}" for i in range(5)), "x"),
        # a residual takes the full-fetch path (K9) instead of K3's recheck
        "join5_residual": ({"l": keys5, "r": keys5r},
                           "SELECT COUNT(*) AS x FROM l JOIN r ON "
                           + " AND ".join(f"l.l{i} = r.r{i}" for i in range(5))
                           + " AND l.lv < r.rv", "x"),
        "agg34_sorted": ({"t": single}, f"SELECT a, {sums17} FROM t GROUP BY a", "s16"),
        "agg34_direct": ({"t": single}, f"SELECT s, {sums17} FROM t GROUP BY s", "s16"),
        "agg34_global": ({"t": single}, f"SELECT {sums17} FROM t", "s16"),
        "group17": ({"t": wide17},
                    f"SELECT {cols17}, COUNT(*) AS x FROM t GROUP BY {cols17}", "rows"),
    }


def queue3_answer(rows, what):
    """The number a queue-3 case is held to: the row count ("rows"), else
    the sum of column `what` over the rows."""
    return len(rows) if what == "rows" else sum(r[what] for r in rows)


QUEUE3_JAX = {"case32": 18942, "or33": 56, "or65": 237, "join5": 1057, "join5_residual": 547,
              "agg34_sorted": -25184, "agg34_direct": -25184, "agg34_global": -25184,
              "group17": 500}

_START = time.perf_counter()


def log(msg: str) -> None:
    """One line of output; a phase's line ends with the seconds since the
    script started."""
    if msg.startswith("phase"):
        msg += f" [{time.perf_counter() - _START:.1f} s]"
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

    def tensors(x):   # a JoinTable's strategy tag is no tensor
        return [t for t in _flat(x) if isinstance(t, torch.Tensor)]

    for a, b in zip(tensors(got), tensors(want), strict=True):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"shape/dtype {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
        if a.numel() == 0:
            continue
        if a.is_floating_point():
            bits = torch.int64 if a.dtype == torch.float64 else torch.int32
            if torch.equal(a.view(bits), b.view(bits)):
                continue
            worst = max(worst, float((a - b).abs().max()))
        else:
            if torch.equal(a, b):   # no int64 copy of a large result
                continue
            worst = max(worst, float((a.long() - b.long()).abs().max()))
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
    """nvcc for the kernels, and meanwhile g++ for phase 23's host
    libraries (native/)."""
    import concurrent.futures

    from datafusion_parallelism_tpu_torch import native
    from datafusion_parallelism_tpu_torch.kernels import _build
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        libs = [pool.submit(native.load_library, name) for name in NATIVE_LIBS]
        seconds = _build.build()
        _build.library()
        for f in libs:
            f.result()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"phase 1 ok: kernels built in {seconds:.1f} s, and {', '.join(NATIVE_LIBS)} with "
        f"g++; card: {smi}")
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
    # K1's row mask (a chain-fused build side's build_valid)
    row_mask = torch.from_numpy(rng.random(n) < 0.7).to(device)
    max_abs_err(k1.hash_slot(*args, T, num_rows, row_mask),
                k1.hash_slot_plain(*args, T, num_rows, row_mask))
    variants = join_variants(rng, n, device)
    log(f"phase 2a ok: K1-K4 == plain, exact, on {n}-row inputs: " + "; ".join(names)
        + "; float32/float64 keys with -0.0; non-pow2 T; K1's row mask; and every stage "
        f"(K1-K5, K9-K12) == plain in {len(variants)} joins: " + "; ".join(variants))


def join_variants(rng, n, device):
    """Every join type, residual, late-materialized and chain-fused join
    on seeded inputs, each stage of each (K1-K4, K9-K11 and the K5
    compactions) run through the kernel and its plain version, equal."""
    import torch
    from datafusion_parallelism_tpu_torch.kernels.chain import KERNELS as CHAIN
    from datafusion_parallelism_tpu_torch.kernels.chain import PLAIN as CHAIN_PLAIN
    from datafusion_parallelism_tpu_torch.kernels.chain import ChainKernels
    from datafusion_parallelism_tpu_torch.ops.expressions import BinOp, Col
    from datafusion_parallelism_tpu_torch.ops.join import PLAIN, JoinType, hash_join
    from datafusion_parallelism_tpu_torch.utils.columnar import HostTable

    def checked_chain():
        def stage(kernel, plain):
            def run(*args):
                got = kernel(*args)
                entry_err(kernel.__name__, args, got, plain(*args))
                return got
            return run
        return ChainKernels(*(stage(k, p) for k, p in zip(CHAIN, CHAIN_PLAIN)))

    keys = rng.integers(0, n // 4, n)
    b = HostTable.from_numpy({"bk": keys.astype(np.int32), "bf": keys * 0.5,
                              "bl": keys, "bv": rng.random(n)},
                             validity={"bk": rng.random(n) >= 0.1})
    pkeys = rng.integers(0, n // 4, n)
    pf = pkeys * 0.5
    pf[pkeys == 0] = -0.0
    pf[rng.random(n) < 0.01] = np.nan
    p = HostTable.from_numpy({"pk": pkeys.astype(np.int32), "pf": pf, "pl": pkeys,
                              "pv": rng.random(n).astype(np.float32)},
                             validity={"pk": rng.random(n) >= 0.1})
    build, probe = b.to_device(n + n // 3, device=device), p.to_device(device=device)
    below = BinOp("<", Col("bv"), Col("pv"))
    residual = lambda pair: below.eval(pair)[:2]   # noqa: E731
    bvalid = torch.from_numpy(rng.random(build.capacity) < 0.6).to(device)
    pvalid = torch.from_numpy(rng.random(probe.capacity) < 0.6).to(device)
    cases = [(t.name, ["bk"], ["pk"], {}) for t in JoinType]
    cases += [(f"{t} residual", ["bk"], ["pk"], {"residual": residual})
              for t in ("INNER", "LEFT", "FULL", "LEFT_SEMI", "RIGHT_ANTI")]
    cases += [(f"{t} expanded", ["bk"], ["pk"], {"expanded": True})
              for t in ("INNER", "LEFT_ANTI", "RIGHT_SEMI")]
    cases += [("LEFT_SEMI expanded residual", ["bk"], ["pk"],
               {"expanded": True, "residual": residual})]
    cases += [(f"{t} build_valid/probe_valid", ["bk"], ["pk"],
               {"build_valid": bvalid, "probe_valid": pvalid})
              for t in ("INNER", "LEFT", "RIGHT_ANTI")]
    cases += [("INNER float64 keys", ["bf"], ["pf"], {}), ("FULL float64 keys", ["bf"], ["pf"], {}),
              ("INNER int32 x int64 keys", ["bk"], ["pl"], {}),
              ("LEFT int64 x int32 two keys", ["bl", "bk"], ["pk", "pl"], {}),
              ("RIGHT return_visited", ["bk"], ["pk"], {"return_visited": True})]
    labels = []
    for label, bk, pk, kw in cases:
        jt = JoinType[label.split()[0]]
        got = hash_join(build, probe, bk, pk, jt, 4 * n, kernels=Checked().stages,
                        chain=checked_chain(), **kw)
        with no_launches():
            want = hash_join(build, probe, bk, pk, jt, 4 * n, kernels=PLAIN, chain=CHAIN_PLAIN,
                             **kw)
        tables_equal(got[0], want[0])
        max_abs_err(got[1:], want[1:])   # (mask,) total (, visited)
        rows = int(got[1].sum()) if kw.get("expanded") else int(got[0].num_rows)
        labels.append(f"{label} {rows} rows")
    return labels


def _strategy_hashes(rng, cap, T, device):
    """(hashes int32[cap], ok bool[cap]) for the SORT/OA builds: hashes
    drawn from cap/2 values (repeats), a 6,000-row cluster of hashes that
    share the home slot T // 3 (displaced by thousands of slots under OA),
    10% null keys and the last eighth past num_rows."""
    import torch
    h = rng.choice(rng.integers(0, 1 << 32, cap // 2, dtype=np.uint64), cap)
    h[rng.choice(cap, 6000, replace=False)] = _home_hashes(rng, T, T // 3, 6000)
    ok = rng.random(cap) >= 0.10
    ok[cap - cap // 8:] = False
    as_i32 = h.astype(np.uint32).view(np.int32)
    return (torch.from_numpy(as_i32.copy()).to(device), torch.from_numpy(ok).to(device),
            as_i32)


def _home_hashes(rng, T, home, count):
    """`count` uint32 hashes whose slot_of(., T) is `home`."""
    if T & (T - 1) == 0:
        return home + T * rng.integers(0, (1 << 32) // T, count, dtype=np.uint64)
    return rng.integers(-(-home * (1 << 32) // T), -(-(home + 1) * (1 << 32) // T), count,
                        dtype=np.uint64)


# K14's and K15's edge cases: (name, capacity on the card, capacity in the
# host's replays, what the case changes); every other build row has a
# random hash, 10% of them null keys
STRATEGY_EDGES = (
    ("capacity 1", 1, 1, {"valid": 1.0}),
    ("capacity 8 (one bucket)", 8, 8, {}),
    ("every row invalid", 5000, 5000, {"valid": 0.0}),
    ("one hash across the build", 1 << 20, 5000, {"one_hash": True}),
    ("hashes 0 and 2^32 - 1", 1 << 16, 5000, {"ends": True}),
    ("about 100 keys (more buckets than keys)", 1 << 20, 1 << 14, {"keys": 100}),
    ("sparse build, 2% valid (empty buckets)", 1 << 22, 5000, {"valid": 0.02}),
    ("a hot key past a fill tile's scan (70,000 rows)", 1 << 17, 1 << 17, {"hot": 70_000}),
    ("a one-home cluster over three tiles", 1 << 16, 1 << 14, {"tiles": 3}),
    ("T not a power of two", 3 * (1 << 20) + 5, 3 * (1 << 12) + 5, {"cluster": 1500}),
    ("repeats, nulls and padding", 1 << 16, 5000, {"repeats": 200}),
)
EDGE_PROBE_ROWS = {True: 1 << 22, False: 20_000}   # at most, on the card / on the host


def strategy_edge(name: str, on_card: bool = True):
    """(build hashes uint32[cap], ok bool[cap], probe hashes uint32[m],
    probe ok bool[m]) of the STRATEGY_EDGES case `name`, seeded by its
    place in the list, at its capacity on the card or (on_card=False) in
    the host's replays. The probe rows: 70% build hashes, the rest random,
    the first four 0, 2^32 - 1, 1 and 2^31, 5% not ok; where one hash is
    hot, all but a few probe rows miss it."""
    from datafusion_parallelism_tpu_torch.kernels.oa_place import PLACE_TILE
    from datafusion_parallelism_tpu_torch.ops.hash_table import table_size_for
    i = [e[0] for e in STRATEGY_EDGES].index(name)
    _, card_cap, host_cap, edit = STRATEGY_EDGES[i]
    rng = np.random.default_rng(140 + i)
    cap = card_cap if on_card else host_cap
    T = table_size_for(cap)
    h = rng.integers(0, 1 << 32, cap, dtype=np.uint64)
    ok = rng.random(cap) >= 0.1
    hot = None
    if "valid" in edit:
        ok = rng.random(cap) < edit["valid"]
    if "keys" in edit:
        ok = rng.random(cap) < edit["keys"] / cap
    if "one_hash" in edit:
        h[:], ok[:], hot = 0x9E3779B9, True, 0x9E3779B9
    if "ends" in edit:
        h[rng.random(cap) < 0.3] = 0
        h[rng.random(cap) < 0.3] = (1 << 32) - 1
    if "hot" in edit:                 # more keys than DIR_SCAN_KEYS in one fill tile
        h[:edit["hot"]], ok[:edit["hot"]], hot = 0x12345678, True, 0x12345678
    if "tiles" in edit or "cluster" in edit:
        n = edit["cluster"] if "cluster" in edit else edit["tiles"] * PLACE_TILE + 11
        at = rng.choice(cap, n, replace=False)
        h[at] = _home_hashes(rng, T, T // 3, n)
        ok[at] = True
    if "repeats" in edit:
        h = rng.choice(h[:edit["repeats"]], cap)
        ok[cap - cap // 6:] = False
    m = min(max(2 * cap, 64), EDGE_PROBE_ROWS[on_card])
    pool = h[ok] if ok.any() else h
    ph = np.where(rng.random(m) < 0.7, rng.choice(pool, m),
                  rng.integers(0, 1 << 32, m, dtype=np.uint64))
    if hot is not None:
        ph[rng.random(m) < 0.9999] = 7
        ph[4:8] = hot
    ph[:4] = [0, (1 << 32) - 1, 1, 1 << 31]
    return h.astype(np.uint32), ok, ph.astype(np.uint32), rng.random(m) >= 0.05


def plans_agree(mods) -> None:
    """Each (label, module)'s launch plan as compiled == the wrapper's copy
    (which the host's replays read)."""
    for label, mod in mods:
        mine = {name: getattr(mod, name) for name in mod.PLAN}
        if mod.compiled_plan() != mine:
            raise AssertionError(f"{label}: compiled plan {mod.compiled_plan()}, the wrapper "
                                 f"has {mine}")


def strategy_plans_agree(shapes) -> None:
    """K14's, K15's and K16's launch plans and scratch bytes as compiled ==
    their wrappers' copies, at each (probe rows m, capacity) of `shapes`."""
    from datafusion_parallelism_tpu_torch.kernels import oa_place as k15
    from datafusion_parallelism_tpu_torch.kernels import oa_probe as k16
    from datafusion_parallelism_tpu_torch.kernels import sorted_probe as k14
    plans_agree((("K14", k14), ("K15", k15), ("K16", k16)))
    for m, cap in shapes:
        bits = k14.directory_bits(cap)
        compiled = (k14.compiled_scratch_bytes(m, bits), k15.compiled_scratch_bytes(cap),
                    k16.compiled_scratch_bytes(m))
        mine = (k14.scratch_bytes(m, bits), k15.scratch_bytes(cap), k16.scratch_bytes(m))
        if compiled != mine:
            raise AssertionError(f"m {m}, capacity {cap}: scratch K14 / K15 / K16 {compiled} "
                                 f"bytes compiled, the wrappers say {mine}")


def kernel_twice(label, kernel, plain, args):
    """kernel(*args) twice against plain(*args): equal bit for bit, the
    same bits twice; returns the kernel's result."""
    import torch
    try:
        got = kernel(*args)
        again = kernel(*args)
        with no_launches():
            want = plain(*args)
        torch.cuda.synchronize()
        max_abs_err(got, want)
        max_abs_err(again, got)
    except AssertionError as e:
        raise AssertionError(f"{label}: {e}") from None
    return got


def strategy_kernel_edges(device) -> list:
    """K14, K15 and K16 against their plain versions bit for bit on their
    edge cases, each run twice with the same bits (K16 on K15's table,
    where its walks stay short enough for the plain version's lockstep
    loop), then K16's own cases (`K16_EDGES`); their compiled launch plans
    and scratch bytes against the wrappers' (at each case's shapes and
    Q7's)."""
    import torch
    from datafusion_parallelism_tpu_torch.kernels import oa_place as k15
    from datafusion_parallelism_tpu_torch.kernels import oa_probe as k16
    from datafusion_parallelism_tpu_torch.kernels import sorted_probe as k14
    from datafusion_parallelism_tpu_torch.ops.hash_table import (oa_slots_for, slot_of,
                                                                 table_size_for)
    lines = []
    shapes = [(1 << 26, 1 << 25)]                  # Q7's K14 and K15 calls
    for name, *_ in STRATEGY_EDGES:
        h_np, ok_np, ph_np, pok_np = strategy_edge(name)
        h = torch.from_numpy(h_np.view(np.int32).copy()).to(device)
        ok = torch.from_numpy(ok_np).to(device)
        ph = torch.from_numpy(ph_np.view(np.int32).copy()).to(device)
        pok = torch.from_numpy(pok_np).to(device)
        cap = h.shape[0]
        shapes.append((ph.shape[0], cap))
        sh = torch.sort(torch.where(ok, h.long() & 0xFFFFFFFF, 1 << 33)).values
        T = table_size_for(cap)
        home = slot_of(h, T)
        order = torch.argsort(torch.where(ok, (home.long() << 32) | (h.long() & 0xFFFFFFFF),
                                          1 << 62), stable=True).to(torch.int32)
        kernel_twice(f"K14 {name}", k14.sorted_probe, k14.sorted_probe_plain, (ph, pok, sh))
        slots, _ = kernel_twice(f"K15 {name}", k15.oa_place, k15.oa_place_plain,
                                (order, home, h, ok, oa_slots_for(T)))
        walks = ""
        if name not in K16_LONG_WALKS:
            ranges = kernel_twice(f"K16 {name}", k16.oa_probe, k16.oa_probe_plain,
                                  (ph[:K16_EDGE_ROWS], pok[:K16_EDGE_ROWS], slots))
            walks = f", K16 total {int(ranges[3])}"
        lines.append(f"{name} (capacity {cap}, {int(ok.sum())} valid, m {ph.shape[0]}, "
                     f"directory bits {k14.directory_bits(cap)}, T {T}, "
                     f"{k15.place_tiles(int(ok.sum()))} K15 tiles{walks})")
        del h, ok, ph, pok, sh, home, order, slots
        torch.cuda.empty_cache()
    for name, *_ in K16_EDGES:
        h, ok, ph, pok = (torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
                          .to(device) for a in k16_edge(name))
        slots = k16_table(h, ok)
        shapes.append((ph.shape[0], h.shape[0]))
        ranges = kernel_twice(f"K16 {name}", k16.oa_probe, k16.oa_probe_plain, (ph, pok, slots))
        lines.append(f"K16 {name} (capacity {h.shape[0]}, S {slots.shape[0]}, m {ph.shape[0]}, "
                     f"{int(pok.sum())} ok, {k16.probe_tiles(ph.shape[0])} tiles, total "
                     f"{int(ranges[3])}, longest run {int(ranges[1].max())})")
    strategy_plans_agree(shapes)
    return lines + ["launch plans and scratch bytes as compiled"]


# the STRATEGY_EDGES cases whose probe walks a run too long for K16's
# plain version on the card (its lockstep loop takes a step a slot, over
# every probe row: K16 takes the first K16_EDGE_ROWS of the others')
K16_LONG_WALKS = ("one hash across the build",)
K16_EDGE_ROWS = 1 << 16
# K16's own cases: (name, what the case is); each builds an OA table over
# capacity 16,384 (T = 65,536 by the 64k floor, S = 81,920)
K16_EDGES = (
    ("a walk to the spill's end", "every build row homed at T - 1 under three hashes, so "
     "the last run ends at slot S - 2; probes on them and on two more hashes homed there"),
    ("m not a multiple of the tile", "5 tiles and 7 rows of probes"),
    ("m = 1", "one probe row, on a build hash"),
    ("no probe row ok", "every probe row without ok"),
)


def k16_edge(name: str):
    """(build hashes uint32[cap], build ok bool[cap], probe hashes
    uint32[m], probe ok bool[m]) of the K16_EDGES case `name`, seeded by
    its place in the list; the same on the card and on the host."""
    from datafusion_parallelism_tpu_torch.kernels.oa_probe import PROBE_TILE
    from datafusion_parallelism_tpu_torch.ops.hash_table import table_size_for
    i = [e[0] for e in K16_EDGES].index(name)
    rng = np.random.default_rng(150 + i)
    cap = 16_384
    T = table_size_for(cap)
    h = rng.integers(0, 1 << 32, cap, dtype=np.uint64)
    ok = rng.random(cap) >= 0.1
    m = 4000
    if name == "a walk to the spill's end":
        five = _home_hashes(rng, T, T - 1, 5)
        h, ok = rng.choice(five[:3], cap), np.ones(cap, bool)
        ph = np.where(rng.random(m) < 0.5, rng.choice(five, m),
                      rng.integers(0, 1 << 32, m, dtype=np.uint64))
        return h.astype(np.uint32), ok, ph.astype(np.uint32), rng.random(m) >= 0.05
    if name == "m not a multiple of the tile":
        m = 5 * PROBE_TILE + 7
    if name == "m = 1":
        m = 1
    ph = np.where(rng.random(m) < 0.7, rng.choice(h[ok], m),
                  rng.integers(0, 1 << 32, m, dtype=np.uint64))
    pok = rng.random(m) >= 0.05
    if name == "m = 1":
        pok[:] = True
    if name == "no probe row ok":
        pok[:] = False
    return h.astype(np.uint32), ok, ph.astype(np.uint32), pok


def k16_table(h, ok):
    """The OA table's slots over build hashes int32[cap] where `ok`, by the
    plain build (K6's, K15's and K5's plain versions)."""
    import torch
    from datafusion_parallelism_tpu_torch.kernels import filter_compact as k5
    from datafusion_parallelism_tpu_torch.kernels import oa_place as k15
    from datafusion_parallelism_tpu_torch.kernels import radix_sort as k6
    from datafusion_parallelism_tpu_torch.ops.hash_table import oa_table_rows, table_size_for
    no_rows = torch.empty((0, h.shape[0]), dtype=torch.int32, device=h.device)
    with no_launches():
        table, _ = oa_table_rows(h, ok, table_size_for(h.shape[0]), no_rows,
                                 k6.radix_sort_plain, k15.oa_place_plain, k5.gather_rows_plain)
    return table.sorted_hash


def phase_strategy_kernels_vs_plain(device, n: int = 1 << 18) -> None:
    """Phase 2c: K14-K16 and K3's ranges entry against their plain versions
    on seeded hashes (repeats, null keys, padding, a one-home cluster), at
    a power-of-two and a Lemire table size; the SORT and OA joins with
    every stage checked; K14, K15 and K16 on their edge cases, twice
    (`strategy_kernel_edges`); K17 on every expression class x dtype."""
    import torch
    from datafusion_parallelism_tpu_torch.kernels import filter_compact as k5
    from datafusion_parallelism_tpu_torch.kernels import oa_place as k15
    from datafusion_parallelism_tpu_torch.kernels import oa_probe as k16
    from datafusion_parallelism_tpu_torch.kernels import probe_expand as k3
    from datafusion_parallelism_tpu_torch.kernels import radix_sort as k6
    from datafusion_parallelism_tpu_torch.kernels import sorted_probe as k14
    from datafusion_parallelism_tpu_torch.ops.hash_table import (oa_table_rows, slot_of,
                                                                 sort_table_rows, table_size_for)
    rng = np.random.default_rng(14)
    lines = []
    for cap in (n, 3 * (n // 4)):                 # T = 4 cap: a power of two, then not
        T = table_size_for(cap)
        h, ok, h_np = _strategy_hashes(rng, cap, T, device)
        rows = torch.stack([h, ok.to(torch.int32)])          # key word, validity word
        home = slot_of(h, T)
        sort_k = sort_table_rows(h, ok, rows, k6.radix_sort, k5.gather_rows)
        with no_launches():
            sort_p = sort_table_rows(h, ok, rows, k6.radix_sort_plain, k5.gather_rows_plain)
        max_abs_err(sort_k, sort_p)
        oa_k = oa_table_rows(h, ok, T, rows, k6.radix_sort, k15.oa_place, k5.gather_rows)
        with no_launches():
            oa_p = oa_table_rows(h, ok, T, rows, k6.radix_sort_plain, k15.oa_place_plain,
                                 k5.gather_rows_plain)
        max_abs_err(oa_k, oa_p)
        # the cluster's displacement: its farthest row's slot past the home slot
        pos = torch.nonzero(oa_k[0].sorted_hash != 0).flatten()
        in_cluster = home[oa_k[0].perm[pos].long()] == T // 3
        displaced = int((pos[in_cluster] - T // 3).max())
        if displaced < 1000:
            raise AssertionError(f"the one-home cluster reached only {displaced} slots past home")
        # probe rows: build hashes, cluster hashes, unknown hashes; nulls
        m = cap // 2
        ph_np = np.where(rng.random(m) < 0.7, rng.choice(h_np, m),
                         rng.integers(-(1 << 31), 1 << 31, m).astype(np.int32))
        ph = torch.from_numpy(ph_np.astype(np.int32)).to(device)
        pok = torch.from_numpy(rng.random(m) >= 0.05).to(device)
        pwords = torch.stack([ph, pok.to(torch.int32)])
        compares = [([0], [0], (1, 0), (1, 0))]
        sh, slots = sort_k[0].sorted_hash, oa_k[0].sorted_hash
        for label, trows, probe, plain in (
                ("SORT", sort_k[1], lambda: k14.sorted_probe(ph, pok, sh),
                 lambda: k14.sorted_probe_plain(ph, pok, sh)),
                ("OA", oa_k[1], lambda: k16.oa_probe(ph, pok, slots),
                 lambda: k16.oa_probe_plain(ph, pok, slots))):
            ranges = probe()
            with no_launches():
                max_abs_err(ranges, plain())
            out_cap = int(ranges[3]) + 17
            got = k3.expand_ranges(*ranges, pwords, trows, compares, out_cap)
            with no_launches():
                max_abs_err(got, k3.expand_ranges_plain(*ranges, pwords, trows, compares,
                                                        out_cap))
            lines.append(f"{label} T={T}: {int(ranges[3])} candidates, "
                         f"{int(got[0].sum())} matches")
        lines.append(f"OA T={T}: cluster displaced {displaced} slots")
    lines += strategy_join_variants(rng, n // 4, device)
    lines.append("K14, K15 and K16 edge cases, twice with the same bits: "
                 + ", ".join(strategy_kernel_edges(device)))
    lines.append(expr_kernel_vs_plain(rng, device))
    lines.append(expr_tile_edges(rng, device))
    log("phase 2c ok: K14 sorted_probe, K15 oa_place, K16 oa_probe, K3's expand_ranges and "
        "the SORT/OA builds (K6, K5) == plain, exact; " + "; ".join(lines))


def _radix_edge_cases(rng, device):
    """(name, words [k, n] int32, signed flags) for K6's edge cases."""
    import torch
    from datafusion_parallelism_tpu_torch.kernels import radix_sort as k6
    from datafusion_parallelism_tpu_torch.utils.columnar import int64_words

    def words(*rows):
        return torch.from_numpy(np.stack(rows).astype(np.int32)).to(device)

    def full(n):
        return rng.integers(-2**31, 2**31, n)

    def split(v):   # an int64 key: its signed high word, its unsigned low word
        lo, hi = int64_words(torch.from_numpy(v).to(device))
        return torch.stack([hi, lo])

    m = 1 << 20
    t32, t64 = k6.TILE_ROWS[32], k6.TILE_ROWS[64]
    extremes = rng.integers(-2**63, 2**63 - 1, m, dtype=np.int64)
    extremes[rng.random(m) < 0.2] = np.iinfo(np.int64).min
    extremes[rng.random(m) < 0.2] = np.iinfo(np.int64).max
    extremes[rng.random(m) < 0.1] = -1
    hot = rng.integers(-2**31, 2**31, m)
    hot[rng.random(m) < 0.9] = 0x5A5A5A5A
    big = (1 << 24) + 3
    return [
        ("n = 1", words(full(1), full(1)), [True, False]),
        ("one 32-bit tile - 1", words(full(t32 - 1)), [False]),
        ("one 32-bit tile + 1", words(full(t32 + 1)), [True]),
        ("one 64-bit tile - 1", words(full(t64 - 1), full(t64 - 1)), [True, False]),
        ("one 64-bit tile + 1", words(full(t64 + 1), full(t64 + 1)), [False, True]),
        ("B = 0, one value in every row", words(np.full(m, -7), np.full(m, 9)), [True, False]),
        ("B = 1", words(rng.choice([5, 7], m)), [True]),
        ("B = 32", words(full(m)), [True]),
        ("B = 33", words(rng.integers(0, 2, m), full(m)), [False, False]),
        ("B = 64", words(full(m), full(m)), [True, False]),
        ("B = 96", words(full(m), full(m), full(m)), [False, True, False]),
        ("signed int64 with negatives and extremes", split(extremes), [True, False]),
        ("already sorted", split(np.sort(rng.integers(-2**40, 2**40, m))), [True, False]),
        ("reverse sorted", split(np.sort(rng.integers(-2**40, 2**40, m))[::-1].copy()),
         [True, False]),
        ("a single hot digit (90% one value)", words(hot), [True]),
        ("2^24 + 3 rows, B = 33", words(rng.integers(0, 2, big), full(big)), [False, False]),
        ("2^24 + 3 rows, B = 96", words(full(big), full(big), full(big)),
         [True, False, False]),
    ]


def phase_radix_edges(device) -> None:
    """K6 against its plain version bit for bit on seeded edge cases: one
    row, a tile's rows plus and minus one, 2^24 + 3 rows, 0 to 96 varying
    bits, int64 extremes, sorted and reverse-sorted input, one value in
    every row, a hot digit."""
    import torch
    from datafusion_parallelism_tpu_torch.kernels import radix_sort as k6
    rng = np.random.default_rng(26)
    lines = []
    for name, words, signed in _radix_edge_cases(rng, device):
        with no_launches():
            want = k6.radix_sort_plain(words, signed)
        got = k6.radix_sort(words, signed)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"K6 {name}: {bad} of {want.numel()} positions differ")
        plan = k6.planned(words, signed)
        lines.append(f"{name} ({words.shape[1]} rows, {words.shape[0]} words, {plan.bits} bits, "
                     f"{plan.key_bits}-bit key, {len(plan.passes)} passes)")
        del words, want, got
    log("phase 2d ok: K6 == radix_sort_plain bit for bit: " + "; ".join(lines))


def _random_rows(rng, w, f, cap, device):
    """Packed rows on the card: int32 words [w, cap] and float64 sidecars
    [f, cap] of random 64-bit patterns (NaN payloads and denormals among
    them)."""
    import torch
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (w, cap), dtype=np.int64)
                             .astype(np.int32)).to(device)
    bits = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, (f, cap), dtype=np.int64))
    return words, bits.view(torch.float64).to(device)


def _count(n, device):
    import torch
    return torch.tensor(n, dtype=torch.int32, device=device)


def _row_copy_cases(rng, device):
    """(name, kernel, args) for K13's and K11's edge cases: K13 (acc,
    acc_f64, acc_rows, words, f64, num_rows) at acc_rows = 0-3 mod 4, no
    rows, a partition capacity past acc_cap, rows dropped past acc_cap, a
    full accumulator, F = 0, more rows than the partition's capacity and a
    large unaligned append; K11 ([parts]) with 1 and 8 parts, empty parts
    between full ones, part boundaries inside a tile, F = 0 and two large
    parts whose boundary is unaligned."""
    cases = []

    def append(name, w, f, acc_cap, acc_rows, cap, n):
        acc, acc_f64 = _random_rows(rng, w, f, acc_cap, device)
        words, f64 = _random_rows(rng, w, f, cap, device)
        cases.append((f"K13 {name} (W {w}, F {f}, acc_cap {acc_cap}, acc_rows {acc_rows}, "
                      f"cap {cap}, num_rows {n})", "append_rows",
                      (acc, acc_f64, _count(acc_rows, device), words, f64, _count(n, device))))

    for r in range(4):
        append(f"acc_rows = {r} mod 4", 5, 2, 16384, 1024 + r, 4096, 3001)
    append("no rows", 5, 2, 16384, 7, 4096, 0)
    append("partition capacity past acc_cap, rows dropped past it", 3, 1, 4096, 17, 8192,
           6000)
    append("rows dropped past acc_cap", 5, 2, 16384, 14000, 4096, 4000)
    append("acc_rows == acc_cap", 5, 2, 16384, 16384, 4096, 100)
    append("F = 0", 4, 0, 16384, 333, 4096, 2500)
    append("num_rows past the partition's capacity", 5, 2, 16384, 2, 4096, 5000)
    append("large, unaligned", 13, 2, 1 << 24, (1 << 22) + 12345, 1 << 22, 1 << 22)

    def concat(name, w, f, caps, ns):
        parts = [(*_random_rows(rng, w, f, c, device), _count(n, device))
                 for c, n in zip(caps, ns)]
        cases.append((f"K11 {name} (W {w}, F {f}, caps {caps}, num_rows {ns})",
                      "concat_rows", (parts,)))

    concat("1 part", 5, 2, (1000,), (777,))
    concat("8 parts", 4, 1, (4096, 64, 1000, 3, 4097, 128, 1, 9000),
           (4000, 64, 999, 3, 4097, 1, 1, 8191))
    concat("empty parts between full ones", 3, 2, (4096, 512, 4096, 100, 4096),
           (4096, 0, 4096, 0, 4095))
    concat("part boundaries inside a tile", 6, 1, (4097, 1, 3), (4097, 1, 3))
    concat("part boundaries inside a tile, short parts", 6, 1, (4097, 1, 3), (4001, 0, 2))
    concat("F = 0", 5, 0, (5000, 3000), (4999, 2001))
    concat("no rows", 2, 1, (128, 64), (0, 0))
    concat("large, unaligned boundary", 7, 1, ((1 << 22) + 5, (1 << 20) + 3),
           ((1 << 22) + 1, (1 << 20) + 3))
    return cases


def gather_layout_edges(rng, device) -> str:
    """K5's gather in each layout (kernels/filter_compact.py `_gather`) and
    through `gather_rows` (the layout `gather_layout` picks) bit for bit
    against gather_rows_plain: cap 0, m 0, n 0, n > m, idx out of range
    (clipped), words only, sidecars only, and sources whose word rows fit
    the L2 and do not."""
    import torch
    from datafusion_parallelism_tpu_torch.kernels import _build
    from datafusion_parallelism_tpu_torch.kernels import filter_compact as k5
    l2 = _build.device_limits(device).l2_bytes
    above = l2 // 4 + 4097                     # a word row past the L2
    cases = [("cap 0", 3, 1, 0, 0, 0), ("cap 0, no n", 2, 0, 0, 0, None),
             ("m 0", 3, 1, 1000, 0, None),
             ("n 0", 4, 2, 5000, 3000, 0), ("n > m", 4, 1, 5000, 3000, 4000),
             ("n < m", 5, 0, 5000, 3000, 1234), ("no n", 2, 2, 5000, 7001, None),
             ("words only", 7, 0, 100_000, 65_537, None), ("sidecars only", 0, 3, 100_000,
                                                            65_537, 777),
             ("below the L2", 5, 1, 1 << 20, 1 << 20, (1 << 20) - 33),
             (f"above the L2 ({above} rows)", 2, 1, above, 1 << 20, 700_001)]
    names = []
    for name, W, F, cap, m, n in cases:
        words, f64 = _random_rows(rng, W, F, cap, device)
        # out-of-range ids (clipped) among the in-range ones
        idx = torch.from_numpy(rng.integers(-5, cap + 5, m).astype(np.int32)).to(device)
        count = None if n is None else torch.tensor(n, dtype=torch.int64, device=device)
        with no_launches():
            want = k5.gather_rows_plain(words, f64, idx, count)
        for layout in (k5.GATHER_WORD, k5.GATHER_WORD4):
            try:
                max_abs_err(k5._gather(words, f64, idx, count, layout), want)
            except AssertionError as e:
                raise AssertionError(f"K5 gather {name}, layout {layout}: {e}") from None
        max_abs_err(k5.gather_rows(words, f64, idx, count), want)
        names.append(f"{name} (W {W}, F {F}, cap {cap}, m {m}, n {n}; "
                     f"layout {k5.gather_layout(cap, F, l2)})")
        del words, f64, idx, want
    torch.cuda.synchronize()
    return ("K5's gather == gather_rows_plain bit for bit in both layouts: "
            + "; ".join(names))


def phase_row_copy_edges(device) -> None:
    """K13 and K11 against their plain versions bit for bit (float64
    sidecars as their bits) on seeded edge cases (_row_copy_cases): the
    accumulator K13 writes in place, the count, K11's matrices and total."""
    import torch
    from datafusion_parallelism_tpu_torch.kernels import append_rows as k13
    from datafusion_parallelism_tpu_torch.kernels import concat_rows as k11
    kernel = {"append_rows": (k13.append_rows, k13.append_rows_plain),
              "concat_rows": (k11.concat_rows, k11.concat_rows_plain)}
    rng = np.random.default_rng(13)
    names = []
    for name, entry, args in _row_copy_cases(rng, device):
        fn, plain = kernel[entry]
        if entry == "append_rows":
            key = ("chain", "append_rows")
            with no_launches():
                want = run_call(key, plain, args)
            got = run_call(key, fn, args)
        else:
            with no_launches():
                want = plain(*args)
            got = fn(*args)
        torch.cuda.synchronize()
        try:
            max_abs_err(got, want)
        except AssertionError as e:
            raise AssertionError(f"{name}: {e}") from None
        names.append(name)
        del args, got, want
    log("phase 2e ok: K13 == append_rows_plain and K11 == concat_rows_plain bit for bit: "
        + "; ".join(names) + "; " + gather_layout_edges(rng, device))


def _csr_build_edges(rng, device):
    """(name, slot int32[n] on the card, T, rows [R, n]) of K2's edge cases."""
    import torch
    from datafusion_parallelism_tpu_torch.utils.columnar import round_capacity

    def on(x):
        return torch.from_numpy(np.asarray(x).astype(np.int32)).to(device)

    def rows(r, n):
        return on(rng.integers(-2**31, 2**31, (r, n)))

    big = round_capacity((1 << 26) + 1)          # past 64 M: a multiple of 4 M
    hot = rng.integers(0, 1 << 24, 1 << 22)
    hot[rng.random(1 << 22) < 0.5] = 777
    sparse = np.full(1 << 21, 1 << 30)
    sparse[: 1 << 17] = rng.integers(0, 1 << 30, 1 << 17)
    return [
        ("T = 2^20 (a power of two)", on(rng.integers(0, (1 << 20) + 1, 1 << 18)), 1 << 20,
         rows(3, 1 << 18)),
        (f"T = 4 x {big} (a capacity past 64 M; not a power of two, 29 bits)",
         on(rng.integers(0, 4 * big + 1, big)), 4 * big, rows(1, big)),
        ("T = 1", on(rng.integers(0, 2, 100_003)), 1, rows(2, 100_003)),
        ("T = 255 (one digit pass)", on(rng.integers(0, 256, 100_003)), 255, rows(2, 100_003)),
        ("bits(T) = 25", on(rng.integers(0, (1 << 24) + 1, 1 << 22)), 1 << 24, rows(2, 1 << 22)),
        ("bits(T) = 28", on(rng.integers(0, (1 << 27) + 1, 1 << 25)), 1 << 27, rows(3, 1 << 25)),
        ("bits(T) = 31 (T = 2^30), sparse: 6% valid, the rest in bucket T", on(sparse),
         1 << 30, rows(1, 1 << 21)),
        ("n = 1", on([5]), 1 << 16, rows(3, 1)),
        ("n = 0", on(np.zeros(0)), 1 << 16, rows(2, 0)),
        ("n not a multiple of the tile (5 x 8192 + 77)", on(rng.integers(0, 1 << 18, 41_037)),
         1 << 18, rows(2, 41_037)),
        ("every row in bucket T", on(np.full(1 << 20, 1 << 22)), 1 << 22, rows(2, 1 << 20)),
        ("one bucket spanning many tiles (half the rows)", on(hot), 1 << 24, rows(2, 1 << 22)),
        ("R = 0 (build_csr's no_rows)", on(rng.integers(0, (1 << 22) + 1, 1 << 20)), 1 << 22,
         rows(0, 1 << 20)),
    ]


def _probe_edges(rng, device):
    """(name, build slot, probe slot, probe ok, T, key count, out_cap as a
    function of the total) of K3's edge cases."""
    import torch

    def on(x, dtype=torch.int32):
        return torch.from_numpy(np.asarray(x)).to(dtype).to(device)

    n, m, T = 1 << 20, (1 << 20) + 3, 1 << 22
    uniform = (on(rng.integers(0, T, n)), on(rng.integers(0, T, m)),
               on(rng.random(m) < 0.9, torch.bool))
    one = np.full(m, 5)
    one[m // 3] = 9
    hot_b = rng.integers(0, T, n)
    hot_b[rng.random(n) < 0.01] = 11      # ~10,000 candidates of one key
    hot_p = rng.integers(0, T, m)
    hot_p[rng.integers(0, m, 40)] = 11    # ~10,000 candidates each, across many blocks
    return [
        ("total 0", *uniform[:2], on(np.zeros(m, bool), torch.bool), T, 1, lambda t: 1000),
        ("one probe row owns every candidate", on(np.full(n, 9)), on(one),
         on(np.ones(m, bool), torch.bool), T, 1, lambda t: t),
        ("out_cap below the total", *uniform, T, 1, lambda t: t // 2 + 1),
        ("out_cap equal to the total", *uniform, T, 1, lambda t: t),
        ("out_cap above the total", *uniform, T, 1, lambda t: t + 10_000),
        ("m = 1", uniform[0], on([int(rng.integers(0, T))]), on([True], torch.bool), T, 1,
         lambda t: max(t, 1)),
        ("m = 1 on a hot key", on(np.full(n, 3)), on([3]), on([True], torch.bool), T, 1,
         lambda t: t),
        ("five keys (and_match)", *uniform, T, 5, lambda t: t),
        ("block boundaries inside probe rows' candidates", on(hot_b), on(hot_p),
         on(np.ones(m, bool), torch.bool), T, 2, lambda t: t),
    ]


def phase_csr_edges(device) -> None:
    """K2 and K3 against their plain versions bit for bit on seeded edge
    cases: K2 at T = 1, 255, a power of two and not one (a capacity past
    64 M), bits(T) = 25, 28 and 31, n = 0, 1 and not a multiple of the
    tile, every row in bucket T, a sparse build, one bucket over many
    tiles, R = 0; K3's probe_ranges and expand_ranges with total 0, one
    probe row owning every candidate, out_cap below, equal to and above the
    total, m = 1, five keys (two launches, and_match), block boundaries
    inside probe rows' candidates."""
    import torch
    from datafusion_parallelism_tpu_torch.kernels import csr_build as k2
    from datafusion_parallelism_tpu_torch.kernels import probe_expand as k3
    rng = np.random.default_rng(210)
    lines = []
    for name, slot, T, rows in _csr_build_edges(rng, device):
        with no_launches():
            want = k2.csr_build_plain(slot, T, rows)
        got = k2.csr_build(slot, T, rows)
        torch.cuda.synchronize()
        try:
            max_abs_err(got, want)
        except AssertionError as e:
            raise AssertionError(f"K2 {name}: {e}") from None
        lines.append(f"K2 {name} (n {slot.shape[0]}, T {T}, R {rows.shape[0]}, "
                     f"passes {k2.digit_passes(T)})")
        del slot, rows, got, want
        torch.cuda.empty_cache()
    for name, bslot, pslot, ok, T, keys, cap_of in _probe_edges(rng, device):
        n, m = bslot.shape[0], pslot.shape[0]
        brows = torch.from_numpy(np.stack([rng.integers(0, 2, n) for _ in range(5)]
                                          + [rng.integers(0, 2**31, n)]).astype(np.int32))
        brows = brows.to(device)
        _, offsets, _, _, bwords = k2.csr_build(bslot, T, brows)
        # the same rows row-major (7 words padded to 8), as the deferred
        # join's K2 writes them, and equal to the plain version's
        rm = k2.csr_build(bslot, T, brows, True)
        with no_launches():
            max_abs_err(rm, k2.csr_build_plain(bslot, T, brows, True))
        # the probe's words in the build's layout (words 0-4 values in
        # {0, 1}, word 5 validity bits); `keys` key columns of one word each
        pwords = torch.from_numpy(np.stack([rng.integers(0, 2, m) for _ in range(5)]
                                           + [rng.integers(0, 2**31, m)]).astype(np.int32))
        pwords = pwords.to(device)
        compares = [([k], [k], (5, k), (5, k)) for k in range(keys)]
        # the deferred join's plan: no build validity test
        probe_only = [(bw, pw, None, pv) for bw, pw, _, pv in compares]
        with no_launches():
            want = k3.probe_ranges_plain(pslot, ok, offsets)
        got = k3.probe_ranges(pslot, ok, offsets)
        out_cap = cap_of(int(got[3]))
        try:
            for plan, label in ((compares, ""), (probe_only, ", no build validity")):
                with no_launches():
                    want_x = k3.expand_ranges_plain(*want, pwords, bwords, plan, out_cap)
                for layout, rows in (("word-major", bwords), ("row-major", rm[4])):
                    got_x = k3.expand_ranges(*got, pwords, rows, plan, out_cap)
                    again = k3.expand_ranges(*got, pwords, rows, plan, out_cap)
                    torch.cuda.synchronize()
                    max_abs_err((got, got_x), (want, want_x))
                    max_abs_err(again, got_x)
        except AssertionError as e:
            raise AssertionError(f"K3 {name} ({layout}{label}): {e}") from None
        lines.append(f"K3 {name} (m {m}, T {T}, total {int(got[3])}, out_cap {out_cap}, "
                     f"{len(k3.key_groups(compares))} key groups, both layouts, with and "
                     "without the build validity test)")
        del got, want, got_x, want_x, again, rm
    lines += k4_edges(rng, device)
    log("phase 2f ok: K2 == csr_build_plain (both layouts), K3 == probe_ranges_plain, "
        "expand_ranges_plain (both layouts) and K4 == compact_gather_plain bit for bit, "
        "the same bits twice: " + "; ".join(lines))


def _k4_columns(rng, cap, device, n_cols=None):
    """(values, validity) columns on the card: every kind the port holds
    (float64 with NaN payloads, -0.0 and denormals, int64 extremes, int32,
    float32 with NaN, bool) with 10% nulls, or `n_cols` int32 columns."""
    import torch

    def col(v):
        return (torch.from_numpy(np.ascontiguousarray(v)).to(device),
                torch.from_numpy(rng.random(cap) >= 0.1).to(device))
    if n_cols is not None:
        return [col(rng.integers(-2**31, 2**31, cap).astype(np.int32)) for _ in range(n_cols)]
    f64 = rng.normal(size=cap)
    f64[rng.random(cap) < 0.01] = -0.0
    f64[rng.random(cap) < 0.01] = 5e-324
    bits = f64.view(np.uint64)
    bits[rng.random(cap) < 0.01] = 0x7FF8000000000000 | 0xBEEF
    i64 = rng.integers(-2**63, 2**63 - 1, cap, dtype=np.int64)
    i64[rng.random(cap) < 0.01] = -2**63
    f32 = rng.normal(size=cap).astype(np.float32)
    f32[rng.random(cap) < 0.01] = np.nan
    return [col(f64), col(i64), col(rng.integers(-2**31, 2**31, cap).astype(np.int32)),
            col(f32), col(rng.random(cap) < 0.5)]


def k4_edges(rng, device):
    """K4 against its plain version bit for bit, each run twice with the
    same bits: n_match 0, n_match = out_cap (every slot a match), total 0,
    total past out_cap, no total, an out_cap off the kernel's tile and
    tail, a side past the descriptor table (70 columns: two launches), and
    every column kind with nulls on both sides."""
    import torch
    from datafusion_parallelism_tpu_torch.kernels import compact_gather as k4
    lines = []
    bcap, pcap = 1 << 20, (1 << 20) + 5
    kinds_b, kinds_p = _k4_columns(rng, bcap, device), _k4_columns(rng, pcap, device)

    def slots(out_cap, total, share):
        j = np.arange(out_cap)
        match = (j < total) & (rng.random(out_cap) < share)
        bid = np.where(j < total, rng.integers(0, bcap, out_cap), 0).astype(np.int32)
        pid = np.where(j < total, np.sort(rng.integers(0, pcap, out_cap)), 0).astype(np.int32)
        return [torch.from_numpy(x).to(device) for x in (match, bid, pid)]

    cases = [("n_match 0", 1 << 21, 1 << 20, 0.0, kinds_b, kinds_p),
             ("every slot a match (n_match = out_cap)", 1 << 21, 1 << 21, 1.0, kinds_b, kinds_p),
             ("total 0", 1 << 20, 0, 0.5, kinds_b, kinds_p),
             ("total past out_cap", 1 << 21, (1 << 21) + 999, 0.6, kinds_b, kinds_p),
             ("no total", 1 << 21, None, 0.3, kinds_b, kinds_p),
             ("out_cap off the tile (1,000,003)", 1_000_003, 900_001, 0.5, kinds_b, kinds_p),
             ("70 build columns (two launches)", 1 << 20, 1 << 19, 0.5,
              _k4_columns(rng, bcap, device, 70), kinds_p)]
    for name, out_cap, total, share, bcols, pcols in cases:
        match, bid, pid = slots(out_cap, out_cap if total is None else min(total, out_cap),
                                share)
        t = None if total is None else torch.tensor(total, dtype=torch.int32, device=device)
        args = (match, bid, pid, bcols, pcols, t)
        with no_launches():
            want = k4.compact_gather_plain(*args)
        before = k4.compact_gather.launches
        got = k4.compact_gather(*args)
        again = k4.compact_gather(*args)
        torch.cuda.synchronize()
        try:
            max_abs_err(got, want)
            max_abs_err(again, got)
        except AssertionError as e:
            raise AssertionError(f"K4 {name}: {e}") from None
        launches = (k4.compact_gather.launches - before) // 2
        lines.append(f"K4 {name} (out_cap {out_cap}, n_match {int(got[-1])}, "
                     f"{len(bcols)} + {len(pcols)} columns, {launches} launches)")
        del got, want, again
    return lines


def _agg_requests(rng, cap, device, specials: float = 1e-4):
    """K8's requests over every input type (int32, int64, float32, float64,
    bool) and function, some with validity; the float64 column holds NaN,
    +-inf and -0.0 in a `specials` share of its rows."""
    import torch

    def on(x):
        return torch.from_numpy(x).to(device)

    f64 = rng.normal(size=cap) * 1e6
    at = rng.random(cap) < specials
    f64[at] = rng.choice([np.nan, np.inf, -np.inf, -0.0, 0.0], int(at.sum()))
    cols = {"i32": on(rng.integers(-2**31, 2**31, cap).astype(np.int32)),
            "i64": on(rng.integers(-2**62, 2**62, cap)),
            "f32": on(rng.normal(size=cap).astype(np.float32)),
            "f64": on(f64), "b": on(rng.random(cap) < 0.5)}
    valid = on(rng.random(cap) >= 0.1)
    return [("count", cols["i32"], valid), ("sum", cols["i32"], None),
            ("min", cols["i32"], valid), ("max", cols["i32"], valid),
            ("sum", cols["i64"], valid), ("min", cols["i64"], None), ("max", cols["i64"], valid),
            ("sum", cols["f32"], valid), ("min", cols["f32"], valid), ("max", cols["f32"], None),
            ("sum", cols["f64"], valid), ("min", cols["f64"], valid), ("max", cols["f64"], valid),
            ("count", cols["f64"], None), ("sum", cols["b"], valid), ("max", cols["b"], None)]


def _direct_agg_edges(rng, device):
    """(name, direct_agg's arguments) of K8's edge cases."""
    import torch

    def on(x):
        return torch.from_numpy(x).to(device)

    def key(cap, d, null=0.1, is_bool=False):
        codes = rng.random(cap) < 0.5 if is_bool else rng.integers(0, d, cap).astype(np.int32)
        return on(codes), on(rng.random(cap) >= null)

    def rows(n):
        return torch.tensor(n, dtype=torch.int32, device=device)

    cap = 1_000_003
    reqs = _agg_requests(rng, cap, device)
    half = on(rng.random(cap) < 0.5)
    q1 = [key(cap, 2, is_bool=True), key(cap, 3)]
    cases = [
        ("G = 1 (no key), row_filter half", ([], [], rows(cap - 5), half, reqs, cap)),
        ("G = 12 (a bool key x domain 3)", (q1, [2, 3], rows(cap), None, reqs, cap)),
        ("G = 64 (domains 7 x 7)", ([key(cap, 7), key(cap, 7)], [7, 7], rows(cap - 1), half,
                                    reqs, cap)),
        ("33 requests (two launches)", (q1, [2, 3], rows(cap), None, (reqs * 3)[:33], cap)),
        ("num_rows 0", (q1, [2, 3], rows(0), None, reqs, cap)),
        ("row_filter all False", (q1, [2, 3], rows(cap), torch.zeros_like(half), reqs, cap)),
        ("all-NULL groups", ([key(cap, 3, null=1.0), key(cap, 7, null=1.0)], [3, 7], rows(cap),
                             None, reqs, cap)),
        ("float64 NaN, +-inf, -0.0 in 5% of the rows",
         (q1, [2, 3], rows(cap), None, _agg_requests(rng, cap, device, 0.05), cap)),
    ]
    # every column a view one element into a tensor of cap + 1 rows, so no
    # column is 16-byte aligned and each is staged byte by byte beside the
    # bulk copies of the aligned bool key
    def odd(x):
        return on(x)[1:]

    n = 100_003
    codes = odd(rng.integers(0, 3, n + 1).astype(np.int32))
    i64, f64 = odd(rng.integers(-2**62, 2**62, n + 1)), odd(rng.normal(size=n + 1) * 1e6)
    valid = odd(rng.random(n + 1) >= 0.1)
    cases.append(("columns at an odd offset: key codes, validity, int64 and float64 values",
                  ([(codes, odd(rng.random(n + 1) >= 0.1)), key(n, 2, is_bool=True)], [3, 2],
                   rows(n - 7), odd(rng.random(n + 1) < 0.7),
                   [("sum", i64, valid), ("min", i64, None), ("max", i64, valid),
                    ("sum", f64, valid), ("min", f64, valid), ("count", f64, valid)], n)))
    big = (1 << 24) + 3
    cases.append((f"G = 64 over {big} rows (tiles past the grid)",
                  ([key(big, 7), key(big, 7)], [7, 7], rows(big), None,
                   _agg_requests(rng, big, device)[10:], big)))
    return cases


def k8_close(got, want, reqs) -> None:
    """K8's (rowcount, results) against the plain ones: integers bit for
    bit; float64 sums within SUM_RTOL + SUM_ATOL_PER_ABS * sum|x| (NaN
    where NaN, infinities equal), float64 min and max equal as numbers
    (NaN where NaN: a -0.0 and a 0.0 in one group tie, and the plain
    version's scatter keeps either)."""
    import torch
    max_abs_err(got[0], want[0])
    for g, w, (func, values, validity) in zip(got[1], want[1], reqs, strict=True):
        if g.dtype != torch.float64:
            max_abs_err(g, w)
            continue
        same = (g == w) | (torch.isnan(g) & torch.isnan(w))
        if func == "sum":
            x = values.double().abs()
            if validity is not None:
                x = torch.where(validity, x, 0.0)
            x = torch.where(torch.isfinite(x), x, 0.0)
            limit = SUM_ATOL_PER_ABS * float(x.sum()) + SUM_RTOL * w.abs()
            same = same | (torch.isfinite(w) & ((g - w).abs() <= limit))
        if not bool(same.all()):
            bad = int((~same).sum())
            raise AssertionError(f"{func} float64: {bad} groups differ")


def _compact_edges(rng, device):
    """(name, filter_compact's arguments) of K5's compaction edge cases."""
    import torch

    def case(name, cap, share, W, F, out_cap, offset=0):
        mask = torch.from_numpy(rng.random(cap + offset) < share).to(device)[offset:]
        words, f64 = _random_rows(rng, W, F, cap, device)
        bits = f64.view(torch.int64)
        bits[:, ::7] = torch.from_numpy(rng.integers(1, 1 << 52, bits[:, ::7].shape)).to(device)
        return (f"{name} (cap {cap}, W {W}, F {F}, out_cap {out_cap}, {share:.0%} pass)",
                (mask, words, f64, out_cap))

    tile = 4096
    return [case("cap 0", 0, 0.5, 3, 1, 0), case("out_cap 0", 10_000, 0.5, 3, 1, 0),
            case("none pass", 3 * tile + 17, 0.0, 4, 2, 3 * tile + 17),
            case("all pass", 5 * tile, 1.0, 4, 2, 5 * tile),
            case("survivors past out_cap", 1_000_003, 0.6, 5, 1, 100_000),
            case("cap not a multiple of the tile", 37 * tile + 1234, 0.3, 3, 2, 37 * tile + 1234),
            case("out_cap past cap", 5000, 0.7, 2, 1, 9000),
            case("the mask a view at an odd offset", 100_003, 0.5, 3, 1, 100_003, offset=1),
            case("NaN payloads and denormals in the sidecars only", 50_000, 0.5, 0, 3, 50_000),
            case(f"1% of {(1 << 24) + 3} rows", (1 << 24) + 3, 0.01, 10, 0, 1 << 22)]


def phase_agg_compact_edges(device) -> None:
    """K8 and K5's compaction against their plain versions on seeded edge
    cases, each run twice with the same bits both times: K8 (integers bit
    for bit, float64 within rtol 1e-9, k8_close) at G = 1, 12 and 64, 33
    requests, num_rows 0, a row filter all False, all-NULL groups, NaN,
    +-inf and -0.0, columns at an odd offset (not 16-byte aligned); K5 bit
    for bit (sidecars as their bits) at cap 0, out_cap 0, none and all
    passing, survivors past out_cap, a cap that is not a multiple of the
    tile, an unaligned mask, NaN payloads and denormals; its scratch bytes
    == kernels/filter_compact.py's plan; K8's warps' request sets
    (kernels/direct_agg.py's launch_plans, read from the kernel's host
    code) == warp_sets."""
    import torch
    from datafusion_parallelism_tpu_torch.kernels import _agg, _build
    from datafusion_parallelism_tpu_torch.kernels import direct_agg as k8
    from datafusion_parallelism_tpu_torch.kernels import filter_compact as k5
    rng = np.random.default_rng(811)
    lines = []
    for name, args in _direct_agg_edges(rng, device):
        with no_launches():
            want = k8.direct_agg_plain(*args)
        got, again = k8.direct_agg(*args), k8.direct_agg(*args)
        plans = k8.launch_plans(*args)
        torch.cuda.synchronize()
        try:
            k8_close(got, want, args[4])
            max_abs_err(got, again)
            for plan, group in zip(plans, _agg.request_groups(args[4]), strict=True):
                R = len(group) + 1   # the warps' request sets: the kernel's == the mirror's
                order, start = k8.warp_sets([k8.request_kind(f, v) for f, v, _ in group]
                                            + [k8.request_kind("count", None)])
                if list(plan[4:13]) != start or list(plan[13:13 + R]) != order:
                    raise AssertionError(f"warp sets {plan[4:13 + R]}, warp_sets: {start} "
                                         f"{order}")
        except AssertionError as e:
            raise AssertionError(f"K8 {name}: {e}") from None
        lines.append(f"K8 {name} (cap {args[5]}, G {k8.n_groups_of(args[1])}, "
                     f"{len(args[4])} requests)")
        del args, got, again, want
    scratch = _build.function("dfp_filter_compact_scratch_bytes", (_build.I64, _build.I64),
                              _build.I64)
    for name, args in _compact_edges(rng, device):
        cap = args[0].shape[0]
        if scratch(cap, args[3]) != k5.compact_scratch_bytes(cap):
            raise AssertionError(f"K5 {name}: scratch {scratch(cap, args[3])} bytes, the plan "
                                 f"says {k5.compact_scratch_bytes(cap)}")
        with no_launches():
            want = k5.filter_compact_plain(*args)
        got, again = k5.filter_compact(*args), k5.filter_compact(*args)
        torch.cuda.synchronize()
        try:
            max_abs_err(got, want)
            max_abs_err(got, again)
        except AssertionError as e:
            raise AssertionError(f"K5 {name}: {e}") from None
        lines.append(f"K5 {name}: {int(got[2])} survivors")
        del args, got, again, want
    # cap 0 into out_cap 5: zeros and a count of 0 (filter_compact_plain
    # cannot gather from no rows)
    words, f64 = _random_rows(rng, 3, 1, 0, device)
    out, out_f64, n = k5.filter_compact(torch.zeros(0, dtype=torch.bool, device=device), words,
                                        f64, 5)
    if int(n) != 0 or out.shape != (3, 5) or out.any() or out_f64.view(torch.int64).any():
        raise AssertionError(f"K5 cap 0, out_cap 5: n {int(n)}, {out.tolist()}")
    lines.append("K5 cap 0 into out_cap 5: zeros, 0 survivors")
    log("phase 2g ok: K8 == direct_agg_plain and K5 == filter_compact_plain, the same bits "
        "twice: " + "; ".join(lines))


def _k7_edges(rng, device):
    """(name, segment_agg's arguments) of K7's edge cases, over its tile of
    kernels/segment_agg.py TILE_ROWS rows: sorted keys in runs of given
    sizes, every input type with count, sum, min and max (_agg_requests)."""
    import torch
    from datafusion_parallelism_tpu_torch.kernels.segment_agg import TILE_ROWS as tile
    from datafusion_parallelism_tpu_torch.ops.hashing import key_words

    def on(x):
        return torch.from_numpy(x).to(device)

    def runs(cap, nv, sizes):
        """An int32 key over the first nv rows in runs of `sizes` (the last
        run takes the rest), zeros past them."""
        key = np.zeros(cap, np.int32)
        ids = np.repeat(np.arange(len(sizes)), sizes)[:nv]
        key[:len(ids)] = ids * 3 - 7
        key[len(ids):nv] = len(sizes) * 3 - 7
        return key

    def small(nv):
        return rng.integers(1, 6, max(nv, 1)).tolist()

    def case(name, cap, nv, key_cols, out_cap, reqs=None):
        words, cols = key_words(key_cols)
        reqs = _agg_requests(rng, cap, device) if reqs is None else reqs
        return (f"{name} (cap {cap}, n_valid {nv}, out_cap {out_cap}, {len(key_cols)} key "
                f"columns, {len(reqs)} requests)",
                (words, cols, torch.tensor(nv, dtype=torch.int32, device=device), reqs, out_cap))

    def int_case(name, cap, nv, sizes, out_cap=None):
        ones = torch.ones(cap, dtype=torch.bool, device=device)
        return case(name, cap, nv, [(on(runs(cap, nv, sizes)), ones)],
                    cap if out_cap is None else out_cap)

    cases = [int_case("n_valid 0", 3 * tile + 5, 0, [5]),
             int_case("n_valid 1", 3 * tile + 5, 1, [5])]
    for d in (-1, 0, 1):
        cases.append(int_case(f"n_valid a tile {d:+d}", 3 * tile, tile + d, small(tile + d)))
    cap = 37 * tile + 1234
    cases.append(int_case("a capacity not a multiple of the tile", cap, cap, small(cap)))
    cap = (1 << 24) + 3
    cases.append(int_case("one group over every row (the longest carry chain)", cap, cap, [cap]))
    cases.append(int_case("a group crossing exactly one tile edge", 4 * tile, 4 * tile - 2,
                          [tile - 7, 20] + small(3 * tile)))
    cases.append(int_case("groups dropped, the last kept ending on a tile edge", 3 * tile,
                          3 * tile - 5, [tile - 10, 6, 4] + small(2 * tile), out_cap=3))
    cases.append(int_case("groups dropped at a window edge", 40 * tile, 40 * tile,
                          [32 * tile - 3] + small(8 * tile), out_cap=1))
    cases.append(int_case("out_cap 0", 2 * tile, 2 * tile - 3, small(2 * tile), out_cap=0))
    cases.append(int_case("out_cap above the group count", 2 * tile, 2 * tile, [40] * 200,
                          out_cap=300))
    # float keys: -0.0 and 0.0 in one run, NaNs each their own group, NULLs last
    cap = 3 * tile + 11
    f = np.sort(rng.choice(np.array([-1.5, 0.0, 2.0, np.inf]), cap))
    f[(f == 0) & (rng.random(cap) < 0.5)] = -0.0
    f[-300:-100] = np.nan
    valid = np.arange(cap) < cap - 100
    cases.append(case("float64 and float32 keys: -0.0 == 0.0, NaN != NaN, NULL == NULL", cap,
                      cap, [(on(f), on(valid)), (on(f.astype(np.float32)), on(valid))], cap))
    # 17 columns, functions of the group (some NULL on some groups), 33 requests
    cap = 2 * tile + 17
    key = runs(cap, cap, small(cap))
    cols = [(on(key), torch.ones(cap, dtype=torch.bool, device=device))]
    cols += [(on((key * c % 11).astype(np.int32)), on(key % (c + 2) != 0)) for c in range(1, 17)]
    cases.append(case("a 17-column key and 33 requests", cap, cap - 3, cols, cap,
                      (_agg_requests(rng, cap, device) * 3)[:33]))
    cases.append(int_case("every input type, groups of ~50", 5 * tile, 5 * tile - 1,
                          rng.integers(1, 100, 5 * tile).tolist()))
    cases.append(int_case(f"{K7_FEW_ROWS} valid rows in a capacity of 2^25", 1 << 25, K7_FEW_ROWS,
                          rng.integers(1, 14, K7_FEW_ROWS).tolist()))
    return cases


def k7_close(got, want, reqs) -> None:
    """K7's (starts, sizes, results, n_groups) against the plain ones:
    starts, sizes and the group count bit for bit, the results as
    k8_close compares them."""
    max_abs_err((got[0], got[3]), (want[0], want[3]))
    k8_close(got[1:3], want[1:3], reqs)


def phase_segment_agg_edges(device) -> None:
    """K7 against segment_agg_plain on seeded edge cases (_k7_edges), each
    run twice with the same bits both times: starts, sizes, the group count
    and integer results bit for bit, float64 sums within rtol 1e-9
    (k7_close); the kernel's scratch bytes == kernels/segment_agg.py's
    scratch_layout."""
    import torch
    from datafusion_parallelism_tpu_torch.kernels import _agg, _build
    from datafusion_parallelism_tpu_torch.kernels import segment_agg as k7
    rng = np.random.default_rng(712)
    scratch = _build.function("dfp_segment_agg_scratch_bytes", (_build.I64, _build.I32),
                              _build.I64)
    lines = []
    for name, args in _k7_edges(rng, device):
        n = args[0].shape[1]
        for group in _agg.request_groups(args[3]):
            if scratch(n, len(group)) != k7.scratch_layout(n, len(group))[1]:
                raise AssertionError(f"K7 {name}: scratch {scratch(n, len(group))} bytes, the "
                                     f"plan says {k7.scratch_layout(n, len(group))[1]}")
        with no_launches():
            want = k7.segment_agg_plain(*args)
        got, again = k7.segment_agg(*args), k7.segment_agg(*args)
        torch.cuda.synchronize()
        try:
            k7_close(got, want, args[3])
            max_abs_err(got, again)
        except AssertionError as e:
            raise AssertionError(f"K7 {name}: {e}") from None
        lines.append(f"{name}: {int(got[3])} groups")
        del args, got, again, want
    log("phase 2h ok: K7 == segment_agg_plain, the same bits twice: " + "; ".join(lines))


# K10's edge cases: (name, n, total or None, offset of the slices into
# larger buffers, what else: a share of the matches on one build row, an
# incoming visited buffer); each runs with every flag selection
K10_EDGES = (
    ("n = 0", 0, 0, 0, {}),
    ("n = 1", 1, 1, 0, {"density": 1.0}),
    ("n not a multiple of 16, no total", 1_000_003, None, 0, {}),
    ("total 0", 100_000, 0, 0, {}),
    ("total mid", 1_000_003, 500_001, 0, {}),
    ("total past n", 999_999, 5_000_000, 0, {}),
    ("slices at offset 1", 65_537, 40_000, 1, {}),
    ("slices at offset 7", 65_537, 65_537, 7, {}),
    ("slices at offset 15, n 20", 20, 18, 15, {}),
    ("duplicate build ids (half the matches on one row)", 1_000_000, 900_000, 0,
     {"hot": 0.5}),
    ("no slot matches", 100_000, 100_000, 0, {"density": 0.0}),
    ("accumulate", 1_000_003, 700_000, 0, {"incoming": 0.3}),
)
K10_SELECTIONS = {"visited": (True, False), "probe flags": (False, True), "both": (True, True)}


def k10_edge(name: str, device):
    """match_flags' arguments (match, build_id, probe_idx, bcap, mcap with
    both flags asked, visited buffer or None, total or None) of the
    K10_EDGES case `name`, seeded by its place in the list: K3's layout
    below the total (a probe row's candidates together, 60% matches),
    random slots past it that the total must hide, each array a slice of
    a larger buffer at the case's offset."""
    import torch
    i = [e[0] for e in K10_EDGES].index(name)
    _, n, total, off, edit = K10_EDGES[i]
    rng = np.random.default_rng(100 + i)
    bcap, mcap = 50_000, max(n, 1)
    match = rng.random(n) < edit.get("density", 0.6)
    bid = rng.integers(0, bcap, n).astype(np.int32)
    if "hot" in edit:
        bid[rng.random(n) < edit["hot"]] = 3
    pidx = np.sort(rng.integers(0, mcap, n)).astype(np.int32)

    def on(a):
        buf = np.zeros(off + a.shape[0], a.dtype)
        buf[off:] = a
        return torch.from_numpy(buf).to(device)[off:]
    visited = None
    if "incoming" in edit:
        visited = torch.from_numpy(rng.random(bcap) < edit["incoming"]).to(device)
    t = None if total is None else torch.tensor(total, dtype=torch.int32, device=device)
    return on(match), on(bid), on(pidx), bcap, mcap, visited, t


# K19's edge cases: (name, per shard (capacity, rows, buckets or None,
# validity share or None), offset of the hashes and validity into larger
# buffers)
K19_EDGES = (
    ("1 shard, 524,288 rows", [(524_288, 524_288, None, None)], 0),
    ("8 shards, one empty, capacity not a multiple of 4",
     [(100_003, 100_003 - 7 * k if k != 3 else 0, None, None) for k in range(8)], 0),
    ("rows below the capacity, with validity", [(300_001, 200_000, None, 0.9)] * 3, 0),
    ("a single-bucket shard beside a uniform one",
     [(524_288, 524_288, 1, None), (524_288, 500_000, None, 0.5)], 0),
    ("4 buckets", [(524_288, 524_288, 4, None)], 0),
    ("hashes and validity off 16 bytes", [(100_000, 99_999, None, 0.8)] * 2, 3),
    ("64 shards (MAX_SHARDS)", [(1_000, 1_000 - k, None, None) for k in range(64)], 0),
    ("3 rows", [(3, 3, None, None)], 0),
    ("row counts past the capacity and negative", [(5_000, 2**31 - 1, None, None),
                                                   (5_000, -5, None, None)], 0),
)


def k19_edge(name: str, device):
    """key_histogram's arguments (hashes, num_rows, valid) of the K19_EDGES
    case `name`, seeded by its place in the list."""
    import torch
    i = [e[0] for e in K19_EDGES].index(name)
    _, shards, off = K19_EDGES[i]
    rng = np.random.default_rng(190 + i)
    hashes, num_rows, valid = [], [], []
    for cap, rows, buckets, share in shards:
        h = rng.integers(0, 1 << 32, cap, dtype=np.uint64)
        if buckets is not None:
            h = (rng.integers(0, buckets, cap).astype(np.uint64) * 67 + 11) << 24 | (h & 0xFFFFFF)
        hbuf = np.zeros(off + cap, np.uint32)
        hbuf[off:] = h.astype(np.uint32)
        hashes.append(torch.from_numpy(hbuf.view(np.int32)).to(device)[off:])
        num_rows.append(torch.tensor(rows, dtype=torch.int32, device=device))
        if share is None:
            valid.append(None)
        else:
            vbuf = np.zeros(off + cap, bool)
            vbuf[off:] = rng.random(cap) < share
            valid.append(torch.from_numpy(vbuf).to(device)[off:])
    return hashes, num_rows, valid


def phase_flags_hist_edges(device) -> None:
    """Phase 2i: K10 and K19 against their plain versions bit for bit on
    their edge cases, each run twice with the same bits: K10 under every
    flag selection (K10_EDGES), K19 (K19_EDGES); K19's compiled plan
    against the wrapper's."""
    from datafusion_parallelism_tpu_torch.kernels import key_histogram as k19
    from datafusion_parallelism_tpu_torch.kernels import match_flags as k10
    plans_agree((("K19", k19),))
    lines = []
    for name, *_ in K10_EDGES:
        match, bid, pidx, bcap, mcap, visited, total = k10_edge(name, device)
        for sel, (want_v, want_p) in K10_SELECTIONS.items():
            if visited is not None and not want_v:   # an incoming buffer is the visited flags
                continue

            def run(fn, bcap=bcap if want_v else None, mcap=mcap if want_p else None):
                # each call ORs into its own copy of the incoming buffer
                return lambda: fn(match, bid, pidx, bcap, mcap,
                                  None if visited is None else visited.clone(), total)
            got = kernel_twice(f"K10 {name}, {sel}", run(k10.match_flags),
                               run(k10.match_flags_plain), ())
            if [g is None for g in got] != [not want_v, not want_p]:
                raise AssertionError(f"K10 {name}, {sel}: flags "
                                     f"{['none' if g is None else 'made' for g in got]}")
        lines.append(f"K10 {name} (n {match.shape[0]}, total "
                     f"{None if total is None else int(total)}, {int(match.sum())} matches, "
                     f"{int(got[0].sum())} build and {int(got[1].sum())} probe rows set)")
    for name, *_ in K19_EDGES:
        args = k19_edge(name, device)
        hist = kernel_twice(f"K19 {name}", k19.key_histogram, k19.key_histogram_plain, args)
        lines.append(f"K19 {name} ({len(args[0])} shards, {int(hist.sum())} rows counted)")
    log("phase 2i ok: K10 == match_flags_plain under every flag selection and K19 == "
        "key_histogram_plain, bit for bit, the same bits twice: " + "; ".join(lines))


def strategy_join_variants(rng, n, device):
    """Joins under SORT and OA, every stage run through the kernel and its
    plain version (Checked), equal to the plain path word for word."""
    from datafusion_parallelism_tpu_torch.kernels.chain import KERNELS as CHAIN
    from datafusion_parallelism_tpu_torch.kernels.chain import PLAIN as CHAIN_PLAIN
    from datafusion_parallelism_tpu_torch.kernels.chain import ChainKernels
    from datafusion_parallelism_tpu_torch.ops.expressions import BinOp, Col, evaluate
    from datafusion_parallelism_tpu_torch.ops.hash_table import JoinStrategy
    from datafusion_parallelism_tpu_torch.ops.join import (PLAIN, JoinType, hash_join,
                                                           prepare_build)
    from datafusion_parallelism_tpu_torch.utils.columnar import HostTable

    def checked_chain():
        def stage(kernel, plain):
            def run(*args):
                got = kernel(*args)
                entry_err(kernel.__name__, args, got, plain(*args))
                return got
            return run
        return ChainKernels(*(stage(k, p) for k, p in zip(CHAIN, CHAIN_PLAIN)))

    keys = rng.integers(0, n // 4, n)
    b = HostTable.from_numpy({"bk": keys.astype(np.int32), "bf": keys * 0.5,
                              "bv": rng.random(n)}, validity={"bk": rng.random(n) >= 0.1})
    pkeys = rng.integers(0, n // 4, n)
    p = HostTable.from_numpy({"pk": pkeys.astype(np.int32), "pf": pkeys * 0.5,
                              "pv": rng.random(n)}, validity={"pk": rng.random(n) >= 0.1})
    build, probe = b.to_device(n + n // 3, device=device), p.to_device(device=device)
    below = BinOp("<", Col("bv"), Col("pv"))
    labels = []
    for strategy in (JoinStrategy.SORT, JoinStrategy.OA):
        chain = checked_chain()
        residual = lambda pair, c=chain: evaluate([below], pair, c)[0][:2]   # noqa: E731
        cases = [("INNER", ["bk"], ["pk"], {}), ("FULL", ["bk"], ["pk"], {}),
                 ("LEFT residual", ["bk"], ["pk"], {"residual": residual}),
                 ("RIGHT_SEMI float64 keys", ["bf"], ["pf"], {}),
                 ("LEFT_ANTI expanded", ["bk"], ["pk"], {"expanded": True}),
                 ("INNER prepared", ["bk"], ["pk"], {"prepared": True})]
        for label, bk, pk, kw in cases:
            jt = JoinType[label.split()[0]]
            kw_k, kw_p = dict(kw), dict(kw)
            if kw.get("prepared"):
                kw_k["prepared"] = prepare_build(build, bk, strategy, Checked().stages, chain)
                with no_launches():
                    kw_p["prepared"] = prepare_build(build, bk, strategy, PLAIN, CHAIN_PLAIN)
            if "residual" in kw:
                kw_p["residual"] = lambda pair: evaluate([below], pair, CHAIN_PLAIN)[0][:2]
            got = hash_join(build, probe, bk, pk, jt, 4 * n, strategy, kernels=Checked().stages,
                            chain=chain, **kw_k)
            with no_launches():
                want = hash_join(build, probe, bk, pk, jt, 4 * n, strategy, kernels=PLAIN,
                                 chain=CHAIN_PLAIN, **kw_p)
            tables_equal(got[0], want[0])
            max_abs_err(got[1:], want[1:])
            rows = int(got[1].sum()) if kw.get("expanded") else int(got[0].num_rows)
            labels.append(f"{strategy.name} {label} {rows} rows")
    return labels


def _expr_table(rng, n, device):
    """A table of every column type with NULLs, zeros, negative values and
    dates before 1970: i32, i64, date, d0-d4 (DECIMAL(0)-(4)), f32, f64,
    b (bool), s (string codes)."""
    from datafusion_parallelism_tpu_torch.utils.columnar import (BOOL, DATE32, DECIMAL, FLOAT32,
                                                                 FLOAT64, INT32, INT64, STRING,
                                                                 Dictionary, HostTable)
    cols = {"i32": rng.integers(-50, 50, n).astype(np.int32),
            "i64": rng.integers(-(1 << 40), 1 << 40, n) // rng.integers(1, 1 << 30, n),
            "date": rng.integers(-40000, 40000, n).astype(np.int32),
            "f32": (rng.normal(size=n) * 100).astype(np.float32),
            "f64": rng.normal(size=n) * 1e3,
            "b": rng.random(n) < 0.5,
            "s": rng.integers(0, 6, n).astype(np.int32)}
    dtypes = {"i32": INT32, "i64": INT64, "date": DATE32, "f32": FLOAT32, "f64": FLOAT64,
              "b": BOOL, "s": STRING}
    for s in range(5):
        cols[f"d{s}"] = rng.integers(-100_000, 100_000, n)
        dtypes[f"d{s}"] = DECIMAL(s)
    for name in ("i32", "i64", "f32", "f64", "d2"):
        cols[name][rng.random(n) < 0.1] = 0           # division by zero
    cols["f64"][:4] = [-0.0, np.inf, -np.inf, np.nan]
    validity = {name: rng.random(n) >= 0.15 for name in cols}
    t = HostTable.from_numpy(cols, dtypes=dtypes, validity=validity,
                             dictionaries={"s": Dictionary(np.array(list("abcdef"),
                                                                    dtype=object))})
    return t.to_device(device=device)


def expr_suite():
    """Every expression class over every column type: (label, Expr)."""
    from datafusion_parallelism_tpu_torch.models.planner import DictMap, ScalarValue
    from datafusion_parallelism_tpu_torch.ops.expressions import (BinOp, Case, Cast, Coalesce,
                                                                  Col, ExtractDatePart,
                                                                  InCodes, IsNull, Lit, Not)
    from datafusion_parallelism_tpu_torch.utils.columnar import (BOOL, DATE32, DECIMAL,
                                                                 FLOAT32, FLOAT64, INT32,
                                                                 INT64, STRING, Dictionary)
    num = ["i32", "i64", "date", "d0", "d2", "d4", "f32", "f64"]
    out = [(f"{a} {op} {b}", BinOp(op, Col(a), Col(b)))
           for a in num for b in num for op in ("+", "-", "*", "/", "%", "<", "=", ">=")]
    out += [(f"{a} {op} lit", BinOp(op, Col(a), Lit(3, INT32)))
            for a in num for op in ("*", "/", "%", "<>")]
    out += [("d2 > 1.5", BinOp(">", Col("d2"), Lit(1.5, DECIMAL(2)))),
            ("f32 + f32 lit", BinOp("+", Col("f32"), Lit(0.1, FLOAT32))),
            ("s = s", BinOp("=", Col("s"), Col("s"))),
            ("b and (i32 < 0)", BinOp("and", Col("b"), BinOp("<", Col("i32"), Lit(0, INT32)))),
            ("b or (f64 > 0)", BinOp("or", Col("b"), BinOp(">", Col("f64"), Lit(0.0, FLOAT64)))),
            ("not b", Not(Col("b"))), ("not i32", Not(Col("i32"))),
            ("i64 is null", IsNull(Col("i64"))), ("f64 is not null", IsNull(Col("f64"), True)),
            ("null lit + i32", BinOp("+", Lit(None, INT32), Col("i32")))]
    out += [(f"cast {a} {dt}", Cast(Col(a), dt)) for a in num + ["b"]
            for dt in (INT32, INT64, FLOAT32, FLOAT64, BOOL, DATE32, DECIMAL(0), DECIMAL(2),
                       DECIMAL(4))]
    out += [("i32 in", InCodes(Col("i32"), np.array([-7, 0, 3, 11, 40]))),
            ("f64 in", InCodes(Col("f64"), np.array([0.0, 1.5, np.nan]))),
            ("s not in", InCodes(Col("s"), np.array([1, 4], dtype=np.int32), True)),
            ("d2 in empty", InCodes(Col("d2"), np.array([], dtype=np.int32))),
            ("case", Case([(BinOp("<", Col("i32"), Lit(0, INT32)), Col("i32")),
                           (Col("b"), Col("i64"))], Col("d0"))),
            ("case no else", Case([(BinOp(">", Col("f64"), Lit(1.0, FLOAT64)), Col("f32"))])),
            ("coalesce", Coalesce([Col("i32"), Col("i64"), Lit(5, INT64)])),
            ("coalesce f", Coalesce([Col("f32"), Col("d2")]))]
    out += [(f"extract {p}", ExtractDatePart(p, Col("date"))) for p in ("year", "month", "day")]
    out += [("dictmap", DictMap(Col("s"), np.array([5, 4, 3, 2, 1, 0]),
                                Dictionary(np.array(list("fedcba"), dtype=object)))),
            ("dictmap of i32", DictMap(Col("i32"), np.arange(6)[::-1].copy(),
                                       Dictionary(np.array(list("fedcba"), dtype=object)))),
            ("scalar decimal", BinOp("<", Col("d2"), ScalarValue([12.5], [DECIMAL(2)]))),
            ("scalar null", BinOp("+", Col("i64"), ScalarValue([None], [INT64]))),
            ("string lit", BinOp("=", Col("s"), Lit(2, STRING)))]
    # literals only: K17 computes an op of uniform operands once a block
    out += [("lit * lit", BinOp("*", Lit(3, INT32), Lit(-4, INT32))),
            ("lit / 0", BinOp("/", Lit(7, INT32), Lit(0, INT32))),
            ("lit % lit", BinOp("%", Lit(-7, INT64), Lit(3, INT64))),
            ("f lit / f lit 0", BinOp("/", Lit(1.5, FLOAT64), Lit(0.0, FLOAT64))),
            ("null lit is null", IsNull(Lit(None, INT32))),
            ("coalesce lits", Coalesce([Lit(None, INT32), Lit(5, INT64)])),
            ("case of lits", Case([(BinOp("<", Lit(1, INT32), Lit(2, INT32)),
                                    Lit(3.5, FLOAT64))], Lit(0.0, FLOAT64))),
            ("extract of lit", ExtractDatePart("year", Lit(-1000, DATE32))),
            ("lit in", InCodes(Lit(3, INT32), np.array([1, 3]))),
            ("not lit and lit", BinOp("and", Not(Lit(True, BOOL)), Lit(None, BOOL))),
            ("d2 + lit * (1 - lit)", BinOp("+", Col("d2"), BinOp(
                "*", Lit(2, DECIMAL(2)), BinOp("-", Lit(1, INT32), Lit(0.25, DECIMAL(2)))))),
            ("scalar * lit", BinOp("*", ScalarValue([12.5], [DECIMAL(2)]), Lit(2, INT32)))]
    return out


def expr_kernel_vs_plain(rng, device, n: int = 1 << 16) -> str:
    """K17 against its plain version on every expression of `expr_suite`,
    one launch each, bit for bit over the whole capacity (values and
    validity); all roots of a wide projection in one launch; the mask mode
    with a row bound and an AND mask."""
    import torch
    from datafusion_parallelism_tpu_torch.kernels import expr_eval as k17
    from datafusion_parallelism_tpu_torch.ops.expressions import compile_exprs
    t = _expr_table(rng, n, device)
    suite = expr_suite()
    longest = 0

    def run(exprs, mask=None):
        program, _ = compile_exprs(exprs, t)
        cols = [t.column(c) for c in program.cols]
        scalars = tuple(node.literal().bits() for node in program.scalars)
        got = k17.expr_eval(program, cols, t.capacity, scalars, mask, t.device)
        with no_launches():
            want = k17.expr_eval_plain(program, cols, t.capacity, scalars, mask, t.device)
        max_abs_err(got, want)
        return len(program.code)

    for _, e in suite:
        longest = max(longest, run([e]))
    for i in range(0, len(suite), 16):              # a projection's roots, one launch
        run([e for _, e in suite[i:i + 16]])
    bools = [e for label, e in suite if any(s in label for s in ("<", "=", "and", "or", "in",
                                                                 "null", "not"))]
    and_mask = torch.from_numpy(rng.random(t.capacity) < 0.5).to(device)
    bound = torch.tensor(n - 100, dtype=torch.int32, device=device)
    for e in bools:
        run([e], (bound, and_mask))
        run([e], (None, None))
    return (f"K17 == plain on {len(suite)} expressions (every class x dtype; NULLs, x/0, "
            f"negative % and //, dates before 1970; up to {longest} instructions), "
            f"{-(-len(suite) // 16)} 16-root projections and {2 * len(bools)} masks")


def _deep(col: str, depth: int):
    """col + (col + (... + col)): every left operand stays live, so the
    program holds depth + 1 registers."""
    from datafusion_parallelism_tpu_torch.ops.expressions import BinOp, Col
    e = Col(col)
    for _ in range(depth):
        e = BinOp("+", Col(col), e)
    return e


def expr_tile_edges(rng, device) -> str:
    """K17 bit for bit against its plain version at row counts around its
    tile (kernels/expr_eval.py `plan_tile`): every expression of
    `expr_suite` (and each boolean one in mask mode, with a row bound and
    an AND mask) at 0, 1, 31, T - 1, T, T + 1 and 1,000 rows, and programs
    of 1, 5 and 64 registers at those counts, 3T + 77 rows and more tiles
    than the grid holds at once, over columns from row 0 and (unaligned)
    from row 1. Also holds the
    wrapper's `_Params` and `smem_bytes` against the library's."""
    import ctypes

    import torch
    from datafusion_parallelism_tpu_torch.kernels import _build
    from datafusion_parallelism_tpu_torch.kernels import expr_eval as k17
    from datafusion_parallelism_tpu_torch.ops.expressions import Col, Not, compile_exprs
    params = _build.function("dfp_expr_eval_params_bytes", (), _build.I64)()
    if params != ctypes.sizeof(k17._Params):
        raise AssertionError(f"Params is {params} bytes, _Params {ctypes.sizeof(k17._Params)}")
    smem = _build.function("dfp_expr_eval_smem_bytes",
                           (_build.I32, _build.I32, _build.I32, _build.I32), _build.I64)
    for args in ((1, 3, 1, 4096), (5, 29, 2, 2560), (64, 256, 32, 256), (7, 100, 1, 1792)):
        if smem(*args) != k17.smem_bytes(*args):
            raise AssertionError(f"smem_bytes{args}: library {smem(*args)}, "
                                 f"wrapper {k17.smem_bytes(*args)}")
    limits = _build.device_limits(device)
    t = _expr_table(rng, k17.MAX_TILE + 64, device)
    and_mask = torch.from_numpy(rng.random(t.capacity) < 0.5).to(device)

    def plan(program, mask):
        return k17.plan_tile(max(program.n_regs, 1), len(program.code),
                             1 if mask else len(program.roots), limits.smem_block,
                             limits.smem_sm)

    def run(table, program, n, mask=None, offset=0):
        """expr_eval over columns starting `offset` rows in."""
        cols = [tuple(x[offset:offset + n] for x in table.column(c)) for c in program.cols]
        scalars = tuple(node.literal().bits() for node in program.scalars)
        if mask is not None:
            mask = (torch.tensor(max(n - 3, 0), dtype=torch.int32, device=device),
                    and_mask[offset:offset + n])
        got = k17.expr_eval(program, cols, n, scalars, mask, device)
        with no_launches():
            want = k17.expr_eval_plain(program, cols, n, scalars, mask, device)
        max_abs_err(got, want)

    suite = expr_suite()
    bools = {label for label, _ in suite if any(s in label for s in (
        "<", "=", "and", "or", "in", "null", "not"))}
    launches = 0
    for label, e in suite:
        program, _ = compile_exprs([e], t)
        for masked in (False, True) if label in bools else (False,):
            T = plan(program, masked)[0]
            for n in (0, 1, 31, T - 1, T, T + 1, 1000):
                run(t, program, n, masked or None)
                launches += 1
    lines = []
    for regs, e in ((1, Not(Col("b"))), (5, _deep("d2", 4)), (64, _deep("i32", 63))):
        program, _ = compile_exprs([e], t)
        if program.n_regs != regs:
            raise AssertionError(f"a {regs}-register program holds {program.n_regs}")
        T = plan(program, False)[0]
        big = 9 * limits.sms * T + 77       # more tiles than 8 blocks an SM take at once
        wide = _expr_table(rng, big + 1, device)
        for n in (0, 1, 31, T - 1, T, T + 1, 3 * T + 77, big):
            for offset in (0, 1):
                run(wide if n + offset > t.capacity else t, program, n, None, offset)
                launches += 1
        lines.append(f"{regs} registers: T = {T}, up to {big} rows")
        del wide
    return (f"K17 == plain around its tile: {len(suite)} expressions (and {len(bools)} "
            f"masks) at 0, 1, 31, T - 1, T, T + 1 and 1,000 rows; " + ", ".join(lines)
            + f" (columns from row 0 and from row 1); {launches} launches; Params "
            f"{params} bytes")


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
        if not checked.calls[name]:
            continue
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
    from datafusion_parallelism_tpu_torch.kernels.chain import PLAIN as CHAIN_PLAIN
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
        return inner_csr_join(build, probe, ["b_key"], ["p_key"], SIZE512_OUT_CAP, PLAIN,
                              CHAIN_PLAIN)

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
    """sf10_host_tables on the device."""
    orders, lineitem, n_lines, expected_price = sf10_host_tables(rng)
    return (orders.to_device(device=device), lineitem.to_device(device=device),
            n_lines, expected_price)


def sf10_host_tables(rng):
    """orders (o_orderkey int64 in dbgen's sparse pattern, o_custkey int32,
    o_totalprice DECIMAL(2)) and lineitem (1-7 lines per order: l_orderkey
    int64, l_linenumber int32, l_extendedprice float64) on the host, their
    join's row count and o_totalprice sum."""
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
    return orders, lineitem, n_lines, expected_price


def phase_sf10(device):
    import torch
    from datafusion_parallelism_tpu_torch.kernels.chain import PLAIN as CHAIN_PLAIN
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
    ref, ref_total = inner_csr_join(orders, lineitem, *keys, out_cap, PLAIN, CHAIN_PLAIN)
    if int(ref_total) != total:
        raise AssertionError(f"plain total {int(ref_total)} vs {total}")
    tables_equal(out, ref)
    del out, ref
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inner_csr_join(orders, lineitem, *keys, out_cap, PLAIN, CHAIN_PLAIN)
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
        if not checked.calls[name]:
            continue
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


def all_counters():
    """{(table, entry point): wrapper} over the join's, the chain's and the
    distributed layer's kernel tables; each wrapper counts its own
    launches."""
    from datafusion_parallelism_tpu_torch.kernels.chain import KERNELS as CHAIN
    from datafusion_parallelism_tpu_torch.ops.join import KERNELS as JOIN
    from datafusion_parallelism_tpu_torch.parallel.shuffle import KERNELS as DIST
    return {**{("join", e): fn for e, fn in JOIN._asdict().items()},
            **{("chain", e): fn for e, fn in CHAIN._asdict().items()},
            **{("dist", e): fn for e, fn in DIST._asdict().items()}}


def kernel_of(key) -> str:
    """The kernel (KERNEL_INFO's name) a (table, entry point) launches."""
    from datafusion_parallelism_tpu_torch.kernels.chain import KERNEL_OF as CHAIN_OF
    from datafusion_parallelism_tpu_torch.ops.join import KERNEL_OF as JOIN_OF
    if key[0] == "dist":   # each entry point is its kernel
        return key[1]
    return (JOIN_OF if key[0] == "join" else CHAIN_OF)[entry_of(key)]


@contextlib.contextmanager
def no_launches():
    """Fails unless no kernel wrapper launches anything inside: a plain
    path must not reach a kernel past its `kernels` arguments."""
    wrappers = set(all_counters().values())
    before = {fn: fn.launches for fn in wrappers}
    yield
    moved = {fn.__name__: (n, fn.launches) for fn, n in before.items() if fn.launches != n}
    if moved:
        raise AssertionError(f"the plain path launched kernels: {moved}")


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
    """Each recorded call run through the kernel and its plain version (K7
    twice, the same bits both times): {kernel name: [max error, kernel ms,
    plain ms]} (times summed over the calls, CUDA events, median of
    `reps`)."""
    from datafusion_parallelism_tpu_torch.kernels.chain import KERNEL_OF, KERNELS, PLAIN
    out = {}
    for entry, calls in record.items():
        if not calls:
            continue
        kernel, plain = getattr(KERNELS, entry), getattr(PLAIN, entry)
        acc = out.setdefault(KERNEL_OF[entry], [0.0, 0.0, 0.0])
        for args in calls:
            got = kernel(*args)
            acc[0] = max(acc[0], entry_err(entry, args, got, plain(*args)))
            if entry == "segment_agg":   # float64 sums: the same bits every run
                max_abs_err(got, kernel(*args))
            del got
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
        got = k7.segment_agg(*args)
        errs["segment_agg"][0] = max(errs["segment_agg"][0], entry_err(
            "segment_agg", args, got, k7.segment_agg_plain(*args)))
        max_abs_err(got, k7.segment_agg(*args))
        del got
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
    """Stricter than tpch/diff_results.py's rule, with its tolerance: the
    same rows in the same order (both are ORDER BY results), floats within
    rel 1e-6 or abs 1e-4."""
    import math

    from datafusion_parallelism_tpu_torch.tpch.diff_results import ABS, REL
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} rows, oracle {len(want)}")
    for g, w in zip(got, want):
        for k, wv in w.items():
            gv = g[k]
            if isinstance(wv, float) or isinstance(gv, float):
                ok = math.isclose(float(gv), float(wv), rel_tol=REL, abs_tol=ABS)
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
    the recorded kernel calls' timing, the generated tables)."""
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
    return launches, res, timing, tables


# ---------------------------------------------------------------------------
# the join types at Size512, and SQL at SF10
# ---------------------------------------------------------------------------

def _size512_counts(bk, pk, bv, pv):
    """numpy's counts at Size512: matches, unmatched build rows, unmatched
    probe rows, and under the residual b_val < p_val the matching pairs
    and the build rows with at least one."""
    n = len(bk)
    cnt_b, cnt_p = np.bincount(bk, minlength=n), np.bincount(pk, minlength=n)
    order = np.argsort(bk, kind="stable")
    lo = np.searchsorted(bk[order], pk, "left")
    cnt = cnt_b[pk]
    pidx = np.repeat(np.arange(n), cnt)
    bidx = order[np.repeat(lo, cnt) + np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)]
    keep = bv[bidx] < pv[pidx]
    return {"matches": int(cnt.sum()), "unmatched_build": int((cnt_p[bk] == 0).sum()),
            "unmatched_probe": int((cnt == 0).sum()), "residual_pairs": int(keep.sum()),
            "residual_build": int(np.unique(bidx[keep]).size)}


def phase_join_types(device):
    """All eight join types and four variants at Size512: kernel path ==
    plain path word for word, row counts == numpy's, ms of both paths."""
    import torch
    from datafusion_parallelism_tpu_torch.entry import make_tables
    from datafusion_parallelism_tpu_torch.kernels.chain import PLAIN as CHAIN_PLAIN
    from datafusion_parallelism_tpu_torch.ops.expressions import BinOp, Col
    from datafusion_parallelism_tpu_torch.ops.join import KERNELS, PLAIN, JoinType, hash_join
    from datafusion_parallelism_tpu_torch.utils.columnar import (FLOAT64, INT64, DeviceTable,
                                                                 Field, Schema)

    n = SIZE512
    build, probe = make_tables(np.random.default_rng(0), n, n, n, device=device)
    c = _size512_counts(_np(build, "b_key", n), _np(probe, "p_key", n), _np(build, "b_val", n),
                        _np(probe, "p_val", n))
    m, ub, up = c["matches"], c["unmatched_build"], c["unmatched_probe"]
    expect = {"INNER": m, "LEFT": m + ub, "RIGHT": m + up, "FULL": m + ub + up,
              "LEFT_SEMI": n - ub, "LEFT_ANTI": ub, "RIGHT_SEMI": n - up, "RIGHT_ANTI": up}

    def with_column(t, name, values, dtype):
        ones = torch.ones(t.capacity, dtype=torch.bool, device=device)
        return DeviceTable(Schema(list(t.schema.fields) + [Field(name, dtype)]),
                           {**t.columns, name: (values, ones)}, t.num_rows)

    # the same keys as float64 (0 as -0.0 on the build side) and as int64
    bkey = build.column("b_key")[0]
    fbuild = with_column(build, "b_fkey",
                         torch.where(bkey == 0, -0.0, bkey.double()), FLOAT64)
    fprobe = with_column(probe, "p_fkey", probe.column("p_key")[0].double(), FLOAT64)
    lprobe = with_column(probe, "p_lkey", probe.column("p_key")[0].long(), INT64)
    below = BinOp("<", Col("b_val"), Col("p_val"))
    residual = lambda pair: below.eval(pair)[:2]   # noqa: E731
    cases = [(t.name, build, probe, "b_key", "p_key", {}, expect[t.name]) for t in JoinType]
    cases += [("INNER residual", build, probe, "b_key", "p_key", {"residual": residual},
               c["residual_pairs"]),
              ("LEFT_SEMI residual", build, probe, "b_key", "p_key", {"residual": residual},
               c["residual_build"]),
              ("INNER float64 keys", fbuild, fprobe, "b_fkey", "p_fkey", {}, m),
              ("INNER int32 x int64 keys", build, lprobe, "b_key", "p_lkey", {}, m)]
    lines, res = [], {}
    for label, b, p, bkey_name, pkey_name, kw, rows in cases:
        jt = JoinType[label.split()[0]]

        def run(kernels, chain, b=b, p=p, bkey_name=bkey_name, pkey_name=pkey_name, kw=kw,
                jt=jt):
            return hash_join(b, p, [bkey_name], [pkey_name], jt, SIZE512_OUT_CAP,
                             kernels=kernels, chain=chain, **kw)

        out, total = run(KERNELS, None)
        with no_launches():
            ref, ref_total = run(PLAIN, CHAIN_PLAIN)
            t_plain = wall_s(lambda: run(PLAIN, CHAIN_PLAIN), 1)
        if int(total) != int(ref_total) or int(total) > SIZE512_OUT_CAP:
            raise AssertionError(f"{label}: total {int(total)}, plain {int(ref_total)}")
        tables_equal(out, ref)
        if int(out.num_rows) != rows:
            raise AssertionError(f"{label}: {int(out.num_rows)} rows, numpy counts {rows}")
        del out, ref
        t_kernel = wall_s(lambda: run(KERNELS, None), 5)
        res[label] = {"rows": rows, "kernel_ms": t_kernel * 1e3, "plain_ms": t_plain * 1e3}
        lines.append(f"{label} {rows} rows {t_kernel * 1e3:.3f}/{t_plain * 1e3:.3f}")
    log(f"phase 13 ok: join types at Size512 ({n} x {n} rows; {m} matches, {ub} unmatched "
        f"build, {up} unmatched probe rows), kernel path == plain path word for word, rows == "
        "numpy; ms kernel/plain (median of 5 / one run): " + "; ".join(lines))
    return res


def _bytes(x) -> int:
    """The bytes of the tensors in x, a view's bytes once: the union of
    their byte ranges (K2's counts are a view of start_count[1], its perm
    one of rows_out[-1])."""
    spans = sorted((t.data_ptr(), t.data_ptr() + t.nbytes) for t in _flat(x)
                   if hasattr(t, "data_ptr") and t.nbytes)
    total, end = 0, -1
    for lo, hi in spans:
        total += max(0, hi - max(lo, end))
        end = max(end, hi)
    return total


def join_detail(key, args, out) -> str:
    """Phase 15's detail of a K2, K3, K4, K14, K15 or K16 call ('' for the
    rest): K2's n, T, R, layout, digit passes and its bound as counted
    before its outputs shared storage (each output's bytes); K3's m, T,
    total, out_cap, build rows' layout and key groups; K4's out_cap, total,
    n_match and columns; K14's m, capacity, directory bits and keys a
    bucket; K15's capacity, S, tiles and n_valid; K16's m, ok rows, S, T,
    tiles, total and longest run, and its bound as counted before it
    computed the homes (with the probe's int32 home array read)."""
    from datafusion_parallelism_tpu_torch.kernels import csr_build as k2
    from datafusion_parallelism_tpu_torch.kernels import oa_place as k15
    from datafusion_parallelism_tpu_torch.kernels import oa_probe as k16
    from datafusion_parallelism_tpu_torch.kernels import probe_expand as k3
    from datafusion_parallelism_tpu_torch.kernels import sorted_probe as k14
    if key[1] == "oa_probe":
        hashes, ok, slots = args
        before = work(key, args, out)[0] + hashes.nbytes   # with the probe's home array
        return (f", m {hashes.shape[0]}, {int(ok.sum())} rows ok, S {slots.shape[0]}, T "
                f"{k16.home_slots(slots.shape[0])}, {k16.probe_tiles(hashes.shape[0])} tiles, "
                f"total {int(out[3])}, longest run {int(out[1].max())}, bound as counted "
                f"before (with a home array) {before / HBM_BYTES_PER_S * 1e3:.3f}")
    if key[1] == "sorted_probe":
        hashes, ok, sorted_hash = args
        cap, bits = sorted_hash.shape[0], k14.directory_bits(sorted_hash.shape[0])
        valid = int((sorted_hash < 2**32).sum())
        return (f", m {hashes.shape[0]}, {int(ok.sum())} rows ok, capacity {cap}, {valid} "
                f"valid keys, directory bits {bits}: {cap / 2**bits:.2f} capacity keys and "
                f"{valid / 2**bits:.2f} valid keys a bucket, total {int(out[3])}")
    if key[1] == "oa_place":
        order, _, _, ok, S = args
        each = _bytes(args) + _bytes(out)
        return (f", capacity {order.shape[0]}, S {S}, {k15.place_tiles(order.shape[0])} "
                f"tiles, n_valid {int(ok.sum())}, bound as counted before (every input "
                f"whole) {each / HBM_BYTES_PER_S * 1e3:.3f}")
    if key[1] == "csr_build":
        slot, T, rows = args[:3]
        each = sum(t.nbytes for t in _flat([slot, rows, out]))
        layout = "row-major" if len(args) > 3 and args[3] else "word-major"
        return (f", n {slot.shape[0]}, T {T}, R {rows.shape[0]} ({layout}), "
                f"{int((slot == T).sum())} rows in bucket T, digit passes "
                f"{k2.digit_passes(T)}, bound as counted before (each output's bytes) "
                f"{each / HBM_BYTES_PER_S * 1e3:.3f}")
    if key[1] == "probe_ranges":
        slot, ok, offsets = args
        return (f", m {slot.shape[0]}, T {offsets.shape[0] - 2}, {int(ok.sum())} rows ok, "
                f"total {int(out[3])}, {k3.range_tiles(slot.shape[0])} tiles")
    if key[1] == "expand_ranges":
        start, _, _, total, _, bwords, compares, out_cap = args
        layout = "word-major" if bwords.is_contiguous() else f"row-major {bwords.stride()[1]}"
        return (f", m {start.shape[0]}, total {int(total)}, out_cap {out_cap}, build rows "
                f"{bwords.shape[1]} ({layout}), {len(compares)} keys in "
                f"{len(k3.key_groups(compares))} key groups")
    if key[1] in ("match_flags", "match_flags_acc"):
        match, _, _, bcap, mcap, visited, total = args
        k = match.shape[0] if total is None else max(0, min(int(total), match.shape[0]))
        asked = "both" if bcap and mcap else "visited" if bcap else "probe flags"
        before = (9 * match.shape[0] + (bcap or 0) + (mcap or 0)) / HBM_BYTES_PER_S * 1e3
        return (f", n {match.shape[0]}, total {None if total is None else int(total)}, "
                f"{int(match[:k].sum())} matches, bcap {bcap}, mcap {mcap}, asked {asked}"
                f"{', accumulate' if visited is not None else ''}, bound as counted before "
                f"(every slot, both flags) {before:.3f}")
    if key[1] == "compact_gather":
        match, _, _, bcols, pcols, total = args
        return (f", out_cap {match.shape[0]}, total {None if total is None else int(total)}, "
                f"n_match {int(out[-1])}, "
                f"{len(bcols)} build and {len(pcols)} probe columns")
    return ""


def call_key(key, args):
    """The entry point a call is noted under: K10's accumulate mode (a
    visited buffer given) apart from its fresh-flags calls."""
    if key == ("join", "match_flags") and args[5] is not None:
        return ("join", "match_flags_acc")
    if key == ("join", "table_sort") and args[0].shape[0] == 3:   # OA's (invalid, home, hash)
        return ("join", "table_sort_oa")
    return key


def entry_of(key) -> str:
    """The kernel table's entry point of a noted key."""
    return {"match_flags_acc": "match_flags", "table_sort_oa": "table_sort"}.get(key[1], key[1])


def fresh_args(key, args):
    """`args` with the buffers the call updates in place (K10's visited
    buffer, K13's accumulator) cloned, so that a replay starts from the
    state the call saw."""
    if key[1] == "match_flags_acc":
        return args[:5] + (args[5].clone(),) + args[6:]
    if key[1] == "append_rows":
        return (args[0].clone(), args[1].clone()) + tuple(args[2:])
    return args


def run_call(key, fn, args):
    """fn on fresh copies of the in-place buffers: its result and, for
    K13, the accumulator it wrote."""
    args = fresh_args(key, args)
    out = fn(*args)
    return (out, args[0], args[1]) if key[1] == "append_rows" else out


class LargestCalls:
    """Kernel tables that pass every call through to the wrappers and,
    while `on`, note the largest call (by the bytes of its tensor
    arguments) of each entry point `keep` accepts: `sizes` keeps (bytes,
    query) of the largest so far, `calls` the arguments of the running
    query's largest where `capture` is set (in-place buffers as the call
    saw them). Phases 14 and 16 note sizes only; phase 15 reruns a query
    to capture the calls it owns, so no argument is held between
    queries."""

    def __init__(self, capture: bool = False, keep=lambda key: True):
        from datafusion_parallelism_tpu_torch.kernels.chain import KERNELS as CHAIN
        from datafusion_parallelism_tpu_torch.kernels.chain import ChainKernels
        from datafusion_parallelism_tpu_torch.ops.join import KERNELS as JOIN
        from datafusion_parallelism_tpu_torch.ops.join import JoinKernels
        self.on, self.capture, self.query, self.keep = False, capture, None, keep
        self.sizes, self.calls = {}, {}
        self.join = JoinKernels(*(self._wrap(("join", e), fn) for e, fn in JOIN._asdict().items()))
        self.chain = ChainKernels(*(self._wrap(("chain", e), fn)
                                    for e, fn in CHAIN._asdict().items()))

    def _wrap(self, entry, fn):
        def run(*args):
            key = call_key(entry, args)
            if self.on and self.keep(key):
                size = _bytes(args)
                if size > self.sizes.get(key, (-1,))[0]:
                    self.sizes[key] = (size, self.query)
                    if self.capture:
                        self.calls[key] = fresh_args(key, args)
            return fn(*args)
        return run


def kernel_launches():
    """{kernel name: launches so far}, each wrapper counted once."""
    wrappers = {fn: kernel_of(key) for key, fn in all_counters().items()}
    out = {}
    for fn, name in wrappers.items():
        out[name] = out.get(name, 0) + fn.launches
    return out


def diff_rule_match(got, want) -> None:
    """tpch/diff_results.py's rule, imported: the rows as the CLI's CSVs
    hold them (each value its text, NULL empty), equal row multisets,
    floats within rel 1e-6 or abs 1e-4; and the same columns in every row
    pair."""
    from datafusion_parallelism_tpu_torch.tpch.diff_results import _norm, _rows_match

    def text(rows):
        return _norm([{k: "" if v is None else str(v) for k, v in r.items()} for r in rows])
    a, b = text(got), text(want)
    if len(a) != len(b):
        raise AssertionError(f"{len(a)} rows, oracle {len(b)}")
    for ra, rb in zip(a, b):
        if [k for k, _ in ra] != [k for k, _ in rb] or not _rows_match([ra], [rb]):
            raise AssertionError(f"{ra} vs oracle {rb}")


def _oracle_answers(sf: float, queries):
    """In a spawned process: TPC-H at `sf` from the generator's fixed seed
    (the tables the card runs on) and the numpy oracle's answers to
    `queries`. It touches no CUDA."""
    from datafusion_parallelism_tpu_torch.tpch.datagen import generate_tables
    from datafusion_parallelism_tpu_torch.tpch.oracle import oracle_query
    tables = generate_tables(sf=sf)
    return {q: oracle_query(q, tables) for q in queries}


def phase_tpch_sql(device, tables, meanwhile=None):
    """All 22 TPC-H queries through SessionContext.sql at SF10. Counters
    are zeroed before the first query and read after the last; the size
    and the query of every kernel entry point's largest call are noted for
    phase 15 (those of the out-of-core kernels come from phase 16). The
    numpy oracle's answers, computed meanwhile by ORACLE_WORKERS spawned
    processes, are checked after the last query and kept for phases 16
    and 17. `meanwhile(res, statistics)` (phase 17's runs, given this
    phase's results and its tables' statistics) runs on the card while the
    oracle is still computing; what it returns comes back last."""
    import concurrent.futures
    import multiprocessing

    from datafusion_parallelism_tpu_torch.tpch import QUERIES

    queries = sorted(QUERIES)
    pool = concurrent.futures.ProcessPoolExecutor(
        ORACLE_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    try:
        futures = [pool.submit(_oracle_answers, TPCH_SF, queries[i::ORACLE_WORKERS])
                   for i in range(ORACLE_WORKERS)]
        res, lines, got, ctx, sizes = _run_tpch_sql(device, tables, queries)
        launches = kernel_launches()
        extra = meanwhile(res, table_statistics(ctx)) if meanwhile is not None else None
        t0 = time.perf_counter()
        oracle = {}
        for f in futures:
            oracle.update(f.result())
        oracle_wait_s = time.perf_counter() - t0
    finally:
        pool.shutdown(cancel_futures=True)
    for q in queries:
        try:
            diff_rule_match(got[q], oracle[q])
        except AssertionError as e:
            raise AssertionError(f"Q{q}: {e}") from None
    missing = [k for k in KERNEL_INFO if k not in OOC_KERNELS + STRATEGY_KERNELS + DIST_KERNELS
               and launches.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the SQL path: {missing}")
    log(f"phase 14 ok: TPC-H SF{TPCH_SF}, 22 queries through SessionContext.sql, each == the "
        "numpy oracle (diff_results rule); median of 3 collect()s after a settling one: "
        + " | ".join(lines) + f"; launches over the phase: {launches}; after the last query "
        f"the oracle's {ORACLE_WORKERS} processes took {oracle_wait_s:.1f} s more")
    return res, launches, ctx, sizes, oracle, got, extra


def table_statistics(ctx) -> dict:
    """Each registered table's statistics as `ctx` has computed them (the
    distinct counts and hot-key shares its planning read): a later session
    over the same tables registers them and plans without computing them
    again from the SF10 columns."""
    return {name: ctx.catalog.get(name).statistics for name in ctx.catalog.tables}


def _run_tpch_sql(device, tables, queries):
    """Phase 14's runs: (per-query results, their log lines, each query's
    rows, the session, the largest calls' sizes)."""
    import torch
    from datafusion_parallelism_tpu_torch import SessionContext
    from datafusion_parallelism_tpu_torch.tpch import QUERIES

    ctx = SessionContext(device=device)
    for name, t in tables.items():
        ctx.register_table(name, t)
    rec = LargestCalls(keep=lambda key: key not in OOC_ENTRIES | STRATEGY_ENTRIES)
    for fn in set(all_counters().values()):
        fn.launches = 0
    res, lines, got = {}, [], {}
    for q in queries:
        before = kernel_launches()
        rec.on, rec.query = True, (14, q, ())
        handle = ctx.sql(QUERIES[q], kernels=rec.join, chain=rec.chain)
        t0 = time.perf_counter()
        rows = handle.collect().to_pylist()
        first_s = time.perf_counter() - t0
        rec.on = False
        after = kernel_launches()
        launched = {k: after[k] - before.get(k, 0) for k in after if after[k] > before.get(k, 0)}
        retries = handle.metrics.retries
        got[q] = rows
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)   # the tables held before the query
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            handle.collect()
            torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t0)
        ms = statistics.median(times) * 1e3
        peak = torch.cuda.max_memory_allocated(device)
        res[q] = {"ms": ms, "first_ms": first_s * 1e3, "retries": retries,
                  "staged": handle.metrics.staged, "peak_bytes": peak,
                  "query_peak_bytes": peak - base, "rows": len(rows), "launches": launched}
        lines.append(f"Q{q} {ms:.3f} ms (first run {first_s * 1e3:.1f}), {len(rows)} rows, "
                     f"{retries} retries, {'staged' if handle.metrics.staged else 'one run'}, "
                     f"peak {peak} bytes ({peak - base} over the {base} held before), "
                     f"launches {launched}")
        del handle
    return res, lines, got, ctx, rec.sizes


def _row_bytes(words, f64) -> int:
    return words.shape[0] * 4 + f64.shape[0] * 8


def work(key, args, out):
    """(bytes, operations) one call needs: each input byte it must read
    once (a gathered input only at the rows it gathers), each output byte
    written once; operations only where they could bound it (K8's
    requests x groups per row)."""
    import torch
    entry = entry_of(key)
    if entry == "probe_ranges":
        slot, ok, _ = args
        reads = _bytes([slot, ok]) + 8 * slot.numel()
    elif entry == "expand_ranges":
        start, _, base, total, pwords, bwords, _, out_cap = args
        k = min(int(total), out_cap)
        reads = _bytes([start, base, pwords]) + min(bwords.nbytes, k * bwords.shape[0] * 4)
    elif entry == "sorted_probe":
        # the two keys around each probe row's place at least
        hashes, ok, sorted_hash = args
        reads = _bytes([hashes, ok]) + min(sorted_hash.nbytes, 16 * hashes.numel())
    elif entry == "oa_place":
        # `ok` whole; below n_valid (the valid rows come first in `order`)
        # each sorted row's order entry and its gathered hash; the home is
        # computed from the hash, not read
        _, _, _, ok, _ = args
        reads = ok.nbytes + 8 * int(ok.sum())
    elif entry == "oa_probe":
        # `hashes` and `ok` whole; each valid probe row reads its run and
        # the slot that ends its walk; the home is computed from the hash
        hashes, ok, slots = args
        reads = _bytes([hashes, ok]) + min(slots.nbytes, 8 * (int(ok.sum()) + int(out[3])))
    elif entry == "compact_gather":
        match, _, _, build_cols, probe_cols, total = args
        out_cap = match.shape[0]
        k = out_cap if total is None else min(int(total), out_cap)
        return k4_bytes(out_cap, k, int(out[-1]), build_cols, probe_cols), 0
    elif entry == "gather_rows":
        # idx and a source row for each row below the count, every row written
        return gather_work(args), 0
    elif entry == "filter_compact":
        mask, words, f64, out_cap = args
        k = min(int(out[-1]), out_cap)
        reads = mask.nbytes + min(words.nbytes + f64.nbytes, k * _row_bytes(words, f64))
    elif entry == "pair_fetch":
        start, base, total, pwords, pf64, bwords, _, _, out_cap = args
        k = min(int(total), out_cap)
        reads = (_bytes([start, base]) + min(pwords.nbytes + pf64.nbytes, k * _row_bytes(pwords, pf64))
                 + min(bwords.nbytes, k * bwords.shape[0] * 4))
    elif entry == "concat_rows":
        reads = sum(min(w.nbytes + f.nbytes, int(n) * _row_bytes(w, f)) for w, f, n in args[0])
    elif entry == "pack_rows":
        # a float64 column stays beside the words: only its validity is read
        layout, cols = args
        reads = sum(valid.nbytes + (0 if kind.value == "float64" else v.nbytes)
                    for (_, kind, _, _), (v, valid) in zip(layout.fields, cols))
    elif entry == "unpack_rows":
        # int32-wide values are views of their word row: nothing moves;
        # int64/bool values and every validity are read and written
        layout, packed = args
        rows = {layout.valid_base + j // 32 for j in range(len(layout.fields))}
        moved = [v for v, _ in out if v is not None and v.dtype in (torch.int64, torch.bool)]
        rows |= {slot + i for (_, _, slot, n), (v, _) in zip(layout.fields, out)
                 if v is not None and v.dtype in (torch.int64, torch.bool) for i in range(n)}
        return (len(rows) * packed.shape[1] * 4 + _bytes(moved)
                + sum(valid.nbytes for _, valid in out)), 0
    elif entry == "append_rows":
        # the appended rows' words are read and written once
        acc, acc_f64, acc_rows, words, f64, num_rows = args
        k = max(0, min(int(num_rows), words.shape[1], acc.shape[1] - int(acc_rows)))
        return 2 * k * _row_bytes(words, f64) + 12, 0
    elif entry == "match_flags":
        # the match bytes below the total; each asked flag's ids at the
        # matched slots (its flags are written once: the outputs)
        match, _, _, bcap, mcap, _, total = args
        k = match.shape[0] if total is None else max(0, min(int(total), match.shape[0]))
        hits = int(match[:k].sum())
        reads = k + 4 * hits * ((bcap is not None) + (mcap is not None))
    elif entry == "segment_agg":
        return k7_work(*args), 0
    else:
        reads = _bytes(args)
    ops = 0
    if entry == "direct_agg":
        keys, doms, _, _, reqs, cap = args
        ops = cap * int(np.prod(doms)) * len(reqs)
    return reads + _bytes(out), ops


def k4_bytes(out_cap: int, k: int, n_match: int, build_cols, probe_cols) -> int:
    """The bytes a K4 call must move: the match flags of the k candidate
    slots below min(total, out_cap), the two ids of each match, each
    match's values and validity of every column of both sides read once,
    every output column (values and validity) written whole, the count."""
    row = sum(v.element_size() + 1 for v, _ in list(build_cols) + list(probe_cols))
    return k + 8 * n_match + row * (n_match + out_cap) + 8


def k7_work(words, cols, n_valid, reqs, out_cap) -> int:
    """The bytes a K7 call must move: each word row the key's columns name
    (values and validity) and each distinct request input (values, except
    for a count, and validity) read once below n_valid; starts, sizes, one
    accumulator row a request and the group count written whole."""
    n = words.shape[1]
    k = max(0, min(int(n_valid), n))
    rows = {r for _, rs, (vrow, _) in cols for r in (*rs, vrow)}
    inputs = {}
    for func, values, validity in reqs:
        for t in ((values,) if func != "count" else ()) + ((validity,) if validity is not None
                                                           else ()):
            inputs[(t.data_ptr(), t.element_size())] = t.element_size()
    return 4 * k * len(rows) + k * sum(inputs.values()) + out_cap * (4 + 8 + 8 * len(reqs)) + 8


def gather_work(args, counted: bool = True) -> int:
    """The bytes a K5 gather call must move (kernels/filter_compact.py
    `gather_bytes`): with its count, or (counted=False) as if every row
    were read, the bound before callers passed counts."""
    from datafusion_parallelism_tpu_torch.kernels.filter_compact import gather_bytes
    words, f64, idx = args[:3]
    n = args[3] if len(args) > 3 and counted else None
    return gather_bytes(words.shape[0], f64.shape[0], words.shape[1], idx.shape[0],
                        None if n is None else int(n))


K6_ENTRIES = ("radix_sort", "table_sort", "table_sort_oa")


def library_call(key, args):
    """One PyTorch call computing the same function on the same inputs, or
    None: K6 is torch.argsort(stable=True) of its packed key where that
    fits 63 bits (packed before the timing, pack_key_plain); K5's row
    gather is index_select of the words and of the float64 sidecars (with
    the indices clamped first where any lies outside the rows, as K5
    clips), then torch.where past `n` where it is given; K5's compaction is
    the boolean index words[:, mask], f64[:, mask] (the host reads the count
    inside); K10 is index_fill_
    at the matched ids (selected inside the timing, as K10 selects them),
    K11 torch.cat of the valid prefixes, K13 a slice copy_ (the device
    counts of these two read before the timing; library_sync_call reads
    them inside it)."""
    import torch
    from datafusion_parallelism_tpu_torch.kernels import radix_sort as k6
    entry = key[1]
    if entry in K6_ENTRIES:
        plan = k6.planned(*args)
        if plan.bits > 63:
            return None
        packed = (k6.pack_key_plain(args[0], plan)[0] if plan.bits
                  else torch.zeros(args[0].shape[1], dtype=torch.int64, device=args[0].device))
        return lambda: torch.argsort(packed, stable=True)
    if entry == "sorted_probe":
        hashes, _, sorted_hash = args
        ph = hashes.long() & 0xFFFFFFFF
        return lambda: (torch.searchsorted(sorted_hash, ph, side="left"),
                        torch.searchsorted(sorted_hash, ph, side="right"))
    if entry == "gather_rows":
        words, f64, idx = args[:3]
        n = args[3] if len(args) > 3 else None
        cap = words.shape[1]
        if cap == 0:
            return None
        inside = bool(((idx >= 0) & (idx < cap)).all())

        def gather():
            i = idx if inside else idx.clamp(0, cap - 1)
            out, out_f64 = words.index_select(1, i), f64.index_select(1, i)
            if n is None:
                return out, out_f64
            ok = torch.arange(idx.shape[0], device=idx.device) < n
            return torch.where(ok, out, 0), torch.where(ok, out_f64, 0.0)
        return gather
    if entry == "filter_compact":
        # a boolean index of the words and sidecars (the host reads the
        # survivor count inside: the index must size its output); no zero
        # tail, no out_cap
        mask, words, f64, _ = args
        return lambda: (words[:, mask], f64[:, mask])
    if entry in ("match_flags", "match_flags_acc"):
        # index_fill_ of the asked flags at the matched ids below the total,
        # selected inside the timing
        match, build_id, probe_idx, bcap, mcap, visited, total = args
        visited = visited.clone() if visited is not None else None

        def flags():
            hit = match if total is None else match & (
                torch.arange(match.shape[0], device=match.device) < total)
            out = []
            for cap, ids, buf in ((bcap, build_id, visited), (mcap, probe_idx, None)):
                if cap is not None:
                    buf = buf if buf is not None else torch.zeros(cap, dtype=torch.bool,
                                                                  device=match.device)
                    out.append(buf.index_fill_(0, ids[hit].long(), True))
            return out
        return flags
    if entry == "concat_rows":
        # torch.cat of the parts' valid prefixes (their counts read first)
        parts = args[0]
        ns = [int(n) for _, _, n in parts]
        return lambda: (torch.cat([w[:, :k] for (w, _, _), k in zip(parts, ns)], 1),
                        torch.cat([f[:, :k] for (_, f, _), k in zip(parts, ns)], 1))
    if entry == "append_rows":
        # a slice copy_ of the new rows into the accumulator
        acc, acc_f64, acc_rows, words, f64, num_rows = args
        lo = int(acc_rows)
        k = max(min(int(num_rows), acc.shape[1] - lo), 0)
        return lambda: (acc[:, lo:lo + k].copy_(words[:, :k]),
                        acc_f64[:, lo:lo + k].copy_(f64[:, :k]))
    return None


def partial_call(key, args):
    """A partial yardstick, not the same function, or None: K8 is one
    index_add_ (counts, sums) or scatter_reduce_ (min, max) a request over
    group ids made before the timing (rows outside the filter or NULL in a
    dump slot G); K7 is torch.unique_consecutive of the key's word columns
    below n_valid (read before the timing) with their counts, then one
    torch.segment_reduce a request whose input is floating (its only
    types), validity ignored."""
    import torch
    if key[1] == "segment_agg":
        words, _, n_valid, reqs, _ = args
        k = int(n_valid)
        kw = words[:, :k]
        floats = [(func, values[:k]) for func, values, _ in reqs
                  if func != "count" and values.is_floating_point()]

        def segments():
            counts = torch.unique_consecutive(kw, dim=1, return_counts=True)[1]
            return [torch.segment_reduce(v, func, lengths=counts) for func, v in floats]
        return segments
    if key[1] != "direct_agg":
        return None
    from datafusion_parallelism_tpu_torch.kernels import _agg
    from datafusion_parallelism_tpu_torch.kernels import direct_agg as k8
    keys, doms, num_rows, row_filter, reqs, cap = args
    G = k8.n_groups_of(doms)
    gid = k8._group_ids(keys, doms, num_rows, row_filter, cap)
    prepared = []
    for func, values, validity in reqs:
        acc = _agg.acc_dtype(func, values)
        g = gid if validity is None else torch.where(validity, gid, G)
        prepared.append((func, acc, g, torch.ones_like(g) if func == "count" else values.to(acc)))

    def run():
        out = []
        for func, acc, g, x in prepared:
            o = torch.zeros(G + 1, dtype=acc, device=gid.device)
            out.append(o.index_add_(0, g, x) if func in ("count", "sum") else
                       o.scatter_reduce_(0, g, x, "amin" if func == "min" else "amax"))
        return out
    return run


def agg_compact_detail(key, args, out, device) -> str:
    """Phase 15's detail of a K8 or K5 compaction call ('' for the rest):
    K8's cap, rows, groups, requests, staged bytes and launch plans; K5's
    cap, words, sidecars, out_cap, survivors and tiles."""
    from datafusion_parallelism_tpu_torch.kernels import direct_agg as k8
    from datafusion_parallelism_tpu_torch.kernels import filter_compact as k5
    if key[1] == "direct_agg":
        keys, doms, num_rows, row_filter, reqs, cap = args
        # (T, shared bytes, blocks, blocks an SM) of each launch
        plans = [p[:4] for p in k8.launch_plans(*args)]
        return (f", cap {cap}, num_rows {int(num_rows)}, G {k8.n_groups_of(doms)}, R "
                f"{len(reqs) + 1}, {'a' if row_filter is not None else 'no'} row filter, "
                f"{k8.stream_bytes(keys, reqs, row_filter)} staged bytes a row, plans {plans}")
    if key[1] == "filter_compact":
        mask, words, f64, out_cap = args
        return (f", cap {mask.shape[0]}, W {words.shape[0]}, F {f64.shape[0]}, out_cap "
                f"{out_cap}, {int(out[2])} survivors, {k5.compact_tiles(mask.shape[0])} tiles")
    return ""


def library_sync_call(key, args):
    """K11's and K13's library calls with their device counts read inside
    the timing, as the kernels read them on the device (the host waits on
    the card for them); None for the other entry points."""
    import torch
    entry = key[1]
    if entry == "concat_rows":
        parts = args[0]

        def cat():
            ns = [int(n) for _, _, n in parts]
            return (torch.cat([w[:, :k] for (w, _, _), k in zip(parts, ns)], 1),
                    torch.cat([f[:, :k] for (_, f, _), k in zip(parts, ns)], 1))
        return cat
    if entry == "append_rows":
        acc, acc_f64, acc_rows, words, f64, num_rows = args

        def copy():
            lo = int(acc_rows)
            k = max(min(int(num_rows), words.shape[1], acc.shape[1] - lo), 0)
            return (acc[:, lo:lo + k].copy_(words[:, :k]),
                    acc_f64[:, lo:lo + k].copy_(f64[:, :k]))
        return copy
    return None


def k5_k17_detail(key, args, device):
    """(phase 15's detail, the bound in ms with every row read or None) of
    a K5 gather or K17 call: the gather's shape, count, layout and the
    bound before callers passed counts; K17's program, rows, mode and
    tile."""
    from datafusion_parallelism_tpu_torch.kernels import _build
    from datafusion_parallelism_tpu_torch.kernels import expr_eval as k17
    from datafusion_parallelism_tpu_torch.kernels import filter_compact as k5
    lim = _build.device_limits(device)
    if key[1] == "gather_rows":
        words, f64, idx = args[:3]
        n = args[3] if len(args) > 3 else None
        all_rows = gather_work(args, counted=False) / HBM_BYTES_PER_S * 1e3
        layout = k5.gather_layout(words.shape[1], f64.shape[0], lim.l2_bytes)
        return (f", W {words.shape[0]}, F {f64.shape[0]}, cap {words.shape[1]}, m "
                f"{idx.shape[0]}, n {None if n is None else int(n)}, layout {layout}, bound "
                f"with every row read {all_rows:.3f}"), all_rows
    program, _, n, _, mask = args[:5]
    tile = k17.plan_tile(max(program.n_regs, 1), len(program.code),
                         1 if mask is not None else len(program.roots), lim.smem_block,
                         lim.smem_sm)[0]
    return (f", {len(program.code)} instructions over {program.n_regs} registers, {n} rows, "
            f"{'mask' if mask is not None else 'values'}, tile {tile}"), None


def k7_detail(args, out_bytes: int):
    """(phase 15's detail, the bound in ms with every byte of the arguments
    and outputs moved, as counted before) of a K7 call: its capacity, key
    word rows and columns, valid rows, out_cap and requests."""
    words, cols, n_valid, reqs, out_cap = args
    all_rows = (_bytes(args) + out_bytes) / HBM_BYTES_PER_S * 1e3
    return (f", cap {words.shape[1]}, {words.shape[0]} key words in {len(cols)} columns, "
            f"n_valid {int(n_valid)}, out_cap {out_cap}, {len(reqs)} requests, bound with "
            f"every row read {all_rows:.3f}"), all_rows


def row_copy_shape(key, args) -> str:
    """K11's and K13's shapes, for the phase-15 line ('' for the rest)."""
    if key[1] == "concat_rows":
        parts = args[0]
        return (f", W {parts[0][0].shape[0]}, F {parts[0][1].shape[0]}, caps "
                f"{[w.shape[1] for w, _, _ in parts]}, num_rows {[int(n) for _, _, n in parts]}")
    if key[1] == "append_rows":
        acc, acc_f64, acc_rows, words, _, num_rows = args
        return (f", W {acc.shape[0]}, F {acc_f64.shape[0]}, acc_cap {acc.shape[1]}, acc_rows "
                f"{int(acc_rows)}, cap {words.shape[1]}, num_rows {int(num_rows)}")
    return ""


def phase_replay(device, ctx, sizes):
    """For each query that made an entry point's largest call in phase 14
    or 16 (`sizes`: key -> (bytes, (phase, query, extra env))), its first
    run again in that phase's session (`ctx`: phase -> SessionContext)
    and environment, capturing
    those calls; each captured call then goes through the kernel and its
    plain version (equal), timed, beside its bound and its library
    call. Before each rerun the other sessions drop their cached device
    tables."""
    import torch
    from datafusion_parallelism_tpu_torch.kernels import radix_sort as k6
    from datafusion_parallelism_tpu_torch.kernels.chain import KERNELS as CHAIN
    from datafusion_parallelism_tpu_torch.kernels.chain import PLAIN as CHAIN_PLAIN
    from datafusion_parallelism_tpu_torch.ops.join import KERNELS as JOIN
    from datafusion_parallelism_tpu_torch.ops.join import PLAIN as JOIN_PLAIN
    from datafusion_parallelism_tpu_torch.tpch import QUERIES
    per_kernel, lines = {}, []
    held = []
    for owner in sorted({owner for _, owner in sizes.values()}):
        phase, q, extra = owner
        env = dict(extra)
        strategy = env.pop("strategy", None)
        session = ctx[(phase, strategy)] if strategy else ctx[phase]
        # the other sessions' cached device tables go: four sessions' caches
        # and one query's largest calls do not fit the card together
        for other in ctx.values():
            if other is not session:
                for reg in other.catalog.tables.values():
                    reg.release_device()
        gc.collect()
        torch.cuda.empty_cache()
        held.append(f"Q{q}@{phase}{'/' + strategy if strategy else ''} "
                    f"{torch.cuda.memory_allocated()}")
        rec = LargestCalls(capture=True)
        rec.on, rec.query = True, owner
        with ooc_env(phase == 16, **env):
            session.sql(QUERIES[q], kernels=rec.join, chain=rec.chain).collect()
        rec.on = False
        for key in sorted(k for k, (_, o) in sizes.items() if o == owner):
            args = rec.calls.pop(key)
            if _bytes(args) != sizes[key][0]:
                raise AssertionError(f"Q{q} {key}: rerun call of {_bytes(args)} bytes, phase "
                                     f"{phase} noted {sizes[key][0]}")
            kernel, plain = (JOIN, JOIN_PLAIN) if key[0] == "join" else (CHAIN, CHAIN_PLAIN)
            kernel, plain = getattr(kernel, entry_of(key)), getattr(plain, entry_of(key))
            with no_launches():
                want = run_call(key, plain, args)
            got = run_call(key, kernel, args)
            err = entry_err(key[1], args, got, want)
            if key[1] == "segment_agg":   # float64 sums: the same bits every run
                max_abs_err(got, run_call(key, kernel, args))
            nbytes, ops = work(key, args, got)
            out_bytes = _bytes(got)
            csr_detail = join_detail(key, args, got) or agg_compact_detail(key, args, got,
                                                                            device)
            lib = library_call(key, args)
            partial = partial_call(key, args)
            if lib is not None and key[1] == "gather_rows":
                max_abs_err(lib(), got)   # the yardstick computes K5's function
            if key[1] == "filter_compact":   # ... and the survivors of its compaction
                k = min(int(got[2]), args[3])
                max_abs_err(tuple(t[:, :k] for t in lib()), tuple(t[:, :k] for t in got[:2]))
            del got, want
            ms = cuda_ms(kernel, *args, reps=3)
            with no_launches():
                plain_ms = cuda_ms(plain, *args, reps=1)
            lib_ms = cuda_ms(lib, reps=3) if lib is not None else None
            partial_ms = cuda_ms(partial, reps=3) if partial is not None else None
            sync = library_sync_call(key, args)
            sync_ms = cuda_ms(sync, reps=3) if sync is not None else None
            detail = row_copy_shape(key, args)
            acc_all = None
            if key[1] in ("gather_rows", "expr_eval"):
                detail, acc_all = k5_k17_detail(key, args, device)
            if key[1] == "segment_agg":
                detail, acc_all = k7_detail(args, out_bytes)
            if csr_detail:
                detail = csr_detail
            if key[1] in K6_ENTRIES:
                plan = k6.planned(*args)
                detail = (f", {args[0].shape[1]} rows, {args[0].shape[0]} words, {plan.bits} "
                          f"varying bits, {plan.key_bits}-bit key, {len(plan.passes)} passes")
            del args, lib, sync, partial
            acc = per_kernel.setdefault(kernel_of(key), {
                "err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                "bound_ms": 0.0, "bound_all_rows_ms": 0.0, "library_ms": 0.0,
                "library_sync_ms": None, "library_partial_ms": None, "library_by_call": {},
                "calls": []})
            b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S * 1e3
            acc["bound_all_rows_ms"] += max(b_ms, o_ms) if acc_all is None else acc_all
            acc["err"] = max(acc["err"], err)
            acc["ms"] += ms
            acc["plain_ms"] += plain_ms
            acc["bytes_ms"] += b_ms
            acc["ops_ms"] += o_ms
            acc["bound_ms"] += max(b_ms, o_ms)
            acc["library_ms"] = (None if lib_ms is None or acc["library_ms"] is None
                                 else acc["library_ms"] + lib_ms)
            if sync_ms is not None:
                acc["library_sync_ms"] = (acc["library_sync_ms"] or 0.0) + sync_ms
            if partial_ms is not None:
                acc["library_partial_ms"] = (acc["library_partial_ms"] or 0.0) + partial_ms
            where = ("(ooc)" if phase == 16 else f"({strategy})" if strategy else "")
            call = f"{key[0]}.{key[1]}@Q{q}" + where
            acc["calls"].append(call)
            if lib_ms is not None:
                acc["library_by_call"][call] = lib_ms
            lines.append(f"{key[0]}.{key[1]} (phase {phase} Q{q}{where}{detail}, "
                         f"{nbytes} bytes moved) {ms:.3f}/{plain_ms:.3f}"
                         + (f"/{lib_ms:.3f}" if lib_ms is not None else "")
                         + (f" (counts read inside: {sync_ms:.3f})" if sync_ms is not None
                            else "")
                         + (f" (partial yardstick: {partial_ms:.3f})" if partial_ms is not None
                            else "")
                         + f" bound {max(b_ms, o_ms):.3f}")
        del rec
    log("phase 15 ok: the largest phase-14 call of every entry point, phase 16's largest "
        "K12, K13 and K10 accumulate calls and phase 17's largest K14-K16 and SORT/OA "
        "build sorts, captured by rerunning their queries, == their plain "
        "versions (K9-K17 bit for bit); ms kernel/plain[/library] (median of 3 / one run / "
        "median of 3; K5's gather library == the kernel, its compaction's == the kernel's "
        "survivors) and bound: " + "; ".join(lines)
        + "; bytes allocated before each rerun: " + ", ".join(held))
    return per_kernel


@contextlib.contextmanager
def ooc_env(on: bool = True, **extra):
    """OOC_ENV and `extra` set inside (when `on`), the environment as it
    was after."""
    env = {**OOC_ENV, **extra}
    saved = {k: os.environ.get(k) for k in env}
    if on:
        os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_out_of_core(device, tables, oracle, resident, stats):
    """All 22 TPC-H queries under OOC_ENV on phase 14's tables (registered
    with phase 14's statistics, `stats`), and Q20 under DFP_FORCE_GRACE.
    Counters are zeroed before the first query and read after the last;
    the largest K12, K13 and K10 accumulate calls are noted for phase 15."""
    import torch
    from datafusion_parallelism_tpu_torch import SessionContext
    from datafusion_parallelism_tpu_torch.tpch import QUERIES

    ctx = SessionContext(device=device)
    for name, t in tables.items():
        ctx.register_table(name, t, stats[name])
    rec = LargestCalls(keep=lambda key: key in OOC_ENTRIES)
    for fn in set(all_counters().values()):
        fn.launches = 0
    res, lines = {}, []
    # the 22, then Q20 under DFP_FORCE_GRACE: the mask merge, which no
    # query takes at these thresholds (the JAX grace tests force it so)
    runs = [(q, q, {}) for q in sorted(QUERIES)] + [("20 forced grace", 20,
                                                      {"DFP_FORCE_GRACE": "1"})]
    for label, q, extra in runs:
        with ooc_env(**extra):
            rec.on, rec.query = True, (16, q, tuple(extra.items()))
            handle = ctx.sql(QUERIES[q], kernels=rec.join, chain=rec.chain)
            t0 = time.perf_counter()
            rows = handle.collect().to_pylist()
            first_s = time.perf_counter() - t0
            rec.on = False
            diff_rule_match(rows, oracle[q])
            m = handle.metrics
            pack0, up0 = m.host_pack_s, m.upload_s
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            handle.collect()
            torch.cuda.synchronize(device)
            ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated(device)
            res[label] = {"route": m.route, "chunks": m.streamed_chunks, "ms": ms,
                      "first_ms": first_s * 1e3, "host_pack_s": m.host_pack_s - pack0,
                      "upload_s": m.upload_s - up0, "retries": m.retries, "peak_bytes": peak,
                      "resident_peak_bytes": resident[q]["peak_bytes"],
                      "resident_ms": resident[q]["ms"]}
            lines.append(f"Q{label} {m.route}, {m.streamed_chunks} chunks, {ms:.3f} ms (first "
                         f"run {first_s * 1e3:.1f}; resident {resident[q]['ms']:.3f}), host pack "
                         f"{res[label]['host_pack_s']:.3f} s, upload {res[label]['upload_s']:.3f} s, "
                         f"{m.retries} retries, peak {peak} bytes (resident "
                         f"{resident[q]['peak_bytes']})")
            del handle
    launches = kernel_launches()
    routes = {r["route"] for r in res.values()}
    missing = [k for k in ("pack_rows", "append_rows") if launches.get(k, 0) < 1]
    if missing or ("join", "match_flags_acc") not in rec.sizes:
        raise AssertionError(f"kernels never launched out of core: {missing}, K10 accumulate "
                             f"{('join', 'match_flags_acc') in rec.sizes}")
    untaken = [r for r in ("streamed", "streamed after a side-swap", "grace agg",
                           "grace union", "grace mask")
               if not any(t.startswith(r) for t in routes)]
    if untaken:
        raise AssertionError(f"no query took the routes {untaken}; routes {sorted(routes)}")
    log(f"phase 16 ok: TPC-H SF{TPCH_SF}, 22 queries out of core under {OOC_ENV} (and Q20 "
        "with DFP_FORCE_GRACE), each == phase 14's oracle answer; one timed collect() after "
        "a settling one: "
        + " | ".join(lines) + f"; launches over the phase: {launches}")
    return res, launches, ctx, rec.sizes


def run_strategies(device, tables, resident, stats):
    """Phase 17's runs on the card (while phase 14's oracle computes): the
    22 TPC-H queries through SQL under the SORT strategy, then under OA, on
    phase 14's tables and statistics (`stats`): one settling collect() (its rows
    kept for the check), then the median of the timed ones, and the peak
    memory.
    Counters are zeroed before the first query and read per strategy; the
    largest calls of the strategies' entry points are noted for phase 15."""
    import torch
    from datafusion_parallelism_tpu_torch import SessionConfig, SessionContext
    from datafusion_parallelism_tpu_torch.ops.hash_table import JoinStrategy
    from datafusion_parallelism_tpu_torch.tpch import QUERIES

    rec = LargestCalls(keep=lambda key: key in STRATEGY_ENTRIES)
    for fn in set(all_counters().values()):
        fn.launches = 0
    run = {"res": {}, "rows": {}, "ctxs": {}, "lines": [], "launches": {}}
    for strategy in (JoinStrategy.SORT, JoinStrategy.OA):
        ctx = SessionContext(SessionConfig(join_strategy=strategy), device=device)
        for name, t in tables.items():
            ctx.register_table(name, t, stats[name])
        run["ctxs"][(17, strategy.name)] = ctx
        before = kernel_launches()
        for q in sorted(QUERIES):
            rec.on, rec.query = True, (17, q, (("strategy", strategy.name),))
            handle = ctx.sql(QUERIES[q], kernels=rec.join, chain=rec.chain)
            t0 = time.perf_counter()
            run["rows"][(strategy.name, q)] = handle.collect().to_pylist()
            first_s = time.perf_counter() - t0
            rec.on = False
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)   # every session's tables
            times = []
            for _ in range(STRATEGY_TIMED_RUNS):
                t0 = time.perf_counter()
                handle.collect()
                torch.cuda.synchronize(device)
                times.append(time.perf_counter() - t0)
            ms = statistics.median(times) * 1e3
            peak = torch.cuda.max_memory_allocated(device)
            csr_peak = resident[q]["query_peak_bytes"]
            run["res"][(strategy.name, q)] = {
                "ms": ms, "first_ms": first_s * 1e3, "peak_bytes": peak,
                "query_peak_bytes": peak - base, "retries": handle.metrics.retries,
                "csr_ms": resident[q]["ms"], "csr_query_peak_bytes": csr_peak}
            run["lines"].append(f"{strategy.name} Q{q} {ms:.3f} ms (first run "
                                f"{first_s * 1e3:.1f}; CSR {resident[q]['ms']:.3f}), peak "
                                f"{peak - base} bytes over the tables held (CSR {csr_peak})")
            del handle
        after = kernel_launches()
        run["launches"][strategy.name] = {k: after[k] - before.get(k, 0) for k in after
                                          if after[k] > before.get(k, 0)}
    run["sizes"] = rec.sizes
    return run


def phase_strategies(run, oracle):
    """Phase 17: run_strategies' rows, each equal to phase 14's oracle
    answer; the launch checks (K14 under SORT, K15 and K16 under OA, K17
    under both); then Q3 (streamed) and Q18 (grace agg) out of core under
    OOC_ENV in each strategy's session, each equal to the oracle."""
    from datafusion_parallelism_tpu_torch.tpch import QUERIES
    for (strategy, q), rows in run["rows"].items():
        try:
            diff_rule_match(rows, oracle[q])
        except AssertionError as e:
            raise AssertionError(f"{strategy} Q{q}: {e}") from None
    launches, lines = run["launches"], list(run["lines"])
    need = {"SORT": ("sorted_probe", "expr_eval"), "OA": ("oa_place", "oa_probe", "expr_eval")}
    missing = [f"{s}: {k}" for s, ks in need.items() for k in ks
               if launches[s].get(k, 0) < 1]
    if missing:
        raise AssertionError(f"kernels never launched under their strategy: {missing}")
    for (_, strategy), ctx in run["ctxs"].items():
        for label, q, route in (("Q3", 3, "streamed"), ("Q18", 18, "grace agg")):
            with ooc_env():
                handle = ctx.sql(QUERIES[q])
                t0 = time.perf_counter()
                rows = handle.collect().to_pylist()
                s = time.perf_counter() - t0
            try:
                diff_rule_match(rows, oracle[q])
            except AssertionError as e:
                raise AssertionError(f"{strategy} {label} out of core: {e}") from None
            if not handle.metrics.route.startswith(route):
                raise AssertionError(f"{strategy} {label} out of core took the route "
                                     f"{handle.metrics.route}, not {route}")
            run["res"][(strategy, f"{label} ooc")] = {"route": handle.metrics.route,
                                                     "chunks": handle.metrics.streamed_chunks,
                                                     "first_ms": s * 1e3}
            lines.append(f"{strategy} {label} out of core: {handle.metrics.route}, "
                         f"{handle.metrics.streamed_chunks} chunks, {s * 1e3:.1f} ms")
            del handle
    total = {k: sum(launches[s].get(k, 0) for s in launches) for k in KERNEL_INFO}
    log(f"phase 17 ok: TPC-H SF{TPCH_SF}, 22 queries through SessionContext.sql under SORT, "
        f"then under OA (run while phase 14's oracle computed), each == the oracle's answer; "
        f"median of {STRATEGY_TIMED_RUNS} collect()s after a settling one, beside CSR's "
        "(phase 14): " + " | ".join(lines)
        + f"; launches under SORT: {launches['SORT']}; under OA: {launches['OA']}")
    return run["res"], total


# ---------------------------------------------------------------------------
# queue 3 on the card, the distributed join, NCCL at world size 1
# ---------------------------------------------------------------------------

def phase_queue3(device):
    """ROADMAP queue 3's four refusals at their smallest inputs through
    SessionContext on the card: each result == the CPU session's (the
    plain versions), the same on a second run on the card, and == the JAX
    package's answer (QUEUE3_JAX)."""
    from datafusion_parallelism_tpu_torch import SessionContext
    lines = []
    for name, (tables, sql, what) in queue3_cases().items():
        rows = {}
        for dev in (device, "cpu"):
            ctx = SessionContext(device=dev)
            for tname, data in tables.items():
                ctx.register_pydict(tname, data)
            before = kernel_launches()
            rows[str(dev)] = ctx.sql(sql).collect().to_pylist()
            if dev == device:
                after = kernel_launches()
                launched = {k: after[k] - before[k] for k in after if after[k] > before[k]}
                again = ctx.sql(sql).collect().to_pylist()
        got, want = rows[str(device)], rows["cpu"]
        if sorted(map(repr, got)) != sorted(map(repr, want)):
            raise AssertionError(f"{name}: the card's rows differ from the CPU's")
        if repr(again) != repr(got):   # float64 sums: the same bits every run
            raise AssertionError(f"{name}: the card's rows differ between two runs")
        answer = queue3_answer(got, what)
        if answer != QUEUE3_JAX[name]:
            raise AssertionError(f"{name}: {answer}, the JAX package {QUEUE3_JAX[name]}")
        lines.append(f"{name} {answer} (launches {launched})")
    log("phase 18 ok: ROADMAP queue 3's refusals at their smallest inputs on the card, each "
        "== the CPU session's rows (the card's twice) and the JAX package's answer: "
        + "; ".join(lines))


DIST_P = 8                            # partitions of phase 19's in-process mesh
SKEW_KEY_RANGE = 64                   # phase 19's skewed probe keys with heavy buckets
DIST_SIZE512_CASES = ([("partitioned", t) for t in
                       ("INNER", "LEFT", "RIGHT", "FULL", "LEFT_SEMI", "LEFT_ANTI",
                        "RIGHT_SEMI", "RIGHT_ANTI")]
                      + [("broadcast", "INNER"), ("skew_salted", "INNER")])


def size512_host_tables(rng, skew_range=None):
    """bench.py's Size512 tables on the host (the draw of entry.make_tables);
    with `skew_range`, the probe keys exponential over [0, skew_range),
    skew_range * (16^x - 1) / 15 (tests/test_distributed.py:28-43)."""
    from datafusion_parallelism_tpu_torch.utils.columnar import HostTable
    n = SIZE512
    bk = rng.integers(0, n, n).astype(np.int32)
    bv = rng.random(n).astype(np.float32)
    pk = rng.integers(0, n, n).astype(np.int32)
    pv = rng.random(n).astype(np.float32)
    if skew_range is not None:
        x = rng.random(n)
        pk = np.minimum(skew_range * (16.0 ** x - 1) / 15.0, skew_range - 1).astype(np.int32)
    return (HostTable.from_numpy({"b_key": bk, "b_val": bv}),
            HostTable.from_numpy({"p_key": pk, "p_val": pv}), (bk, pk, bv, pv))


class DistRecorder:
    """The distributed layer's kernel table (K18, K19) recording the
    largest call of each kind: K18 routing by hash, salted, replicating;
    K19 (and the shards of each of its launches)."""

    def __init__(self):
        from datafusion_parallelism_tpu_torch.parallel.shuffle import KERNELS, DistKernels
        self.calls, self.hist_shards = {}, []

        def keep(kind, args, size):
            if size > self.calls.get(kind, (-1, None))[0]:
                self.calls[kind] = (size, args)

        def dest_pack(h, mask, P, send_cap, heavy=None, rank=0, replicate=None,
                      heavy_to_all=False):
            kind = ("replicate" if heavy_to_all or replicate is not None else
                    "salted" if heavy is not None else "route")
            args = (h, mask, P, send_cap, heavy, rank, replicate, heavy_to_all)
            keep(kind, args, h.numel() + P * send_cap)
            return KERNELS.dest_pack(*args)

        def key_histogram(hashes, num_rows, valid=None):
            keep("histogram", (hashes, num_rows, valid), sum(h.numel() for h in hashes))
            self.hist_shards.append(len(hashes))
            return KERNELS.key_histogram(hashes, num_rows, valid)

        self.table = DistKernels(dest_pack, key_histogram)


def _heavy_count(par, probe) -> int:
    """How many hash buckets of the probe keys skew_salted finds heavy,
    on the host (the plain versions: no launch adds to phase 19's counts)."""
    from datafusion_parallelism_tpu_torch.parallel import shuffle, skew
    host = par.make_mesh(DIST_P, "cpu")
    cols, num, schema, _ = shuffle.partition_table(probe, host.P)
    with no_launches():
        shards = shuffle.local_shards(host, schema, cols, num)
        return int(skew.heavy_buckets(skew.key_histogram(host, shards, ["p_key"])).sum())


def _sorted_columns(t):
    """The host table's columns, rows in one canonical order."""
    cols = [np.asarray(t.columns[n][0]) for n in t.schema.names]
    order = np.lexsort([c.view(np.int32) if c.dtype == np.float32 else c for c in cols])
    return [c[order] for c in cols]


class RetryLog(logging.Handler):
    """The distributed join's retry messages (its module's logger, at
    INFO), kept and printed under `label` as they come."""

    def __init__(self, label):
        super().__init__(logging.INFO)
        self.label, self.lines = label, []

    def emit(self, record):
        self.lines.append(record.getMessage())
        log(f"  {self.label}: {record.getMessage()}")


def _dist_run(par, ex, build, probe, bkeys, pkeys, cfg, rec, label):
    """One distributed_hash_join and, at the config it settled on, the
    median of 3 of its step on the device: (result, config, stats)."""
    import torch
    from datafusion_parallelism_tpu_torch.parallel import distributed, exchange, shuffle
    logger, retries = logging.getLogger(distributed.__name__), RetryLog(label)
    logger.setLevel(logging.INFO)
    logger.addHandler(retries)
    dev = ex.device
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    try:
        res, cfg = par.distributed_hash_join(ex, build, probe, bkeys, pkeys, cfg, rec.table)
    finally:
        logger.removeHandler(retries)
    first_s = time.perf_counter() - t0
    stats = {"first_ms": first_s * 1e3, "retries": retries.lines, "rows": res.num_rows}
    bcols, bnum, bschema, _ = shuffle.partition_table(build, ex.P)
    pcols, pnum, pschema, _ = shuffle.partition_table(probe, ex.P)
    builds = shuffle.local_shards(ex, bschema, bcols, bnum)
    probes = shuffle.local_shards(ex, pschema, pcols, pnum)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    times = []
    for _ in range(3):
        exchange.reset_comm_bytes()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        outs, total, dropped = distributed.dist_join_shard(ex, builds, probes, bkeys, pkeys,
                                                           cfg, rec.table)
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        del outs
    if int(dropped) or int(total) > cfg.out_cap:
        raise AssertionError(f"{label}: the settled config overflowed")
    stats.update(step_ms=statistics.median(times) * 1e3,
                 comm_bytes=exchange.get_comm_bytes(),
                 peak_bytes=torch.cuda.max_memory_allocated(dev) - base)
    del builds, probes
    return res, cfg, stats


def _k18_k19_vs_plain(rec):
    """The largest recorded K18 call of each kind and K19's, through the
    kernel and its plain version: equal, timed, beside the bound (bytes
    moved at 3.35 TB/s) and, for K19, one torch.bincount of the shards'
    buckets offset by 256 a shard (rows in the mask, selected before the
    timing)."""
    import torch
    from datafusion_parallelism_tpu_torch.kernels.dest_pack import bucket_of
    from datafusion_parallelism_tpu_torch.kernels.key_histogram import row_mask as k19_row_mask
    from datafusion_parallelism_tpu_torch.parallel.shuffle import KERNELS, PLAIN
    out, lines = {}, []
    for kind, (_, args) in sorted(rec.calls.items()):
        name = "key_histogram" if kind == "histogram" else "dest_pack"
        kernel, plain = getattr(KERNELS, name), getattr(PLAIN, name)
        got = kernel(*args)
        with no_launches():
            want = plain(*args)
        err = max_abs_err(got, want)
        h = args[0]
        rows = h.numel() if name == "dest_pack" else sum(x.numel() for x in h)
        if name == "dest_pack":
            P, send_cap, heavy, rep = args[2], args[3], args[4], args[6]
            # hash + mask (+ replicate flags, heavy table) read, the grid and
            # counts written
            nbytes = (h.numel() * (5 + (rep is not None)) + 256 * (heavy is not None)
                      + 4 * P * (send_cap + 1) + 4)
            lib_ms = None
        else:
            # each shard's hashes (and validity) below its row count read
            # once, its histogram row written once; the bound as counted
            # before: every hash and a mask byte of every row
            hashes, num_rows, valid = args
            valid = valid or [None] * len(hashes)
            counted = [min(max(int(n), 0), x.numel()) for x, n in zip(hashes, num_rows)]
            nbytes = sum(k * (4 + (v is not None)) for k, v in zip(counted, valid))
            nbytes += 256 * 4 * len(hashes)
            before = sum(x.numel() * 5 + 256 * 4 for x in hashes) / HBM_BYTES_PER_S * 1e3
            keys = torch.cat([(((x.long() & 0xFFFFFFFF) >> 24) + 256 * s)[
                k19_row_mask(x, n, v)] for s, (x, n, v) in enumerate(zip(hashes, num_rows,
                                                                          valid))])
            S = len(hashes)
            lib_ms = cuda_ms(lambda: torch.bincount(keys, minlength=256 * S), reps=3)
        ms = cuda_ms(kernel, *args, reps=3)
        with no_launches():
            plain_ms = cuda_ms(plain, *args, reps=1)
        acc = out.setdefault(name, {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0,
                                    "ops_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                                    "calls": []})
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        acc["err"] = max(acc["err"], err)
        acc["ms"] += ms
        acc["plain_ms"] += plain_ms
        acc["bytes_ms"] += b_ms
        acc["bound_ms"] += b_ms
        acc["library_ms"] = None if lib_ms is None else acc["library_ms"] + lib_ms
        shape = (f"{rows} rows" if name == "dest_pack" else
                 f"{len(h)} shards, {rows} rows, {sum(counted)} in the masks, bound as counted "
                 f"before {before:.4f}")
        acc["calls"].append(f"{name}.{kind}@{shape}")
        lines.append(f"{name} {kind} ({shape}, {nbytes} bytes moved) {ms:.3f}/"
                     f"{plain_ms:.3f}" + (f"/{lib_ms:.3f}" if lib_ms is not None else "")
                     + f" bound {b_ms:.4f}")
        del got, want
    # K18's replicate-flags input (replicating_shuffle(replicate=)), which the
    # join does not take: the heavy rows of the largest heavy_to_all call as
    # flags, == the plain version and == that call
    h, mask, P, send_cap, heavy = rec.calls["replicate"][1][:5]
    flags = heavy[bucket_of(h).long()]
    got = KERNELS.dest_pack(h, mask, P, send_cap, replicate=flags)
    same = KERNELS.dest_pack(*rec.calls["replicate"][1])
    with no_launches():
        want = PLAIN.dest_pack(h, mask, P, send_cap, replicate=flags)
    err = max(max_abs_err(got, want), max_abs_err(got, same))
    out["dest_pack"]["err"] = max(out["dest_pack"]["err"], err)
    lines.append(f"dest_pack replicate flags ({h.numel()} rows) == plain and == heavy_to_all, "
                 f"max abs err {err}")
    return out, lines


# K18's edge cases: (name, capacity, rows in the mask, P, send_cap, what
# else: a share of rows with the replicate flag, a heavy table whose rows
# stay on the rank or go to every destination)
K18_EDGES = (
    ("P = 1", 10_000, 9_000, 1, 10_000, {}),
    ("P = 1024", 1 << 18, 1 << 18, 1024, 512, {}),
    ("send_cap 0", 10_000, 10_000, 8, 0, {}),
    ("send_cap below the counts (dropped > 0)", 100_000, 100_000, 8, 5_000, {}),
    ("capacity not a multiple of the tile", 3 * 2048 + 5, 3 * 2048 + 5, 8, 3 * 2048 + 5, {}),
    ("no rows", 0, 0, 4, 16, {}),
    ("replicate flags", 50_000, 45_000, 8, 50_000, {"replicate": 0.1}),
    ("salted: heavy rows on the rank", 50_000, 50_000, 8, 50_000, {"heavy": "rank"}),
    ("heavy_to_all", 50_000, 50_000, 8, 50_000, {"heavy": "all"}),
    ("replicate flags and heavy rows on the rank, dropped", 50_000, 48_000, 16, 2_000,
     {"replicate": 0.02, "heavy": "rank"}),
)


K18_HOST_ROWS = 12_000      # the capacity's cut in the host's replays


def k18_edge(name: str, on_card: bool = True):
    """dest_pack's arguments (hashes uint32[cap], mask bool[cap], P,
    send_cap, heavy bool[256] or None, rank, replicate bool[cap] or None,
    heavy_to_all) of the K18_EDGES case `name`, numpy arrays seeded by its
    place in the list: random hashes, 3% of the rows below `rows` out of
    the mask; a heavy table marks 8 buckets, into which 30% of the hashes
    go. On the host (on_card=False) the capacity is cut to K18_HOST_ROWS,
    the rows and send_cap with it."""
    i = [e[0] for e in K18_EDGES].index(name)
    _, cap, rows, P, send_cap, edit = K18_EDGES[i]
    if not on_card and cap > K18_HOST_ROWS:
        rows, send_cap = rows * K18_HOST_ROWS // cap, send_cap * K18_HOST_ROWS // cap
        cap = K18_HOST_ROWS
    rng = np.random.default_rng(180 + i)
    h = rng.integers(0, 1 << 32, cap, dtype=np.uint64)
    mask = (np.arange(cap) < rows) & (rng.random(cap) >= 0.03)
    heavy = rep = None
    if "heavy" in edit:
        heavy = np.zeros(256, bool)
        buckets = rng.choice(256, 8, replace=False)
        heavy[buckets] = True
        into = rng.random(cap) < 0.3
        h = np.where(into, (rng.choice(buckets, cap).astype(np.uint64) << 24) | (h & 0xFFFFFF), h)
    if "replicate" in edit:
        rep = rng.random(cap) < edit["replicate"]
    return (h.astype(np.uint32), mask, P, send_cap, heavy, P // 3 if heavy is not None else 0,
            rep, edit.get("heavy") == "all")


def k18_edges(device) -> list:
    """K18 against its plain version bit for bit on its edge cases, each
    run twice with the same bits; its compiled launch plan and scratch
    bytes against the wrapper's."""
    import torch
    from datafusion_parallelism_tpu_torch.kernels import dest_pack as k18
    plans_agree((("K18", k18),))
    lines = []
    for name, *_ in K18_EDGES:
        h, mask, P, send_cap, heavy, rank, rep, to_all = k18_edge(name)
        on = (lambda a: None if a is None else torch.from_numpy(a).to(device))
        args = (on(h.view(np.int32)), on(mask), P, send_cap, on(heavy), rank, on(rep), to_all)
        grid, counts, dropped = kernel_twice(f"K18 {name}", k18.dest_pack, k18.dest_pack_plain,
                                             args)
        if k18.compiled_scratch_bytes(h.shape[0], P) != k18.scratch_bytes(h.shape[0], P):
            raise AssertionError(f"K18 {name}: scratch {k18.compiled_scratch_bytes(h.shape[0], P)}"
                                 f" bytes compiled, the wrapper says "
                                 f"{k18.scratch_bytes(h.shape[0], P)}")
        lines.append(f"{name} (capacity {h.shape[0]}, P {P}, send_cap {send_cap}, "
                     f"{int(counts.long().sum())} members, dropped {int(dropped)})")
    return lines


def phase_distributed(device):
    """The distributed hash join at P = 8 in process on the one card (the
    all-to-all a copy on the card, not NVLink): Size512 under every join
    type partitioned, INNER broadcast and skew_salted, skew_salted with
    exponential probe keys, then phase 5's SF10 orders x lineitem INNER
    join partitioned. Row counts == numpy's, the modes' INNER rows equal,
    K18 and K19 launched on the path and == their plain versions at its
    largest calls; then K18 on its edge cases (`k18_edges`), after the
    path's launches are read."""
    import torch
    from datafusion_parallelism_tpu_torch import parallel as par
    from datafusion_parallelism_tpu_torch.kernels import dest_pack, key_histogram
    from datafusion_parallelism_tpu_torch.ops.join import JoinType

    for w in (dest_pack.dest_pack, key_histogram.key_histogram):
        w.launches = 0
    rec = DistRecorder()
    ex = par.make_mesh(DIST_P, device)
    build, probe, (bk, pk, bv, pv) = size512_host_tables(np.random.default_rng(0))
    c = _size512_counts(bk, pk, bv, pv)
    n, m, ub, up = SIZE512, c["matches"], c["unmatched_build"], c["unmatched_probe"]
    expect = {"INNER": m, "LEFT": m + ub, "RIGHT": m + up, "FULL": m + ub + up,
              "LEFT_SEMI": n - ub, "LEFT_ANTI": ub, "RIGHT_SEMI": n - up, "RIGHT_ANTI": up}
    res, lines, inner = {}, [], {}
    for mode, jt in DIST_SIZE512_CASES:
        label = f"Size512 {jt} {mode}"
        cfg = par.DistJoinConfig(mode=mode, join_type=JoinType[jt])
        out, cfg, st = _dist_run(par, ex, build, probe, ["b_key"], ["p_key"], cfg, rec, label)
        if out.num_rows != expect[jt]:
            raise AssertionError(f"{label}: {out.num_rows} rows, numpy counts {expect[jt]}")
        if jt == "INNER":
            inner[mode] = _sorted_columns(out)
        res[label] = st
        lines.append(f"{label} {out.num_rows} rows, {len(st['retries'])} retries, first "
                     f"{st['first_ms']:.1f} ms, step {st['step_ms']:.3f} ms, comm "
                     f"{st['comm_bytes']} bytes, peak {st['peak_bytes']} bytes")
        del out
    for mode in ("broadcast", "skew_salted"):
        if any(not np.array_equal(a, b) for a, b in zip(inner[mode], inner["partitioned"])):
            raise AssertionError(f"Size512 INNER {mode} rows differ from partitioned")
    del inner

    # skew_salted under exponential probe keys, over the whole key range
    # and over its first SKEW_KEY_RANGE keys (where hash buckets turn heavy),
    # against numpy's count
    for skew_range in (n, SKEW_KEY_RANGE):
        sbuild, sprobe, (sbk, spk, _, _) = size512_host_tables(np.random.default_rng(1),
                                                                skew_range)
        want = int(np.bincount(sbk, minlength=n)[spk].sum())
        heavy = _heavy_count(par, sprobe)
        for mode in ("partitioned", "skew_salted"):
            label = (f"Size512 INNER {mode}, probe keys exponential over {skew_range} "
                     f"({heavy} heavy buckets)")
            out, cfg, st = _dist_run(par, ex, sbuild, sprobe, ["b_key"], ["p_key"],
                                     par.DistJoinConfig(mode=mode), rec, label)
            if out.num_rows != want:
                raise AssertionError(f"{label}: {out.num_rows} rows, numpy counts {want}")
            res[label] = st
            lines.append(f"{label} {out.num_rows} rows, {len(st['retries'])} retries, first "
                         f"{st['first_ms']:.1f} ms, step {st['step_ms']:.3f} ms, comm "
                         f"{st['comm_bytes']} bytes, peak {st['peak_bytes']} bytes")
            del out
        del sbuild, sprobe

    # phase 5's SF10 orders x lineitem, partitioned
    orders, lineitem, n_lines, expected_price = sf10_host_tables(np.random.default_rng(10))
    label = f"SF10 orders x lineitem INNER partitioned at P = {DIST_P}"
    out, cfg, st = _dist_run(par, ex, orders, lineitem, ["o_orderkey"], ["l_orderkey"],
                             par.DistJoinConfig(), rec, label)
    price = int(np.asarray(out.columns["o_totalprice"][0]).sum())
    if out.num_rows != n_lines or price != expected_price:
        raise AssertionError(f"{label}: {out.num_rows} rows (expected {n_lines}), price sum "
                             f"{price} (expected {expected_price})")
    res[label] = st
    lines.append(f"{label} {out.num_rows} rows == lineitem, price sum exact, "
                 f"{len(st['retries'])} retries, first {st['first_ms']:.1f} ms, step "
                 f"{st['step_ms']:.3f} ms, comm {st['comm_bytes']} bytes, peak "
                 f"{st['peak_bytes']} bytes")
    del out, orders, lineitem
    launches = {"dest_pack": dest_pack.dest_pack.launches,
                "key_histogram": key_histogram.key_histogram.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"K18/K19 not launched on the distributed path: {launches}")
    if launches["key_histogram"] != len(rec.hist_shards):
        raise AssertionError(f"K19 launched {launches['key_histogram']} times for "
                             f"{len(rec.hist_shards)} histograms")
    hist_line = (f"K19: {launches['key_histogram']} launches, one a histogram, shards a "
                 f"launch {sorted(set(rec.hist_shards))}")
    per_kernel, klines = _k18_k19_vs_plain(rec)
    klines.append("K18 edge cases, twice with the same bits: " + "; ".join(k18_edges(device)))
    del rec
    torch.cuda.empty_cache()
    log(f"phase 19 ok: distributed hash join at P = {DIST_P} in process on one card (the "
        "all-to-all a copy on the card): " + " | ".join(lines) + f"; INNER rows equal under "
        f"the three modes; launches {launches}; {hist_line}; K18/K19 == plain at the largest "
        "calls, ms "
        "kernel/plain[/library] (median of 3 / one run / median of 3): " + "; ".join(klines))
    return res, launches, per_kernel


def phase_nccl(device):
    """A one-rank NCCL process group (file store): the Size512 INNER join
    partitioned through ProcessGroupExchange == single-device hash_join
    row for row."""
    import tempfile

    import torch
    import torch.distributed as dist
    from datafusion_parallelism_tpu_torch import parallel as par
    from datafusion_parallelism_tpu_torch.ops.join import JoinType, hash_join

    build, probe, _ = size512_host_tables(np.random.default_rng(0))
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(d, 'store')}",
                                world_size=1, rank=0, device_id=device)
        try:
            ex = par.make_mesh(1, device, process_group=True)
            t0 = time.perf_counter()
            res, cfg = par.distributed_hash_join(ex, build, probe, ["b_key"], ["p_key"],
                                                 par.DistJoinConfig())
            nccl_s = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    bt, pt = build.to_device(device=device), probe.to_device(device=device)
    out, total = hash_join(bt, pt, ["b_key"], ["p_key"], JoinType.INNER, SIZE512_OUT_CAP)
    if int(total) > SIZE512_OUT_CAP:
        raise AssertionError(f"single-device total {int(total)} > {SIZE512_OUT_CAP}")
    want = out.to_host()
    if res.num_rows != want.num_rows or res.schema.names != want.schema.names:
        raise AssertionError(f"NCCL {res.num_rows} rows, single device {want.num_rows}")
    for name in want.schema.names:
        for a, b in zip(res.columns[name], want.columns[name]):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                raise AssertionError(f"NCCL column {name} differs from single-device")
    log(f"phase 20 ok: NCCL process group of world size 1: Size512 INNER partitioned through "
        f"ProcessGroupExchange, {res.num_rows} rows == single-device hash_join row for row; "
        f"{nccl_s * 1e3:.1f} ms end to end (host partitioning and upload included), config "
        f"{cfg}")


# phase 21's broadcast owner-dedup: nation (25 rows, under broadcast_threshold)
# LEFT JOIN supplier on a rare balance, so most nations emit an unmatched row
DIST_BROADCAST_SQL = ("SELECT n.n_name, COUNT(s.s_suppkey) AS suppliers, "
                      "SUM(s.s_suppkey) AS keys FROM nation n LEFT JOIN supplier s "
                      "ON n.n_nationkey = s.s_nationkey AND s.s_acctbal > 9999 "
                      "GROUP BY n.n_name")
# phase 21's salted owner-dedup over phase 19's exponential probe keys
DIST_SALTED_SQL = {
    "left": "SELECT COUNT(*) AS c FROM build b LEFT JOIN probe p ON b.b_key = p.p_key",
    "full": "SELECT COUNT(*) AS c FROM build b FULL JOIN probe p ON b.b_key = p.p_key",
    "left_semi": ("SELECT COUNT(*) AS c FROM build b WHERE EXISTS "
                  "(SELECT 1 FROM probe p WHERE p.p_key = b.b_key)"),
    "left_anti": ("SELECT COUNT(*) AS c FROM build b WHERE NOT EXISTS "
                  "(SELECT 1 FROM probe p WHERE p.p_key = b.b_key)"),
}
DIST_SQL_KERNELS = ("filter_compact", "match_flags", "concat_rows", "dest_pack",
                    "key_histogram")


def _dist_joins(handle):
    from datafusion_parallelism_tpu_torch.models.physical import PHashJoin
    return [n for n in handle.plan.walk() if isinstance(n, PHashJoin)]


def _dist_query(device, ctx, sql):
    """One query through a distributed session: the settling collect(),
    then one more from a synchronize to a synchronize with the peak device
    memory over it: (the rows of each run, handle, stats); the caller
    checks both runs' rows."""
    import torch
    from datafusion_parallelism_tpu_torch.runtime.distributed_executor import \
        DistributedQueryHandle
    t0 = time.perf_counter()
    handle = ctx.sql(sql)
    plan_s = time.perf_counter() - t0
    if not isinstance(handle, DistributedQueryHandle) or handle.mesh.P != DIST_P:
        raise AssertionError(f"not a distributed handle over {DIST_P} partitions: {handle}")
    t0 = time.perf_counter()
    rows = handle.collect().to_pylist()
    first_s = time.perf_counter() - t0
    retries = handle.metrics.retries
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    again = handle.collect()
    torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) * 1e3
    if handle.metrics.retries != retries:
        raise AssertionError("the settled capacities retried")
    m = handle.metrics
    ratios = [max(b) / max(min(b), 1) for b in m.balance.values() if b]
    stats = {"ms": ms, "first_ms": first_s * 1e3, "plan_ms": plan_s * 1e3,
             "retries": retries, "staged": m.staged,
             "comm_bytes": m.comm_bytes,
             "balance_max_min": max(ratios) if ratios else None,
             "stage_bytes": max((sb["leaf_bytes_per_device"] + sb["mat_bytes_per_device"]
                                 + sb["out_bytes_per_device"] for sb in m.stage_bytes),
                                default=None),
             "peak_bytes": torch.cuda.max_memory_allocated(device),
             "base_bytes": base, "modes": [(j.join_type.value, j.dist_mode)
                                           for j in _dist_joins(handle)]}
    return (rows, again.to_pylist()), handle, stats


def _dist_line(label, rows, st) -> str:
    bal = (f"{st['balance_max_min']:.3f}" if st["balance_max_min"] is not None else "no join")
    sb = st["stage_bytes"] if st["stage_bytes"] is not None else "-"
    return (f"{label} {st['ms']:.3f} ms (first run {st['first_ms']:.1f}, planning "
            f"{st['plan_ms']:.1f}), {len(rows)} rows, "
            f"{'staged' if st['staged'] else 'whole plan'}, {st['retries']} retries, comm "
            f"{st['comm_bytes']} bytes, balance max/min {bal}, largest stage {sb} bytes a "
            f"partition, peak {st['peak_bytes']} bytes ({st['peak_bytes'] - st['base_bytes']} "
            f"over the {st['base_bytes']} held before)")


def _broadcast_expect(tables):
    """numpy's answer to DIST_BROADCAST_SQL: per nation, its suppliers
    with a balance over 9999 (cents past 999900), and their keys' sum."""
    n, s = tables["nation"], tables["supplier"]
    names = n.schema.field("n_name").dictionary
    nk = np.asarray(n.columns["n_nationkey"][0])
    codes = np.asarray(n.columns["n_name"][0])
    sk = np.asarray(s.columns["s_suppkey"][0]).astype(np.int64)
    snk = np.asarray(s.columns["s_nationkey"][0])
    rich = np.asarray(s.columns["s_acctbal"][0]) > 999900
    out = {}
    for key, code in zip(nk, codes):
        hit = rich & (snk == key)
        out[names.values[code]] = (int(hit.sum()), int(sk[hit].sum()) if hit.any() else None)
    return out


def _salted_expect(bk, pk, n):
    """numpy's counts for DIST_SALTED_SQL."""
    cnt_p = np.bincount(pk, minlength=n)
    cnt_b = np.bincount(bk, minlength=n)
    per_build = cnt_p[bk]
    left = int(per_build.sum()) + int((per_build == 0).sum())
    return {"left": left, "full": left + int((cnt_b[pk] == 0).sum()),
            "left_semi": int((per_build > 0).sum()), "left_anti": int((per_build == 0).sum())}


def phase_distributed_sql(device, tables, oracle, resident, statistics):
    """SQL over SessionConfig(target_partitions=8) on the one card (P = 8
    in process; the all-to-all a copy on the card, not NVLink): the 22
    TPC-H queries at SF10, each == the numpy oracle
    (tpch/diff_results.py's rule) and == phase 14's resident rows; nation
    LEFT JOIN supplier at SF10 through the broadcast owner-dedup, ==
    numpy; LEFT, FULL, EXISTS and NOT EXISTS over phase 19's Size512
    exponential-key tables with skew_salting, each join skew_salted, the
    counts == numpy's. Each query runs twice (settling, then timed), and
    both runs' rows are checked. The kernel counters are zeroed
    before the first query and read after the last: K5, K10, K11, K18 and
    K19 each launched. The TPC-H tables are registered with phase 14's
    `statistics` (the distinct counts and hot-key shares its planning
    computed from the same tables)."""
    import torch
    from datafusion_parallelism_tpu_torch import SessionConfig, SessionContext
    from datafusion_parallelism_tpu_torch.tpch import QUERIES

    queries = sorted(QUERIES)
    for fn in set(all_counters().values()):
        fn.launches = 0
    lines = []
    ctx = SessionContext(SessionConfig(target_partitions=DIST_P), device=device)
    for name, t in tables.items():
        ctx.register_table(name, t, statistics[name])
    res, dist_rows = {}, {}
    for q in queries:
        runs, handle, st = _dist_query(device, ctx, QUERIES[q])
        for run, rows in zip(("settling", "timed"), runs):
            try:
                diff_rule_match(rows, oracle[q])
                diff_rule_match(rows, resident[q])
            except AssertionError as e:
                raise AssertionError(f"Q{q} at P = {DIST_P}, {run} run: {e}") from None
        res[q] = st
        dist_rows[q] = rows
        lines.append(_dist_line(f"Q{q}", rows, st))
        del handle
    del ctx
    gc.collect()
    torch.cuda.empty_cache()

    # broadcast owner-dedup: nation (the build, 25 rows) LEFT JOIN supplier
    ctx = SessionContext(SessionConfig(target_partitions=DIST_P), device=device)
    for name in ("nation", "supplier"):
        ctx.register_table(name, tables[name], statistics[name])
    runs, handle, st = _dist_query(device, ctx, DIST_BROADCAST_SQL)
    if st["modes"] != [("left", "broadcast")]:
        raise AssertionError(f"nation LEFT JOIN supplier ran {st['modes']}")
    want = _broadcast_expect(tables)
    for run, rows in zip(("settling", "timed"), runs):
        got = {r["n_name"]: (r["suppliers"], r["keys"]) for r in rows}
        if got != want:
            raise AssertionError(f"nation LEFT JOIN supplier, {run} run: {got} != numpy {want}")
    unmatched = sum(1 for c, _ in want.values() if c == 0)
    lines.append(_dist_line(f"nation LEFT JOIN supplier (broadcast, {unmatched} of 25 "
                            "nations unmatched)", rows, st))
    del ctx, handle

    # salted owner-dedup at Size512 scale
    build, probe, (bk, pk, _, _) = size512_host_tables(np.random.default_rng(1), SKEW_KEY_RANGE)
    ctx = SessionContext(SessionConfig(target_partitions=DIST_P, skew_salting=True),
                         device=device)
    ctx.register_table("build", build)
    ctx.register_table("probe", probe)
    want = _salted_expect(bk, pk, SIZE512)
    for jt, sql in DIST_SALTED_SQL.items():
        runs, handle, st = _dist_query(device, ctx, sql)
        if st["modes"] != [(jt, "skew_salted")]:
            raise AssertionError(f"salted {jt}: the plan ran {st['modes']}")
        for run, rows in zip(("settling", "timed"), runs):
            if rows != [{"c": want[jt]}]:
                raise AssertionError(f"salted {jt}, {run} run: {rows} != numpy {want[jt]}")
        caps = {k: v for k, v in handle.metrics.join_caps.items()
                if isinstance(k, tuple) and k[1] == "hv"}
        lines.append(_dist_line(f"Size512 {jt} skew_salted (heavy block cap {caps})", rows, st))
        del handle
    del ctx, build, probe
    gc.collect()
    torch.cuda.empty_cache()

    launches = kernel_launches()
    missing = [k for k in DIST_SQL_KERNELS if launches.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the distributed SQL path: {missing}")
    named = "; ".join(f"Q{q} {res[q]['ms']:.3f} ms" for q in (5, 9))
    log(f"phase 21 ok: SQL at SessionConfig(target_partitions={DIST_P}) in process on one card "
        f"(the collectives copies on the card, not NVLink), TPC-H SF{TPCH_SF} queries "
        f"{queries}, both runs of each == the numpy oracle and phase 14's resident rows; "
        f"BASELINE.json's fourth configuration (multi-join star queries Q5 / Q9): {named}; "
        + " | ".join(lines) + f"; launches over the phase: {launches}")
    return res, launches, dist_rows


# phase 20's SQL through NCCL: BASELINE.json's fourth configuration
DIST_NCCL_QUERIES = (5, 9)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_nccl_sql(device, tables, statistics, dist_rows):
    """Phase 20 at P = 8: a one-rank NCCL process group started by
    `init_multihost(..., local_device_count=8)`, its ProcessGroupExchange
    holding the 8 partitions, so every collective of the SQL path is an
    NCCL call; TPC-H Q5 and Q9 at SF10 through
    SessionConfig(target_partitions=8), both runs' rows == phase 21's (in
    process) exactly."""
    import torch
    from datafusion_parallelism_tpu_torch import SessionConfig, SessionContext
    from datafusion_parallelism_tpu_torch.parallel.multihost import (init_multihost,
                                                                     shutdown_multihost)
    from datafusion_parallelism_tpu_torch.tpch import QUERIES

    lines = []
    init_multihost(f"localhost:{_free_port()}", num_processes=1, process_id=0,
                   local_device_count=DIST_P)
    try:
        ctx = SessionContext(SessionConfig(target_partitions=DIST_P), device=device)
        for name, t in tables.items():
            ctx.register_table(name, t, statistics[name])
        for q in DIST_NCCL_QUERIES:
            runs, handle, st = _dist_query(device, ctx, QUERIES[q])
            if not repr(handle.mesh).startswith(f"ProcessGroupExchange(P={DIST_P}, "):
                raise AssertionError(f"Q{q} ran over {handle.mesh}")
            want = sorted(map(repr, dist_rows[q]))
            for run, rows in zip(("settling", "timed"), runs):
                if sorted(map(repr, rows)) != want:
                    raise AssertionError(f"Q{q} through NCCL, {run} run: rows differ from "
                                         "phase 21's")
            lines.append(_dist_line(f"Q{q} over {handle.mesh}", rows, st))
            del handle
        del ctx
    finally:
        shutdown_multihost()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 20 ok (SQL through NCCL): a one-rank NCCL group from init_multihost(..., "
        f"local_device_count={DIST_P}), TPC-H SF{TPCH_SF} "
        f"{['Q%d' % q for q in DIST_NCCL_QUERIES]} at target_partitions={DIST_P}, both runs' "
        "rows == phase 21's exactly: " + " | ".join(lines))


# phase 22's visited cells (tests/test_distributed_streaming.py's LEFT, NOT
# EXISTS and FULL) over SF10's customer x orders: orders streams, customer
# is the frozen build, a third of the customers have no order
DIST_STREAM_VISITED_SQL = {
    "LEFT": ("SELECT c.c_mktsegment AS g, COUNT(o.o_totalprice) AS cnt, "
             "SUM(o.o_totalprice) AS s FROM customer c LEFT JOIN orders o "
             "ON c.c_custkey = o.o_custkey GROUP BY c.c_mktsegment"),
    "NOT EXISTS": ("SELECT c.c_mktsegment AS g, COUNT(*) AS cnt FROM customer c WHERE "
                   "NOT EXISTS (SELECT 1 FROM orders o WHERE o.o_custkey = c.c_custkey) "
                   "GROUP BY c.c_mktsegment"),
    "FULL": ("SELECT COUNT(*) AS n, SUM(o.o_totalprice) AS s, MIN(c.c_nationkey) AS mg "
             "FROM customer c FULL JOIN orders o ON c.c_custkey = o.o_custkey"),
}
# the kernels phase 22 must launch: K1, K3 and K18
DIST_STREAM_KERNELS = ("hash_slot", "probe_expand", "dest_pack")


def _visited_expect(tables):
    """numpy's answers to DIST_STREAM_VISITED_SQL, keyed as the check reads
    the rows (prices in cents)."""
    c, o = tables["customer"], tables["orders"]
    ck = np.asarray(c.columns["c_custkey"][0]).astype(np.int64)
    seg = np.asarray(c.columns["c_mktsegment"][0])
    names = c.schema.field("c_mktsegment").dictionary.values
    ok = np.asarray(o.columns["o_custkey"][0]).astype(np.int64)
    price = np.asarray(o.columns["o_totalprice"][0]).astype(np.int64)
    row_of = np.full(int(max(ck.max(), ok.max())) + 1, -1, np.int64)
    row_of[ck] = np.arange(len(ck))
    orow = row_of[ok]
    hit = orow >= 0
    n_orders = np.bincount(orow[hit], minlength=len(ck))
    oseg = seg[orow[hit]]
    left = {}
    for code, name in enumerate(names):
        cnt = int((oseg == code).sum())
        left[str(name)] = (cnt, int(price[hit][oseg == code].sum()) if cnt else None)
    anti = {str(name): int(((n_orders == 0) & (seg == code)).sum())
            for code, name in enumerate(names)}
    full = (int(hit.sum()) + int((n_orders == 0).sum()) + int((~hit).sum()),
            int(price.sum()), int(np.asarray(c.columns["c_nationkey"][0]).min()))
    return {"LEFT": left, "NOT EXISTS": {k: v for k, v in anti.items() if v},
            "FULL": full}


def _check_visited(cell, rows, want) -> None:
    """A visited cell's rows against _visited_expect: counts exact, sums
    (in cents) within rel 1e-12."""
    import math

    def close(a, b):
        return a == b or (a is not None and b is not None
                          and math.isclose(a, b, rel_tol=1e-12))

    def cents(x):
        return None if x is None else float(x) * 100
    if cell == "LEFT":
        got = {r["g"]: (r["cnt"], cents(r["s"])) for r in rows}
        ok = got.keys() == want.keys() and all(
            got[k][0] == want[k][0] and close(got[k][1], want[k][1]) for k in want)
    elif cell == "NOT EXISTS":
        got = {r["g"]: r["cnt"] for r in rows}
        ok = got == want
    else:
        (r,) = rows
        got = (r["n"], cents(r["s"]), r["mg"])
        ok = got[0] == want[0] and close(got[1], want[1]) and got[2] == want[2]
    if not ok:
        raise AssertionError(f"{cell}: {got} != numpy {want}")


@contextlib.contextmanager
def sync_sites(out):
    """Every synchronizing CUDA call inside (torch.cuda's sync debug
    mode), counted in `out` by (the streaming loop's step it ran in: a
    chunk's "load", "dispatch" or "validate", else the innermost function
    of runtime/distributed_streaming.py; the port's innermost
    file:line)."""
    import traceback
    import warnings

    import torch
    root = os.path.dirname(os.path.abspath(__file__))

    def note(message, category, filename, lineno, file=None, line=None):
        frames = traceback.extract_stack()[:-1]
        port = [f for f in frames if "datafusion_parallelism_tpu_torch" in f.filename]
        ours = [f.name for f in reversed(frames)
                if f.filename.endswith("distributed_streaming.py")]
        step = next((n for n in ours if n in ("load", "dispatch", "validate")),
                    ours[0] if ours else "-")
        site = port[-1] if port else frames[-1]
        out[(step, f"{os.path.relpath(site.filename, root)}:{site.lineno}")] += 1

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = note
            yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _overlaps(timeline) -> tuple[int, int]:
    """(chunks whose pack and upload window opened while the device still
    ran the previous chunk's step, those whose window closed while it still
    ran): read from the CUDA event recorded after each dispatched step."""
    packs = [e for e in timeline if e["event"] == "pack_upload" and e["chunk"] > 0]
    return sum(e["busy_t0"] for e in packs), sum(e["busy_t1"] for e in packs)


def phase_distributed_streaming(device, tables, oracle, resident, statistics, queries=None):
    """Phase 22: distributed morsel streaming at P = 8 in process on the
    card, under OOC_ENV and the default 4,194,304-row chunk: each TPC-H
    query whose plan streams (or `queries`), then the visited cells over
    customer x orders. Per query one settling collect() (its synchronizing
    CUDA calls counted by site) and one timed, each run == the numpy
    oracle and phase 14's rows (the cells: == numpy); the route streamed,
    no retry in the timed run. The queries that do not stream are named,
    not run. Counters zeroed before the first query and read after the
    last: K1, K3 and K18 launched."""
    from collections import Counter

    import torch
    from datafusion_parallelism_tpu_torch import SessionConfig, SessionContext
    from datafusion_parallelism_tpu_torch.tpch import QUERIES

    ctx = SessionContext(SessionConfig(target_partitions=DIST_P), device=device)
    for name, t in tables.items():
        ctx.register_table(name, t, statistics[name])
    cells = [(f"Q{q}", QUERIES[q], q) for q in sorted(QUERIES) if queries is None or q in queries]
    cells += [(cell, sql, None) for cell, sql in DIST_STREAM_VISITED_SQL.items()]
    visited_want = _visited_expect(tables)
    for fn in set(all_counters().values()):
        fn.launches = 0
    res, lines, syncs, not_streamed = {}, [], Counter(), []
    for label, sql, q in cells:
        with ooc_env():
            handle = ctx.sql(sql)
            sp = handle.stream_plan()
            if sp is None:
                if q is None:
                    raise AssertionError(f"{label} does not stream under OOC_ENV")
                not_streamed.append(q)   # resident at P = 8, as in the JAX package
                continue
            vjoins = [j.join_type.value for j in sp.visited_joins]
            t0 = time.perf_counter()
            with sync_sites(syncs):
                first = handle.collect().to_pylist()
            first_s = time.perf_counter() - t0
            m = handle.metrics
            retries, pack0, up0, wait0 = m.retries, m.host_pack_s, m.upload_s, m.run_time_s
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
            t0 = time.perf_counter()
            again = handle.collect().to_pylist()
            torch.cuda.synchronize(device)
            ms = (time.perf_counter() - t0) * 1e3
        if not m.route.startswith("streamed"):
            raise AssertionError(f"{label} took the route {m.route} under OOC_ENV at P = {DIST_P}")
        if m.retries != retries:
            raise AssertionError(f"{label}: the timed run retried")
        for run, rows in zip(("settling", "timed"), (first, again)):
            try:
                if q is None:
                    _check_visited(label, rows, visited_want[label])
                else:
                    diff_rule_match(rows, oracle[q])
                    diff_rule_match(rows, resident[q])
            except AssertionError as e:
                raise AssertionError(f"{label} streamed at P = {DIST_P}, {run} run: {e}") \
                    from None
        res[label] = st = {
            "ms": ms, "first_ms": first_s * 1e3, "route": m.route, "chunks": m.streamed_chunks,
            "retries": retries, "host_pack_s": m.host_pack_s - pack0,
            "upload_s": m.upload_s - up0, "blocked_s": m.run_time_s - wait0,
            "comm_bytes": m.comm_bytes, "peak_bytes": torch.cuda.max_memory_allocated(device),
            "base_bytes": base, "overlaps": _overlaps(m.stream_timeline),
            "visited": vjoins}
        lines.append(f"{label} {ms:.3f} ms (first run {st['first_ms']:.1f}), {m.route}, "
                     f"{st['chunks']} chunks, {retries} retries, host pack "
                     f"{st['host_pack_s']:.3f} s, upload {st['upload_s']:.3f} s, blocked on "
                     f"totals {st['blocked_s']:.3f} s, comm {st['comm_bytes']} bytes, peak "
                     f"{st['peak_bytes']} bytes ({st['peak_bytes'] - base} over the {base} "
                     f"held before), device still on the previous step when the next chunk's "
                     f"pack opened / closed: {st['overlaps'][0]} / {st['overlaps'][1]} of "
                     f"{st['chunks'] - 1}, visited joins {vjoins}")
        del handle, first, again
    del ctx
    gc.collect()
    torch.cuda.empty_cache()
    launches = kernel_launches()
    missing = [k for k in DIST_STREAM_KERNELS if launches.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the streamed distributed path: "
                             f"{missing}")
    streamed = [q for _, _, q in cells if q is not None and q not in not_streamed]
    in_steps = {k: n for k, n in syncs.items() if k[0] == "dispatch"}
    log(f"phase 22 ok: distributed morsel streaming at SessionConfig(target_partitions={DIST_P}) "
        f"in process on one card, TPC-H SF{TPCH_SF} under {OOC_ENV} with "
        f"{ {**os.environ, **OOC_ENV}.get('DFP_STREAM_CHUNK_ROWS', 1 << 22)}-row chunks: the "
        f"queries whose plans stream, {streamed} (resident at P = {DIST_P}: {not_streamed}), "
        f"and the visited cells {list(DIST_STREAM_VISITED_SQL)} "
        "over customer x orders, both runs of each == the numpy oracle and phase 14's rows "
        "(the cells: == numpy): " + " | ".join(lines)
        + f"; timed runs, the device still on the previous step when the next chunk's pack "
        f"opened / closed: {sum(st['overlaps'][0] for st in res.values())} / "
        f"{sum(st['overlaps'][1] for st in res.values())} of "
        f"{sum(st['chunks'] - 1 for st in res.values())} chunks"
        f"; synchronizing CUDA calls in the settling runs by (loop function, site): "
        f"{dict(syncs)}; inside chunk steps: {in_steps} ({sum(in_steps.values())} in all)"
        f"; launches over the phase: {launches}")
    return res, launches


NATIVE_LIBS = ("tpch_datagen", "tbl_parser")   # native/*.cpp, phase 23's host libraries
CLI_MIN_FREE_BYTES = 8 * 10**9        # SF10 in the binary format is about 5.6 GB
CLI_OOC_QUERIES = (1, 3, 10)          # plans that stream lineitem under OOC_ENV
CLI_DIST_QUERIES = (5, 9)             # BASELINE.json's fourth configuration
CLI_TBL_SF = 0.1


def _cli(device, argv, out):
    """tpch.cli.run(argv + --device device --output-path out), its printed
    lines kept and shown only when it raises; no query's entry may be an
    error."""
    import io

    from datafusion_parallelism_tpu_torch.tpch import cli
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            res = cli.run(argv + ["--device", str(device), "--output-path", out])
    except BaseException:
        print(buf.getvalue(), flush=True)
        raise
    errors = {q: m["error"] for q, m in res["query_metrics"].items() if "error" in m}
    if errors:
        raise AssertionError(f"cli {argv}: queries failed: {errors}")
    return res


def _same_csvs(out, against) -> None:
    """tpch.diff_results.diff_dirs(out, against) must find no difference."""
    import io

    from datafusion_parallelism_tpu_torch.tpch.diff_results import diff_dirs
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        failures = diff_dirs(out, against)
    if failures:
        raise AssertionError(f"{out} differs from {against}: {buf.getvalue()}")


def phase_cli(device, sql_launches):
    """Phase 23: the TPC-H CLI over the native generator's SF10 tables,
    resident with --check, out of core, at 8 partitions, over .tbl files,
    and one query profiled. `sql_launches`: phase 14's launches by
    kernel."""
    import shutil
    import tempfile

    import torch
    from datafusion_parallelism_tpu_torch import SessionContext, native
    from datafusion_parallelism_tpu_torch.tpch import QUERIES
    from datafusion_parallelism_tpu_torch.tpch.cli import load_data_path
    from datafusion_parallelism_tpu_torch.tpch.eligibility import classify
    from datafusion_parallelism_tpu_torch.tpch.generate import run as generate
    from datafusion_parallelism_tpu_torch.utils import tracing

    root = tempfile.mkdtemp(prefix="dfp_cli_")
    try:
        free = shutil.disk_usage(root).free
        if free < CLI_MIN_FREE_BYTES:
            raise RuntimeError(f"phase 23 writes TPC-H SF{TPCH_SF} under {root}: "
                               f"{free} bytes free, {CLI_MIN_FREE_BYTES - free} short of "
                               f"{CLI_MIN_FREE_BYTES}")
        data = os.path.join(root, "bin")
        t0 = time.perf_counter()
        generate(["--scale-factor", str(TPCH_SF), "--output", data, "--format", "bin"])
        gen_s = time.perf_counter() - t0
        gen_bytes = sum(os.path.getsize(os.path.join(d, f))
                        for d, _, fs in os.walk(data) for f in fs)
        lib = native.loaded_path("tpch_datagen")
        want_lib = os.path.join(os.path.dirname(os.path.abspath(native.__file__)), "_build",
                                "libtpch_datagen.so")
        if lib != want_lib:
            raise AssertionError(f"the generator ran from {lib}, not {want_lib}")

        # (b) the 22 resident, checked, through the kernels
        for fn in set(all_counters().values()):
            fn.launches = 0
        tracing.span_report(reset=True)
        resident = os.path.join(root, "resident")
        t0 = time.perf_counter()
        res = _cli(device, ["--data-path", data, "--iterations", "2", "--check"], resident)
        resident_s = time.perf_counter() - t0
        spans = tracing.span_report(reset=True)
        launches = kernel_launches()
        unchecked = [q for q in sorted(QUERIES) if res["checked"].get(q) is not True]
        if unchecked:
            raise AssertionError(f"cli --check failed or missing for {unchecked}")
        missing = [k for k, n in sql_launches.items() if n > 0 and launches.get(k, 0) < 1]
        if missing:
            raise AssertionError(f"kernels of phase 14 never launched by the CLI: {missing}")
        oracle_s = sum(s["oracle_ms"] for s in res["query_summary"].values()) / 1e3

        # (c) out of core from the memmapped pages
        ooc = os.path.join(root, "ooc")
        argv = ["--data-path", data, "--iterations", "1"]
        for q in CLI_OOC_QUERIES:
            argv += ["--query", str(q)]
        t0 = time.perf_counter()
        with ooc_env():
            res_ooc = _cli(device, argv, ooc)
            ctx = SessionContext(device=device)
            tables = load_data_path(data)
            for name, t in tables.items():
                ctx.register_table(name, t, getattr(t, "statistics_hint", None))
            eligible = {q: classify(ctx.sql(QUERIES[q]).plan, ctx.catalog)
                        for q in CLI_OOC_QUERIES}
        ooc_s = time.perf_counter() - t0
        routes = {q: res_ooc["query_metrics"][q]["route"] for q in CLI_OOC_QUERIES}
        if any(r != "streamed" for r in routes.values()):
            raise AssertionError(f"out of core the CLI's routes were {routes}")
        if not all(e.get("eligible") for e in eligible.values()):
            raise AssertionError(f"eligibility.classify: {eligible}")
        _same_csvs(ooc, resident)

        # (d) eight partitions in process
        dist = os.path.join(root, "dist")
        argv = ["--data-path", data, "--iterations", "1", "--concurrency", str(DIST_P)]
        for q in CLI_DIST_QUERIES:
            argv += ["--query", str(q)]
        t0 = time.perf_counter()
        res_dist = _cli(device, argv, dist)
        dist_s = time.perf_counter() - t0
        _same_csvs(dist, resident)
        comm = {q: res_dist["query_metrics"][q]["comm_bytes"] for q in CLI_DIST_QUERIES}

        # (e) .tbl files through the native parser
        tbl = os.path.join(root, "tbl")
        t0 = time.perf_counter()
        generate(["--scale-factor", str(CLI_TBL_SF), "--output", tbl, "--format", "tbl"])
        tbl_gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res_tbl = _cli(device, ["--data-path", tbl, "--query", "6", "--iterations", "2",
                                "--check"], os.path.join(root, "tbl_out"))
        tbl_s = time.perf_counter() - t0
        if native.tbl_library() is None:
            raise AssertionError("the .tbl files were not parsed by the native parser")
        if res_tbl["checked"].get(6) is not True:
            raise AssertionError("Q6 over the .tbl files failed --check")

        # (f) one warm Q3 profiled
        handle = ctx.sql(QUERIES[3])
        handle.collect()
        trace_dir = os.path.join(root, "trace")
        with tracing.profile(trace_dir, device=device.type):
            handle.collect()
        trace_path = os.path.join(trace_dir, tracing.TRACE_FILE)
        trace_bytes = os.path.getsize(trace_path)
        with open(trace_path) as f:
            trace = json.load(f)
        device_ms = sum(e["dur"] for e in tracing.device_events(trace)) / 1e3
        ops = sorted({e["name"] for e in trace["traceEvents"]
                      if e.get("cat") == "user_annotation"})
        del handle, ctx, tables
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    summary = res["query_summary"]
    log("phase 23 queries (warm median ms / oracle ms / route): " + ", ".join(
        f"Q{q} {summary[q]['median_warm_ms']:.3f} / {summary[q]['oracle_ms']:.1f} / "
        f"{res['query_metrics'][q]['route']}" for q in sorted(summary)))
    log(f"phase 23 ok: TPC-H CLI over the native generator's SF{TPCH_SF} ({gen_bytes} bytes "
        f"written in {gen_s:.1f} s by {lib}): the 22 queries resident with --check, all PASS, "
        f"in {resident_s:.1f} s (oracle {oracle_s:.1f} s of it), launches {launches}; spans "
        f"{[(n, c, round(t, 3)) for n, c, t, _ in spans]}; out of core Q1, Q3, Q10 routes "
        f"{routes}, chunks {dict((q, res_ooc['query_metrics'][q]['streamed_chunks']) for q in CLI_OOC_QUERIES)}, "
        f"== resident, eligible, in {ooc_s:.1f} s; --concurrency {DIST_P} Q5, Q9 == resident, "
        f"comm bytes {comm}, in {dist_s:.1f} s; .tbl at SF {CLI_TBL_SF} generated in "
        f"{tbl_gen_s:.1f} s, Q6 --check PASS through the native parser in {tbl_s:.1f} s; "
        f"warm Q3 profiled: trace {trace_bytes} bytes, device time {device_ms:.3f} ms, "
        f"operator ranges {ops}")


# phase 24: (label, bench module, argv, kernels it must launch); each at its
# defaults (sizes, iterations, rounds)
BENCH_RUNS = (
    *((f"build_speed/{s}", "build_speed", ["--strategy", s], k)
      for s, k in (("csr", ("hash_slot", "csr_build")),
                   ("sort", ("hash_slot", "radix_sort", "filter_compact")),
                   ("oa", ("hash_slot", "radix_sort", "oa_place", "filter_compact")))),
    *((f"lookup_speed/{s}", "lookup_speed", ["--strategy", s], k)
      for s, k in (("csr", ("hash_slot", "probe_expand")),
                   ("sort", ("hash_slot", "sorted_probe", "probe_expand")),
                   ("oa", ("hash_slot", "oa_probe", "probe_expand")))),
    ("exp_dist/single", "exponential_distribution", [],
     ("hash_slot", "csr_build", "probe_expand", "compact_gather")),
    ("exp_dist/partitions8", "exponential_distribution",
     ["--partitions", str(DIST_P)],
     ("hash_slot", "csr_build", "probe_expand", "compact_gather", "dest_pack", "key_histogram")),
    ("sort", "sort_bench", [], ("radix_sort", "filter_compact", "pack_rows")),
    ("my_benchmark/Size256", "my_benchmark", [],
     ("hash_slot", "csr_build", "probe_expand", "compact_gather")),
    ("roofline", "roofline", [],
     ("hash_slot", "csr_build", "probe_expand", "compact_gather", "filter_compact",
      "radix_sort", "segment_agg", "pack_rows")),
    ("dist_stream_sweep", "dist_stream_sweep", [], DIST_STREAM_KERNELS),
)


def phase_benches(device) -> None:
    """Phase 24: every bench of BENCH_RUNS through its main(argv) on the
    card; each checks its own answer (and raises on a mismatch). Its lines
    are printed after it ran; the launch counts are zeroed before each
    bench and read after it."""
    import importlib
    import io

    import torch
    seconds = {}
    for label, module, argv, need in BENCH_RUNS:
        mod = importlib.import_module(f"datafusion_parallelism_tpu_torch.benches.{module}")
        for fn in set(all_counters().values()):
            fn.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                mod.main(argv + ["--device", str(device)])
        except BaseException:
            print(buf.getvalue(), flush=True)
            raise
        seconds[label] = round(time.perf_counter() - t0, 1)
        launches = {k: n for k, n in kernel_launches().items() if n}
        missing = [k for k in need if k not in launches]
        if missing:
            raise AssertionError(f"phase 24 {label}: kernels never launched: {missing}")
        for line in buf.getvalue().splitlines():
            log(f"phase 24 {label}: {line}")
        log(f"phase 24 {label}: launches {launches}")
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase 24 ok: the port's benches at their full sizes, every answer checked, seconds "
        f"{seconds}")


SF100_RUN_SF = 1                      # phase 25: SF100's routes at SF1 (thresholds x SF / 100)
SF100_RUN_QUERIES = (1, 2, 9, 13, 18)  # stream, grace union, stream + swap, over orders, grace agg
SF100_KILLED = 18                     # the first run's query, killed at once (its error entry)
SF100_FIRST_RUN_WAIT_S = 300          # the most phase 25 waits for its first run


def _sf100_argv(root: str, device) -> list:
    """tools/sf100_run.py's arguments common to phase 25's two runs."""
    return ["--scale-factor", str(SF100_RUN_SF), "--threshold-scale", str(SF100_RUN_SF / 100),
            "--data", os.path.join(root, "bin"), "--device", device.type]


def start_sf100_first_run(device):
    """Phase 25's first run, started before phase 24 and run beside it:
    tools/sf100_run.py in a process of its own, which generates the SF1
    tables, plans the 22 routes and kills SF100_KILLED by a 0 s timeout
    before that query's process reaches the card, so it does host work
    only. -> {"proc", "root", "out", "log", "t0"}; stop_sf100_first_run
    ends it and removes its directory."""
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="dfp_sf100_")
    first = {"root": root, "out": os.path.join(root, "run1"),
             "log": os.path.join(root, "run1.log"), "t0": time.perf_counter()}
    with open(first["log"], "w") as out:
        first["proc"] = subprocess.Popen(
            [sys.executable, os.path.join(here, "tools", "sf100_run.py"),
             *_sf100_argv(root, device), "--out", first["out"], "--timeout", "0",
             "--query", str(SF100_KILLED)],
            cwd=here, stdout=out, stderr=subprocess.STDOUT, start_new_session=True)
    return first


def stop_sf100_first_run(first) -> None:
    """Kill the first run's process group if it still runs; remove its files."""
    import shutil
    import signal

    proc = first["proc"]
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    shutil.rmtree(first["root"], ignore_errors=True)


def phase_sf100_run(device, first) -> None:
    """Phase 25: the campaign driver (tools/sf100_run.py) at SF1 under the
    thresholds x 1/100: the first run (start_sf100_first_run, beside phase
    24) awaited, then SF100_RUN_QUERIES one a process with --check over its
    tables and routes; merge_sf100 over the two runs and sf100_report into a
    stand-in PERF.md that holds the markers."""
    import io

    from datafusion_parallelism_tpu_torch.benches import merge_sf100, sf100_report
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "tools"))
    import sf100_run

    with open(os.path.join(here, "results", "sf100", "eligibility.json")) as f:
        reference = json.load(f)["queries"]
    root = first["root"]
    t0 = time.perf_counter()
    try:
        rc = first["proc"].wait(timeout=SF100_FIRST_RUN_WAIT_S)
    except subprocess.TimeoutExpired:
        rc = None
    waited = round(time.perf_counter() - t0, 1)
    if rc != 0:
        with open(first["log"]) as f:
            tail = f.read()[-4000:]
        raise AssertionError(f"phase 25: the first run exited {rc} (None: still running after "
                             f"{SF100_FIRST_RUN_WAIT_S} s):\n{tail}")
    runs = [first["out"], os.path.join(root, "run2")]
    buf = io.StringIO()
    t1 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            sf100_run.main(_sf100_argv(root, device) + ["--out", runs[1], "--timeout", "120"]
                           + [a for q in SF100_RUN_QUERIES for a in ("--query", str(q))])
    except BaseException:
        print(buf.getvalue(), flush=True)
        raise
    second_s = round(time.perf_counter() - t1, 1)
    merged = os.path.join(root, "merged")
    with contextlib.redirect_stdout(io.StringIO()):
        merge_sf100.main(["--run", runs[0], "--run", runs[1], "--label", "1",
                          "--label", "2", "--out", merged])
    # a stand-in: the checkout this script runs from need not hold PERF.md
    perf = os.path.join(root, "PERF.md")
    before, after = "# SF100\n\nabove the table\n\n", "\n\nbelow the table\n"
    with open(perf, "w") as f:
        f.write(before + sf100_report.BEGIN + "\n" + sf100_report.END + after)
    with contextlib.redirect_stdout(io.StringIO()):
        rendered = sf100_report.main(["--results", merged, "--perf", perf])
    with open(perf) as f:
        md = f.read()
    table = [ln for ln in md.split(sf100_report.BEGIN, 1)[1].split(sf100_report.END, 1)[0]
             .splitlines() if ln.startswith("| Q")]
    results = []
    for path in (runs[0], runs[1], merged):
        with open(os.path.join(path, "results.json")) as f:
            results.append(json.load(f))
    first_res, second, res = results
    with open(os.path.join(merged, "eligibility.json")) as f:
        elig = json.load(f)["queries"]
    records = []
    for path in runs:
        with open(os.path.join(path, "device.json")) as f:
            records.append(json.load(f))
    killed = str(SF100_KILLED)
    if first_res["query_metrics"][killed] != {"error": "timeout: killed after 0 s"}:
        raise AssertionError(f"phase 25: the 0 s timeout left {first_res['query_metrics'][killed]}")
    want = [str(q) for q in SF100_RUN_QUERIES]
    failed = {q: res["query_metrics"].get(q) for q in want if res["checked"].get(q) is not True}
    if failed:
        raise AssertionError(f"phase 25: queries failed or unchecked: {failed}")
    differ = sf100_run.route_differences(elig, reference)
    routes = {q: res["query_metrics"][q]["route"] for q in want}
    wrong = {q: r for q, r in routes.items() if r != sf100_run.executor_route(reference[q])}
    if differ or wrong:
        raise AssertionError(f"phase 25: routes differ from results/sf100: eligibility "
                             f"{differ}, the queries' {wrong}")
    if res["measured_in_round"][killed] != "2" or \
            res["query_metrics"][killed] != second["query_metrics"][killed]:
        raise AssertionError(f"phase 25: the merged Q{killed} is not the second run's")
    if rendered != 0 or len(table) != len(want) or not md.startswith(before) \
            or not md.endswith(after):
        raise AssertionError(f"phase 25: sf100_report wrote {md!r} (exit {rendered})")
    if not (records[1]["data_reused"] and records[1]["eligibility_reused"]):
        raise AssertionError("phase 25: the second run did not take the first run's tables "
                             "and routes")
    peaks = {q: res["query_metrics"][q]["peak_device_bytes"] for q in want}
    record = records[1]
    log(f"phase 25 ok: tools/sf100_run.py at SF{SF100_RUN_SF:g} under the out-of-core "
        f"thresholds x {SF100_RUN_SF:g}/100: a first run beside phase 24 (host work only: "
        f"generation {records[0]['generation']['seconds']} s, eligibility "
        f"{records[0]['eligibility_s']} s, Q{killed} killed by a 0 s timeout, its error entry; "
        f"{records[0]['seconds']} s in its process, awaited {waited} s), then "
        f"{len(want)} queries one a process over its tables and routes (taken in "
        f"{record['eligibility_s']} s), each --check PASS, in {second_s} s (each query's "
        f"process {dict((k, v['seconds']) for k, v in record['queries'].items())}"
        f" s, peak rss {dict((k, v['peak_rss_bytes']) for k, v in record['queries'].items())}"
        f" bytes, maxrss {dict((k, v['maxrss_bytes']) for k, v in record['queries'].items())}"
        f" bytes); the two runs merged (Q{killed} the second's) and rendered; routes {routes}, "
        f"== results/sf100/eligibility.json for all 22; peak device bytes {peaks}")


def launch_counters():
    from datafusion_parallelism_tpu_torch.kernels import (compact_gather, csr_build,
                                                          hash_slot, probe_expand)
    return {"hash_slot": hash_slot.hash_slot, "csr_build": csr_build.csr_build,
            "probe_ranges": probe_expand.probe_ranges,
            "expand_ranges": probe_expand.expand_ranges,
            "compact_gather": compact_gather.compact_gather}


def pack_counters():
    """K12's entry points, which the deferred INNER join no longer reaches."""
    from datafusion_parallelism_tpu_torch.kernels import pack_rows
    return {"pack_rows": pack_rows.pack_rows, "unpack_rows": pack_rows.unpack_rows}


def agg_counters():
    """The chain's launch counters: K5-K8's, K1's and K12's entry points
    (K13 serves the out-of-core path only)."""
    from datafusion_parallelism_tpu_torch.kernels.chain import KERNELS
    return {e: fn for e, fn in KERNELS._asdict().items() if e != "append_rows"}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    # every query settles its capacities from the planner's seeds in this
    # run (phase 15 reruns queries and must see the same calls)
    os.environ["DFP_NO_CAP_STORE"] = "1"
    smi = phase_build()
    phase_kernels_vs_plain(device)
    phase_size512_kernels(device)
    phase_strategy_kernels_vs_plain(device)
    phase_radix_edges(device)
    phase_row_copy_edges(device)
    phase_csr_edges(device)
    phase_agg_compact_edges(device)
    phase_segment_agg_edges(device)
    phase_flags_hist_edges(device)

    wrappers = launch_counters()
    for w in wrappers.values():
        w.launches = 0
    k12 = pack_counters()
    k12_before = {name: w.launches for name, w in k12.items()}
    phase_entry(device)
    phase_size512(device)
    _, sf10 = phase_sf10(device)
    launches = {name: w.launches for name, w in wrappers.items()}
    missing = [name for name, n in launches.items() if n < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    packed = {name: w.launches - k12_before[name] for name, w in k12.items()}
    if any(packed.values()):
        raise AssertionError(f"the deferred INNER join launched K12: {packed}")
    log(f"phase 6 ok: launches during phases 3-5: {launches}; K12 {packed}")
    phase_sf10_kernels(*sf10)
    del sf10

    phase_agg_kernels_vs_plain(device)
    phase_roofline(device)
    agg_launches, _, chain_timing, tables = phase_tpch_chains(device, agg_counters())
    missing = [name for name, n in agg_launches.items() if n < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the chains: {missing}")
    log(f"phase 11 ok: launches during phase 10's first runs: {agg_launches}")
    log("phase 12 ok: K5-K8 == plain at the shapes of the SF10 chains; ms kernel/plain "
        "summed over their calls: " + _fmt_timing(chain_timing))

    phase_join_types(device)
    phase_queue3(device)
    # the distributed join holds up to ~52 GB at SF10: it runs while the card
    # holds nothing else, and gives the cache back after
    gc.collect()
    torch.cuda.empty_cache()
    _, dist_launches, dist_kernels = phase_distributed(device)
    phase_nccl(device)
    gc.collect()
    torch.cuda.empty_cache()
    sql_res, sql_launches, ctx, sizes, oracle, resident, strategy_run = phase_tpch_sql(
        device, tables, lambda res, stats: run_strategies(device, tables, res, stats))
    statistics = table_statistics(ctx)
    _, ooc_launches, ooc_ctx, ooc_sizes = phase_out_of_core(device, tables, oracle, sql_res,
                                                            statistics)
    _, strategy_launches = phase_strategies(strategy_run, oracle)
    replay = phase_replay(device, {14: ctx, 16: ooc_ctx, **strategy_run["ctxs"]},
                          {**sizes, **ooc_sizes, **strategy_run["sizes"]})
    del ctx, ooc_ctx, strategy_run
    replay.update(dist_kernels)
    # distributed SQL holds up to a shuffle's received shards of lineitem:
    # it runs while the card holds nothing else
    gc.collect()
    torch.cuda.empty_cache()
    _, _, dist_rows = phase_distributed_sql(device, tables, oracle, resident, statistics)
    phase_nccl_sql(device, tables, statistics, dist_rows)
    phase_distributed_streaming(device, tables, oracle, resident, statistics)
    del tables, oracle, resident, statistics, dist_rows
    gc.collect()
    torch.cuda.empty_cache()
    phase_cli(device, sql_launches)
    # phase 25's first run (host work only) goes on beside phase 24
    first = start_sf100_first_run(device)
    try:
        phase_benches(device)
        phase_sf100_run(device, first)
    finally:
        stop_sf100_first_run(first)

    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        r = replay[name]
        launches = (ooc_launches if name in OOC_KERNELS + ("pack_rows",) else
                    strategy_launches if name in STRATEGY_KERNELS else
                    dist_launches if name in DIST_KERNELS else sql_launches)
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": r["err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
                        "library_ms": r["library_ms"],
                        **({"bound_all_rows_ms": r["bound_all_rows_ms"]}
                           if name in ("filter_compact", "segment_agg") else {}),
                        "library_sync_ms": r.get("library_sync_ms"),
                        "library_partial_ms": r.get("library_partial_ms"),
                        "library_by_call": r.get("library_by_call", {}), "calls": r["calls"]})
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
