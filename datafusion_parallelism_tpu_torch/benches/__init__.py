"""The port's microbenchmarks: the counterparts of the root `benches/`
(the JAX package's), each run as

    python -m datafusion_parallelism_tpu_torch.benches.<name> [--device cuda|cpu] ...

on the card by default (each raises without one unless given `--device
cpu`, where the kernels' plain versions run). Each prints one JSON line a
measurement with the JAX bench's keys plus `device` and `power_limit_w`,
checks its own answer and exits non-zero on a mismatch. Importing a
module runs nothing: everything runs under its `main(argv)`, which returns
the records it printed.

  bench_lib                 timing by CUDA events, report lines, sandwich A/B
  build_speed               Size512 build: K1 + K2 (CSR), K1 + K6 (SORT), K1 + K6 + K15 (OA)
  lookup_speed              Size512 probe: K3 / K14 / K16 ranges, K3's expansion and perm gather
  exponential_distribution  skewed join, one device and P partitions in process
  sort_bench                how a sort carries its payload columns
  my_benchmark              Size256: the reference's four-way nested join through SQL
  roofline                  six operators against a byte bound and a primitive model
  roofline_report           the roofline JSON as a table in PERF.md
  dist_stream_sweep         streamed x distributed TPC-H, checked against the oracle
"""
