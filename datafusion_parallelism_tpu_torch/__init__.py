"""datafusion_parallelism_tpu_torch — the PyTorch/CUDA port of
`datafusion_parallelism_tpu`.

Ported so far: the SQL path on one device — `SessionContext.sql(text)`
(the copied parser, planner and optimizer), the eager single-device
executor (`runtime/executor.py`), the hash join of all eight join types
under the CSR, SORT and OA strategies (`ops.join.hash_join`) and the
single-table operators `filter_table`, `project_table`,
`hash_aggregate_counted`, `sort_table` and `limit_table` with the
expression classes, and out-of-core execution (morsel streaming and grace
partitioning, `runtime/streaming.py`, `runtime/grace.py`), and SQL over
P partitions (`SessionConfig(target_partitions=P)`,
`runtime/distributed_executor.py` over `parallel/`'s Exchange) — through
nineteen hand-written CUDA kernels for Hopper (`kernels/`, sources in
`csrc/`: K1-K4 and K9-K11 the join, K5-K8 the single-table operators, K12
packing and unpacking tables, K13 the grace union append, K14-K16 the
SORT and OA strategies' probes and placement, K17 every expression, K18
and K19 the shuffle's routing and the skew histogram) with a plain torch
version beside each.
The package imports torch and never jax; the kernels are built with nvcc
at first CUDA use, never at import. Around it: the TPC-H harness
(`tpch/cli.py`, `generate.py`, `diff_results.py`, `eligibility.py`) and the
host I/O (`utils/binfmt.py` over the native generator in `native/`,
`tpch/tbl_loader.py`, `utils/parquet_io.py`, `utils/tracing.py`).
"""

from .api import SessionConfig, SessionContext
from .ops.aggregate import AggSpec, hash_aggregate, hash_aggregate_counted
from .ops.expressions import (BinOp, Case, Cast, Coalesce, Col, Expr,
                              ExtractDatePart, InCodes, IsNull, Lit, Not)
from .ops.filter import filter_table
from .ops.hash_table import JoinStrategy, JoinTable
from .ops.join import JoinType, hash_join
from .ops.project import project_table
from .ops.sort import SortKey, limit_table, sort_table
from .utils.columnar import (BOOL, DATE32, DECIMAL, FLOAT32, FLOAT64, INT32,
                             INT64, STRING, DeviceTable, DType, Field,
                             HostTable, Kind, Schema, round_capacity)

__all__ = ["AggSpec", "BOOL", "BinOp", "Case", "Cast", "Coalesce", "Col",
           "DATE32", "DECIMAL", "DType", "DeviceTable", "Expr", "ExtractDatePart",
           "FLOAT32", "FLOAT64", "Field", "HostTable", "INT32", "INT64", "InCodes",
           "IsNull", "JoinStrategy", "JoinTable", "JoinType", "Kind", "Lit", "Not",
           "STRING", "Schema", "SessionConfig", "SessionContext", "SortKey", "filter_table", "hash_aggregate",
           "hash_aggregate_counted", "hash_join", "limit_table", "project_table",
           "round_capacity", "sort_table"]

__version__ = "0.1.0"
