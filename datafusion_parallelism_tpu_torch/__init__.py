"""datafusion_parallelism_tpu_torch — the PyTorch/CUDA port of
`datafusion_parallelism_tpu`.

Ported so far: the single-device INNER hash join on the CSR strategy
(`ops.join.hash_join`), through four hand-written CUDA kernels for Hopper
(`kernels/`, sources in `csrc/`) with a plain torch version beside each.
The package imports torch and never jax; the kernels are built with nvcc
at first CUDA use, never at import.
"""

from .ops.hash_table import JoinStrategy, JoinTable
from .ops.join import JoinType, hash_join
from .utils.columnar import (BOOL, DATE32, DECIMAL, FLOAT32, FLOAT64, INT32,
                             INT64, STRING, DeviceTable, DType, Field,
                             HostTable, Kind, Schema, round_capacity)

__all__ = ["BOOL", "DATE32", "DECIMAL", "DType", "DeviceTable", "FLOAT32",
           "FLOAT64", "Field", "HostTable", "INT32", "INT64", "JoinStrategy",
           "JoinTable", "JoinType", "Kind", "STRING", "Schema", "hash_join",
           "round_capacity"]
