"""ORDER BY and LIMIT (torch).

Counterpart of `datafusion_parallelism_tpu/ops/sort.py`. The sort builds
the JAX package's transformed operands (a padding key first, so padding
rows sort last; every key cast to int64 or float64; DESC negates; NULLs at
+-big, postgres placement: last under ASC, first under DESC by default),
sorts them stably with K6 (kernels/radix_sort.py) as int32 words, and
gathers the rows with K5 (kernels/filter_compact.py), both reached through
`kernels` (kernels/chain.py). String columns sort
by dictionary code, which is lexicographic because ingest keeps
dictionaries sorted.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from ..kernels.chain import KERNELS, ChainKernels
from ..utils.columnar import DeviceTable, Kind, int64_words, pack_table, unpack_table

_BIG_INT = 1 << 62
_FLIP = 0x7FFFFFFFFFFFFFFF


@dataclass(frozen=True)
class SortKey:
    column: str
    ascending: bool = True
    nulls_first: bool = False  # postgres default: nulls last for ASC


def flush_subnormals(x: torch.Tensor) -> torch.Tensor:
    """x with its subnormal values as 0.0: XLA on the CPU (and the TPU)
    reads them as zero, so the JAX package sorts them as zeros."""
    return torch.where(x.abs() < torch.finfo(x.dtype).tiny, 0.0, x)


def float_sort_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 whose signed order is the order `jax.lax.sort` gives float64
    `x`: subnormals and -0.0 count as 0.0, and every NaN as +NaN, which
    sorts after +inf."""
    x = torch.where(flush_subnormals(x) == 0, 0.0, x)
    x = torch.where(torch.isnan(x), float("nan"), x)
    b = x.view(torch.int64)
    return torch.where(b < 0, b ^ _FLIP, b)


def sort_operands(t: DeviceTable, keys: List[SortKey]):
    """(words [k, cap] int32, signed flags): the padding key, then each
    transformed key as its signed high and unsigned low word."""
    words = [(~t.row_mask()).to(torch.int32)]
    signed = [True]
    for k in keys:
        v, valid = t.column(k.column)
        if t.schema.field(k.column).dtype.kind in (Kind.FLOAT32, Kind.FLOAT64):
            kv = flush_subnormals(v).to(torch.float64)
            big = float("inf")
        else:
            kv = v.to(torch.int64)
            big = _BIG_INT
        if not k.ascending:
            kv = -kv
        # the sort is ascending on the transformed key, so null placement
        # depends only on nulls_first
        kv = torch.where(valid, kv, -big if k.nulls_first else big)
        if kv.is_floating_point():
            kv = float_sort_bits(kv)
        lo, hi = int64_words(kv)
        words += [hi, lo]
        signed += [True, False]
    return torch.stack(words), signed


def sort_table(t: DeviceTable, keys: List[SortKey],
               kernels: ChainKernels = KERNELS) -> DeviceTable:
    perm = kernels.radix_sort(*sort_operands(t, keys))
    # rows past num_rows (the padding, sorted last) come back as zeros
    return unpack_table(pack_table(t, kernels).take_rows(perm, t.num_rows, kernels), t.schema,
                        t.num_rows, kernels)


def limit_table(t: DeviceTable, n: int) -> DeviceTable:
    return DeviceTable(t.schema, t.columns, torch.clamp(t.num_rows, max=n))


def host_sort_table(t, keys: List[SortKey]):
    """Stable host-side sort of a HostTable by the same key semantics as
    sort_table (DESC negates, NULLs per nulls_first, strings by sorted
    dictionary code). A copy of the JAX package's numpy function."""
    import numpy as np
    n = t.num_rows
    operands = []
    for k in keys:
        v, valid = t.columns[k.column]
        v = np.asarray(v)
        valid = np.asarray(valid)
        if v.dtype.kind == "f":
            kv = v.astype(np.float64)
            big = np.inf
        else:
            kv = v.astype(np.int64)
            big = np.int64(1) << 62
        if not k.ascending:
            kv = -kv
        kv = np.where(valid, kv, -big if k.nulls_first else big)
        operands.append(kv)
    # np.lexsort keys: last key is primary -> reverse; stability preserves
    # the shard-local pre-sort order for equal keys
    perm = np.lexsort(tuple(reversed(operands))) if operands else np.arange(n)
    cols = {name: (v[perm], valid[perm])
            for name, (v, valid) in t.columns.items()}
    return type(t)(t.schema, cols, n)
