"""The kernel entry points the single-table operators launch, as one table.

`filter_table`, `project_table`, `sort_table`, `hash_aggregate_counted`,
the compaction family and `pack_table` / `unpack_table` of
`utils/columnar.py`, the expression entry points of `ops/expressions.py`
and the out-of-core executor take a `kernels` argument of this type and
reach K1, K5-K8, K12, K13 and K17 only through it, as the join reaches K1-K4 and K9-K11
through `ops/join.py`'s JoinKernels. KERNELS (the default) is the wrappers, which
launch the kernels on CUDA tensors and run the plain versions on CPU
tensors; PLAIN is the plain versions on any device, the reference the
kernel path is held to.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from . import append_rows as k13
from . import direct_agg as k8
from . import expr_eval as k17
from . import filter_compact as k5
from . import hash_slot as k1
from . import pack_rows as k12
from . import radix_sort as k6
from . import segment_agg as k7


class ChainKernels(NamedTuple):
    filter_compact: Callable   # K5 compaction
    gather_rows: Callable      # K5 row gather
    radix_sort: Callable       # K6
    segment_agg: Callable      # K7
    direct_agg: Callable       # K8
    hash_slot: Callable        # K1, the multi-column group key's hash
    pack_rows: Callable        # K12 pack
    unpack_rows: Callable      # K12 unpack
    append_rows: Callable      # K13
    expr_eval: Callable        # K17


# the kernel each entry point belongs to
KERNEL_OF = {"filter_compact": "filter_compact", "gather_rows": "filter_compact",
             "radix_sort": "radix_sort", "segment_agg": "segment_agg",
             "direct_agg": "direct_agg", "hash_slot": "hash_slot",
             "pack_rows": "pack_rows", "unpack_rows": "pack_rows",
             "append_rows": "append_rows", "expr_eval": "expr_eval"}

KERNELS = ChainKernels(k5.filter_compact, k5.gather_rows, k6.radix_sort, k7.segment_agg,
                       k8.direct_agg, k1.hash_slot, k12.pack_rows, k12.unpack_rows,
                       k13.append_rows, k17.expr_eval)
PLAIN = ChainKernels(k5.filter_compact_plain, k5.gather_rows_plain, k6.radix_sort_plain,
                     k7.segment_agg_plain, k8.direct_agg_plain, k1.hash_slot_plain,
                     k12.pack_rows_plain, k12.unpack_rows_plain, k13.append_rows_plain,
                     k17.expr_eval_plain)
