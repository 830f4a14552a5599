"""Filter operator (torch): predicate -> compaction; a NULL predicate
rejects the row (SQL WHERE).

Counterpart of `datafusion_parallelism_tpu/ops/filter.py`. With `out_cap`
the survivors compact into a smaller capacity (the engine's adaptive
capacity: the executor seeds it from statistics and grows it on overflow),
and the true survivor count comes back for that overflow check. The
predicate's mask is K17 (kernels/expr_eval.py) and the compaction K5
(kernels/filter_compact.py), both reached through `kernels`
(kernels/chain.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels.chain import KERNELS, ChainKernels
from ..utils.columnar import DeviceTable, compact_rows, filter_rows, pack_table, unpack_table
from .expressions import Expr, predicate_mask


def filter_table(t: DeviceTable, predicate: Expr, out_cap: Optional[int] = None,
                 kernels: ChainKernels = KERNELS) -> Tuple[DeviceTable, torch.Tensor]:
    mask = predicate_mask(predicate, t, kernels, in_rows=True)
    if out_cap is None or out_cap >= t.capacity:
        out = filter_rows(t, mask, kernels)
        return out, out.num_rows
    (pt,), n = compact_rows([pack_table(t, kernels)], mask, out_cap, kernels)
    return unpack_table(pt, t.schema, torch.clamp(n, max=out_cap), kernels), n
