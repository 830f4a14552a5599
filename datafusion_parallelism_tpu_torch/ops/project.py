"""Projection (torch): evaluate expressions into a new table.

Counterpart of `datafusion_parallelism_tpu/ops/project.py`. Every computed
output comes from one K17 launch (`ops/expressions.py::evaluate`, reached
through `kernels`); a bare column passes through as its tensors."""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..kernels.chain import KERNELS, ChainKernels
from ..utils.columnar import DeviceTable, Field, Kind, Schema
from .expressions import Col, Expr, evaluate


def project_table(t: DeviceTable, exprs: List[Tuple[Expr, str]],
                  out_fields: Optional[List[Field]] = None,
                  kernels: ChainKernels = KERNELS) -> DeviceTable:
    """out_fields: plan-time fields (the dtype and dictionary authority: a
    computed string expression's dictionary is not visible at run time)."""
    fields, cols = [], {}
    results = evaluate([e for e, _ in exprs], t, kernels)
    for i, ((e, name), (v, valid, dt)) in enumerate(zip(exprs, results)):
        if out_fields is not None:
            fields.append(out_fields[i])
        else:
            dictionary = None
            if isinstance(e, Col) and dt.kind is Kind.STRING:
                dictionary = t.schema.field(e.name).dictionary
            fields.append(Field(name, dt, nullable=True, dictionary=dictionary))
        cols[name] = (v, valid)
    return DeviceTable(Schema(fields), cols, t.num_rows)
