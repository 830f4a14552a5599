"""Projection (torch): evaluate expressions into a new table.

Counterpart of `datafusion_parallelism_tpu/ops/project.py`."""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..utils.columnar import DeviceTable, Field, Kind, Schema
from .expressions import Col, Expr


def project_table(t: DeviceTable, exprs: List[Tuple[Expr, str]],
                  out_fields: Optional[List[Field]] = None) -> DeviceTable:
    """out_fields: plan-time fields (the dtype and dictionary authority: a
    computed string expression's dictionary is not visible at run time)."""
    fields, cols = [], {}
    for i, (e, name) in enumerate(exprs):
        v, valid, dt = e.eval(t)
        if out_fields is not None:
            fields.append(out_fields[i])
        else:
            dictionary = None
            if isinstance(e, Col) and dt.kind is Kind.STRING:
                dictionary = t.schema.field(e.name).dictionary
            fields.append(Field(name, dt, nullable=True, dictionary=dictionary))
        cols[name] = (v, valid)
    return DeviceTable(Schema(fields), cols, t.num_rows)
