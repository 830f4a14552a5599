"""Carry state across from the JAX package without importing it.

`host_table_from_reference` duck-types a JAX-package `HostTable` (numpy
columns plus a schema of fields with `name`, `dtype.kind.value`,
`dtype.scale`, `nullable` and `dictionary.values`) into the port's types;
`join_table_from_reference` turns a JAX-built CSR table's arrays into the
port's `JoinTable`, so that one package can probe the other's table.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.hash_table import JoinTable
from .columnar import DType, Dictionary, Field, HostTable, Kind, Schema


def host_table_from_reference(ref) -> HostTable:
    fields, columns = [], {}
    for f in ref.schema.fields:
        dictionary = None
        if f.dictionary is not None:
            dictionary = Dictionary(np.asarray(f.dictionary.values, dtype=object))
        dt = DType(Kind(f.dtype.kind.value), int(f.dtype.scale))
        fields.append(Field(f.name, dt, bool(f.nullable), dictionary))
        values, validity = ref.columns[f.name]
        columns[f.name] = (np.array(values), np.array(validity, dtype=np.bool_))
    return HostTable(Schema(fields), columns, ref.num_rows)


def join_table_from_reference(offsets, perm, start_count, *, device) -> JoinTable:
    """A CSR JoinTable from numpy (or array-like) offsets[T+2], perm[cap] and
    start_count[2, T+1]."""
    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.int32, device=device)

    return JoinTable(t(offsets), t(perm), t(start_count))
