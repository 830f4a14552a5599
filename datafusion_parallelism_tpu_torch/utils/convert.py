"""Carry state across from the JAX package without importing it.

`host_table_from_reference` duck-types a JAX-package `HostTable` (numpy
columns plus a schema of fields with `name`, `dtype.kind.value`,
`dtype.scale`, `nullable` and `dictionary.values`) into the port's types;
`join_table_from_reference` turns a JAX-built CSR table's arrays into the
port's `JoinTable`, so that one package can probe the other's table;
`expr_from_reference` rebuilds a JAX-package expression tree (a planner's
predicate, projection or sort key) in the port's classes;
`shards_from_reference` turns the JAX package's `partition_table` output
into the port's shards.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.hash_table import JoinTable
from .columnar import DeviceTable, DType, Dictionary, Field, HostTable, Kind, Schema


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

    return JoinTable(t(offsets), t(perm), torch.empty(0, dtype=torch.int64, device=device),
                     t(start_count))


def _ref_dtype(dt) -> DType:
    return DType(Kind(dt.kind.value), int(dt.scale))


def _ref_value(x):
    """One dataclass field of a JAX-package object, in the port's types."""
    cls = type(x).__name__
    if cls == "DType":
        return _ref_dtype(x)
    if cls == "Field":
        dictionary = None
        if x.dictionary is not None:
            dictionary = Dictionary(np.asarray(x.dictionary.values, dtype=object))
        return Field(x.name, _ref_dtype(x.dtype), bool(x.nullable), dictionary)
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, (list, tuple)):
        return type(x)(_ref_value(y) for y in x)
    if dataclasses.is_dataclass(x):
        return expr_from_reference(x)
    return x


def expr_from_reference(e):
    """A JAX-package Expr (or SortKey, AggSpec, Field, DType) as the same tree of
    the port's classes: the class found by name in the port's module, each
    dataclass field converted recursively (DType and Field mapped,
    InCodes' codes copied). Imports no jax: it reads names and fields."""
    from ..ops import aggregate, expressions, sort
    name = type(e).__name__
    if name in ("DType", "Field"):
        return _ref_value(e)
    cls = next((getattr(m, name) for m in (expressions, sort, aggregate)
                if hasattr(m, name)), None)
    if cls is None or not dataclasses.is_dataclass(cls):
        raise TypeError(f"no port class for {name}")
    return cls(**{f.name: _ref_value(getattr(e, f.name)) for f in dataclasses.fields(e)})


def shards_from_reference(cols, num_rows, schema, *, device, ranks=None):
    """The JAX package's `partition_table` output (columns name -> ([P, cap]
    values, [P, cap] validity), num_rows [P], its schema; jnp or numpy
    arrays) as the port's shards: one DeviceTable on `device` per
    partition in `ranks` (all P by default), in order."""
    port_schema = Schema([_ref_value(f) for f in schema.fields])
    nr = np.asarray(num_rows)
    shards = []
    for p in (range(len(nr)) if ranks is None else ranks):
        local = {}
        for f in port_schema.fields:
            v, valid = cols[f.name]
            local[f.name] = (torch.from_numpy(np.array(np.asarray(v)[p])).to(device),
                             torch.from_numpy(np.array(np.asarray(valid)[p],
                                                       dtype=np.bool_)).to(device))
        shards.append(DeviceTable(port_schema, local,
                                  torch.tensor(int(nr[p]), dtype=torch.int32, device=device)))
    return shards
