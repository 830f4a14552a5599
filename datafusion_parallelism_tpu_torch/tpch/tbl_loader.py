"""Load TPC-H dbgen `.tbl` files through the native C++ parser.

Copied from the JAX package's `tpch/tbl_loader.py`. Covers the reference's
external-data path (it points its harness at tpchgen-generated files,
reference tpc/scripts/generate.sh:9-12): official dbgen output drops
straight into the engine. Falls back to a pure-Python parser when no C++
toolchain exists.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Tuple

import numpy as np

from ..native import tbl_library
from ..utils.columnar import (DATE32, DECIMAL, DType, Dictionary, HostTable,
                              INT32, INT64, Kind, STRING, date32_of)

# (column name, dtype) per table, in dbgen field order
TBL_SCHEMAS: Dict[str, List[Tuple[str, DType]]] = {
    "region": [("r_regionkey", INT32), ("r_name", STRING),
               ("r_comment", STRING)],
    "nation": [("n_nationkey", INT32), ("n_name", STRING),
               ("n_regionkey", INT32), ("n_comment", STRING)],
    "supplier": [("s_suppkey", INT32), ("s_name", STRING),
                 ("s_address", STRING), ("s_nationkey", INT32),
                 ("s_phone", STRING), ("s_acctbal", DECIMAL(2)),
                 ("s_comment", STRING)],
    "customer": [("c_custkey", INT32), ("c_name", STRING),
                 ("c_address", STRING), ("c_nationkey", INT32),
                 ("c_phone", STRING), ("c_acctbal", DECIMAL(2)),
                 ("c_mktsegment", STRING), ("c_comment", STRING)],
    "part": [("p_partkey", INT32), ("p_name", STRING), ("p_mfgr", STRING),
             ("p_brand", STRING), ("p_type", STRING), ("p_size", INT32),
             ("p_container", STRING), ("p_retailprice", DECIMAL(2)),
             ("p_comment", STRING)],
    "partsupp": [("ps_partkey", INT32), ("ps_suppkey", INT32),
                 ("ps_availqty", INT32), ("ps_supplycost", DECIMAL(2)),
                 ("ps_comment", STRING)],
    "orders": [("o_orderkey", INT32), ("o_custkey", INT32),
               ("o_orderstatus", STRING), ("o_totalprice", DECIMAL(2)),
               ("o_orderdate", DATE32), ("o_orderpriority", STRING),
               ("o_clerk", STRING), ("o_shippriority", INT32),
               ("o_comment", STRING)],
    "lineitem": [("l_orderkey", INT32), ("l_partkey", INT32),
                 ("l_suppkey", INT32), ("l_linenumber", INT32),
                 ("l_quantity", DECIMAL(2)), ("l_extendedprice", DECIMAL(2)),
                 ("l_discount", DECIMAL(2)), ("l_tax", DECIMAL(2)),
                 ("l_returnflag", STRING), ("l_linestatus", STRING),
                 ("l_shipdate", DATE32), ("l_commitdate", DATE32),
                 ("l_receiptdate", DATE32), ("l_shipinstruct", STRING),
                 ("l_shipmode", STRING), ("l_comment", STRING)],
}

_TYPE_TAG = {Kind.INT32: 0, Kind.INT64: 1, Kind.FLOAT64: 2, Kind.DATE32: 3,
             Kind.DECIMAL: 4, Kind.STRING: 5}
_NP_FOR_TAG = {0: np.int32, 1: np.int64, 2: np.float64, 3: np.int32,
               4: np.int64, 5: np.int32}


def _sorted_dict(values: np.ndarray, codes: np.ndarray):
    """Sort dictionary values (planner range-compares assume sorted) and
    remap codes."""
    order = np.argsort(values)
    rank = np.empty(len(order), dtype=np.int32)
    rank[order] = np.arange(len(order), dtype=np.int32)
    return Dictionary(values[order]), rank[codes]


def load_tbl(path: str, table: str) -> HostTable:
    """Parse one .tbl file into a HostTable (native parser, Python fallback)."""
    spec = TBL_SCHEMAS[table]
    lib = tbl_library()
    if lib is None:
        return _load_tbl_python(path, table)
    n = lib.tbl_count_rows(path.encode())
    if n < 0:
        raise FileNotFoundError(path)
    tags = np.array([_TYPE_TAG[dt.kind] for _, dt in spec], dtype=np.int32)
    arrays = [np.empty(n, dtype=_NP_FOR_TAG[t]) for t in tags]
    bufs = (ctypes.c_void_p * len(spec))(
        *[a.ctypes.data_as(ctypes.c_void_p) for a in arrays])
    h = lib.tbl_parse(path.encode(), len(spec),
                      tags.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                      bufs, n)
    if not h:
        raise IOError(f"native parse failed for {path}")
    try:
        cols, dicts, dtypes = {}, {}, {}
        for i, (name, dt) in enumerate(spec):
            dtypes[name] = dt
            if dt.kind is Kind.STRING:
                size = lib.tbl_dict_size(h, i)
                nbytes = lib.tbl_dict_bytes(h, i)
                blob = ctypes.create_string_buffer(int(nbytes) + 1)
                offs = np.empty(size + 1, dtype=np.int64)
                lib.tbl_dict_fetch(h, i, blob,
                                   offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
                raw = blob.raw[:int(nbytes)].decode("latin-1")
                values = np.array([raw[offs[j]:offs[j + 1]]
                                   for j in range(size)], dtype=object)
                d, codes = _sorted_dict(values, arrays[i])
                dicts[name] = d
                cols[name] = codes
            else:
                cols[name] = arrays[i]
    finally:
        lib.tbl_free(h)
    return HostTable.from_numpy(cols, dtypes=dtypes, dictionaries=dicts)


def _load_tbl_python(path: str, table: str) -> HostTable:
    spec = TBL_SCHEMAS[table]
    raw: List[List] = [[] for _ in spec]
    with open(path, "r") as f:
        for line in f:
            if not line.strip():
                continue
            parts = line.rstrip("\n").split("|")
            for i, (name, dt) in enumerate(spec):
                v = parts[i]
                if dt.kind is Kind.STRING:
                    raw[i].append(v)
                elif dt.kind is Kind.DATE32:
                    raw[i].append(date32_of(v))
                elif dt.kind is Kind.DECIMAL:
                    raw[i].append(int(round(float(v) * 100)))
                elif dt.kind is Kind.INT64:
                    raw[i].append(int(v))
                elif dt.kind is Kind.FLOAT64:
                    raw[i].append(float(v))
                else:
                    raw[i].append(int(v))
    cols, dicts, dtypes = {}, {}, {}
    for i, (name, dt) in enumerate(spec):
        dtypes[name] = dt
        if dt.kind is Kind.STRING:
            values = np.array(raw[i], dtype=object)
            uniq, codes = np.unique(values.astype(str), return_inverse=True)
            dicts[name] = Dictionary(uniq.astype(object))
            cols[name] = codes.astype(np.int32)
        else:
            np_dt = {Kind.INT32: np.int32, Kind.INT64: np.int64,
                     Kind.FLOAT64: np.float64, Kind.DATE32: np.int32,
                     Kind.DECIMAL: np.int64}[dt.kind]
            cols[name] = np.array(raw[i], dtype=np_dt)
    return HostTable.from_numpy(cols, dtypes=dtypes, dictionaries=dicts)


def load_tpch_dir(path: str) -> Dict[str, HostTable]:
    """Load every <table>.tbl present under `path`."""
    out = {}
    for table in TBL_SCHEMAS:
        p = os.path.join(path, f"{table}.tbl")
        if os.path.exists(p):
            out[table] = load_tbl(p, table)
    return out
