"""Parquet ingestion (host side, feeds the device).

Copied from the JAX package's `utils/parquet_io.py`; pyarrow is imported
only when a file is read or written. The reference's TPC-H harness
registers directories of tpchgen-generated parquet through DataFusion's
ListingTable (reference tpc/src/main.rs:196-224,
tpc/scripts/generate.sh:100-103). This is the analog: pyarrow reads the
file(s), columns map onto the engine's device-friendly kinds, and strings
dictionary-encode at ingest (sorted + unique — code order == string order
is a package-wide invariant that ORDER BY and range compares rely on).

Type mapping (everything else raises):
    int8/16/32/uint8/16      -> INT32
    int64/uint32             -> INT64
    float16/32               -> FLOAT32
    float64                  -> FLOAT64
    bool                     -> BOOL
    date32                   -> DATE32
    string/large_string/dict -> STRING (dictionary codes, int32)
    decimal128(p<=18, s)     -> DECIMAL(s) carried as scaled int64
"""

from __future__ import annotations

import glob
import os
from typing import Dict

import numpy as np

from .columnar import (BOOL, DATE32, DECIMAL, DType, Dictionary, FLOAT32,
                       FLOAT64, HostTable, INT32, INT64, Kind, STRING)


def _column_to_engine(name: str, col) -> tuple:
    """pyarrow ChunkedArray/Array -> (np values, np validity, DType, dict)."""
    import pyarrow as pa
    import pyarrow.compute as pc

    if hasattr(col, "combine_chunks"):
        col = col.combine_chunks()
    t = col.type
    validity = np.asarray(pc.is_valid(col), dtype=np.bool_)

    if pa.types.is_dictionary(t):
        col = col.cast(t.value_type)
        t = col.type

    if pa.types.is_string(t) or pa.types.is_large_string(t):
        raw = col.to_numpy(zero_copy_only=False)
        nonnull = raw[validity]
        uniq = np.unique(nonnull.astype(str)) if len(nonnull) else np.array(
            [], dtype=object)  # np.unique sorts: the dictionary invariant
        codes = np.zeros(len(raw), dtype=np.int32)
        if len(uniq):
            codes[validity] = np.searchsorted(
                uniq, nonnull.astype(str)).astype(np.int32)
        return codes, validity, STRING, Dictionary(uniq.astype(object))

    if pa.types.is_decimal(t):
        if t.precision > 18:
            raise ValueError(
                f"column {name!r}: decimal128({t.precision},{t.scale}) "
                "exceeds the engine's scaled-int64 range (precision <= 18)")
        # decimal128 storage IS the scaled integer: for precision <= 18 the
        # low 64-bit word carries the whole value (the high word is sign
        # extension) — a direct cast errors with "Rescaling ... data loss"
        words = np.frombuffer(col.buffers()[1], dtype=np.int64)
        vals = words[2 * col.offset::2][:len(col)].copy()
        vals[~validity] = 0
        return vals, validity, DECIMAL(t.scale), None

    if pa.types.is_date32(t):
        vals = col.cast(pa.int32()).to_numpy(zero_copy_only=False)
        vals = np.where(validity, vals, 0).astype(np.int32)
        return vals, validity, DATE32, None

    if pa.types.is_boolean(t):
        vals = col.to_numpy(zero_copy_only=False)
        vals = np.where(validity, vals, False).astype(np.bool_)
        return vals, validity, BOOL, None

    _INT = {"int8": INT32, "int16": INT32, "int32": INT32,
            "uint8": INT32, "uint16": INT32,
            "int64": INT64, "uint32": INT64}
    _FLOAT = {"halffloat": FLOAT32, "float": FLOAT32, "double": FLOAT64}
    key = str(t)
    if key in _INT:
        dt = _INT[key]
        np_dt = np.int32 if dt is INT32 else np.int64
        vals = col.to_numpy(zero_copy_only=False)
        vals = np.where(validity, vals, 0).astype(np_dt)
        return vals, validity, dt, None
    if key in _FLOAT:
        dt = _FLOAT[key]
        np_dt = np.float32 if dt is FLOAT32 else np.float64
        vals = col.to_numpy(zero_copy_only=False)
        vals = np.where(validity, vals, 0).astype(np_dt)
        return vals, validity, dt, None
    raise ValueError(f"column {name!r}: unsupported parquet type {t}")


def read_parquet(path: str, columns=None) -> HostTable:
    """Read one parquet file, a directory of part files, or a glob into a
    HostTable."""
    import pyarrow.parquet as pq

    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "*.parquet")))
        if not files:
            raise FileNotFoundError(f"no *.parquet under {path!r}")
    elif any(c in path for c in "*?["):
        files = sorted(glob.glob(path))
        if not files:
            raise FileNotFoundError(f"glob {path!r} matched nothing")
    else:
        files = [path]

    import pyarrow as pa
    tables = [pq.read_table(f, columns=columns) for f in files]
    table = pa.concat_tables(tables) if len(tables) > 1 else tables[0]

    data: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, DType] = {}
    dictionaries: Dict[str, Dictionary] = {}
    validity: Dict[str, np.ndarray] = {}
    for name in table.column_names:
        vals, valid, dt, dic = _column_to_engine(name, table.column(name))
        data[name] = vals
        dtypes[name] = dt
        validity[name] = valid
        if dic is not None:
            dictionaries[name] = dic
    return HostTable.from_numpy(data, dtypes, dictionaries, validity)


def write_parquet(table: HostTable, path: str) -> None:
    """HostTable -> parquet (decimals come back as decimal128, strings as
    utf8) so engine outputs/datasets round-trip through standard tools."""
    import pyarrow as pa

    arrays, names = [], []
    for f in table.schema.fields:
        vals, valid = table.columns[f.name]
        mask = ~valid if not valid.all() else None
        if f.dtype.kind is Kind.STRING:
            strs = f.dictionary.values[vals]
            arr = pa.array(strs, type=pa.string(), mask=mask)
        elif f.dtype.kind is Kind.DECIMAL:
            # pyarrow's int->decimal cast rescales (we want the int64 AS the
            # scaled value); build the decimal128 storage directly instead
            lo = vals.astype("<i8")
            storage = np.empty(2 * len(lo), "<i8")
            storage[0::2] = lo
            storage[1::2] = lo >> 63  # sign extension to int128
            bufs = [None, pa.py_buffer(storage.tobytes())]
            nulls = 0
            if mask is not None:
                bufs[0] = pa.py_buffer(
                    np.packbits(valid, bitorder="little").tobytes())
                nulls = int(mask.sum())
            arr = pa.Array.from_buffers(pa.decimal128(18, f.dtype.scale),
                                        len(lo), bufs, nulls)
        elif f.dtype.kind is Kind.DATE32:
            arr = pa.array(vals, type=pa.int32(), mask=mask).cast(pa.date32())
        else:
            arr = pa.array(vals, mask=mask)
        arrays.append(arr)
        names.append(f.name)
    import pyarrow.parquet as pq
    pq.write_table(pa.table(arrays, names=names), path)
