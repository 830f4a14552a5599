"""Binary columnar on-disk format: the native generator's output.

Copied from the JAX package's `utils/binfmt.py`. Layout per table (written
by native/tpch_datagen.cpp::dfp_generate):

    <dir>/meta.json     {"num_rows": N, "columns": [{name, kind, file,
                                                     dict?}, ...],
                         "distinct": {column or "a,b": count}}
    <dir>/<col>.bin     raw little-endian values (i32 / i64 per kind)
    <dir>/<col>.dict    sorted unique strings, one per line (codes are i32)

Kinds: i32, i64, dec2 (scaled int64 cents), date (date32 i32), str
(dictionary codes i32). All columns are non-null; validity is a zero-stride
broadcast view, so a 60M-row lineitem costs no host memory for its masks.

`read_bin_table(dir, memmap=True)` maps the values with np.memmap: the
tables open at once, an upload (`HostTable.to_device`) reads each column's
pages once, and a streamed chunk (`utils/columnar.py::pack_host_slice`)
reads only the pages of its rows.
"""

from __future__ import annotations

import ctypes
import json
import os
from typing import Dict

import numpy as np

from .catalog import Statistics
from .columnar import (DATE32, DECIMAL, Dictionary, Field, HostTable, INT32,
                       INT64, STRING, Schema)

_KINDS = {
    "i32": (INT32, np.int32),
    "i64": (INT64, np.int64),
    "dec2": (DECIMAL(2), np.int64),
    "date": (DATE32, np.int32),
    "str": (STRING, np.int32),
}


def is_bin_table_dir(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "meta.json"))


def read_bin_table(path: str, memmap: bool = True) -> HostTable:
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    n = int(meta["num_rows"])
    # exact distinct counts from the generator: they spare the planner its
    # np.unique passes over the columns ("a,b" = a composite key)
    distinct = {k.replace(",", "\x00"): int(v)
                for k, v in meta.get("distinct", {}).items()}
    valid = np.broadcast_to(np.bool_(True), (n,))
    fields, columns = [], {}
    for c in meta["columns"]:
        dtype, np_dt = _KINDS[c["kind"]]
        fp = os.path.join(path, c["file"])
        if memmap:
            vals = np.memmap(fp, dtype=np_dt, mode="r", shape=(n,))
        else:
            vals = np.fromfile(fp, dtype=np_dt, count=n)
        dictionary = None
        if c.get("dict"):
            with open(os.path.join(path, c["dict"]), "rb") as df:
                lines = df.read().decode("utf-8").split("\n")
            if lines and lines[-1] == "":
                lines.pop()
            dictionary = Dictionary(np.array(lines, dtype=object))
        fields.append(Field(c["name"], dtype, nullable=False,
                            dictionary=dictionary))
        columns[c["name"]] = (vals, valid)
    t = HostTable(Schema(fields), columns, n)
    if distinct:
        t.statistics_hint = Statistics(row_count=n, distinct=distinct)
    return t


def read_bin_dataset(path: str, memmap: bool = True) -> Dict[str, HostTable]:
    out = {}
    for name in sorted(os.listdir(path)):
        sub = os.path.join(path, name)
        if os.path.isdir(sub) and is_bin_table_dir(sub):
            out[name] = read_bin_table(sub, memmap)
    return out


def generate_native(sf: float, outdir: str, seed: int = 19940315) -> None:
    """Run the C++ generator (compiled at its first use)."""
    from ..native import load_library
    lib = load_library("tpch_datagen")
    lib.dfp_generate.restype = ctypes.c_int64
    lib.dfp_generate.argtypes = [ctypes.c_double, ctypes.c_uint64,
                                 ctypes.c_char_p]
    rc = lib.dfp_generate(float(sf), int(seed), outdir.encode())
    if rc != 0:
        raise RuntimeError(f"native datagen failed (rc={rc})")
