"""Columnar substrate: host tables and fixed-capacity device tables (torch).

Counterpart of `datafusion_parallelism_tpu/utils/columnar.py`, with the same
data model:

  * A column is `(values, validity)` — two dense tensors. Strings are
    dictionary-encoded to int32 codes at ingest; the dictionary stays on the
    host.
  * A `DeviceTable` has a static capacity and a `num_rows` 0-dim int32 tensor
    on the table's device. Rows past `num_rows` are padding.
  * `PackedTable` holds all columns of a table as ONE `[W, cap]` int32
    word-major matrix plus validity words, with float64 columns carried
    beside it. The layout and the validity-bit placement are the JAX
    package's, so packed words compare one for one across the two packages.

The host half (everything above `DeviceTable`) is numpy code copied from the
JAX package: the machine with the GPU has no jax, so nothing is imported
from there.
"""

from __future__ import annotations

import enum
import warnings
from dataclasses import dataclass, replace
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

def round_capacity(n: int, minimum: int = 128) -> int:
    """Round a row count up to the next power of two; above 64M rows, to the
    next multiple of 4M (a power of two would waste up to 2x of device
    memory at exactly the scale where it binds)."""
    n = max(int(n), minimum)
    if n > (1 << 26):
        step = 1 << 22
        return -(-n // step) * step
    return 1 << (n - 1).bit_length()


class Kind(enum.Enum):
    INT32 = "int32"
    INT64 = "int64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    BOOL = "bool"
    DATE32 = "date32"      # days since 1970-01-01, int32 on device
    STRING = "string"      # dictionary codes, int32 on device
    DECIMAL = "decimal"    # fixed-point int64 (value * 10**scale)


_DEVICE_DTYPE = {
    Kind.INT32: torch.int32,
    Kind.INT64: torch.int64,
    Kind.FLOAT32: torch.float32,
    Kind.FLOAT64: torch.float64,
    Kind.BOOL: torch.bool,
    Kind.DATE32: torch.int32,
    Kind.STRING: torch.int32,
    Kind.DECIMAL: torch.int64,
}


@dataclass(frozen=True)
class DType:
    kind: Kind
    scale: int = 0  # decimal scale only

    @property
    def device_dtype(self) -> torch.dtype:
        return _DEVICE_DTYPE[self.kind]

    def __repr__(self):
        if self.kind is Kind.DECIMAL:
            return f"decimal(.,{self.scale})"
        return self.kind.value


INT32 = DType(Kind.INT32)
INT64 = DType(Kind.INT64)
FLOAT32 = DType(Kind.FLOAT32)
FLOAT64 = DType(Kind.FLOAT64)
BOOL = DType(Kind.BOOL)
DATE32 = DType(Kind.DATE32)
STRING = DType(Kind.STRING)


def DECIMAL(scale: int) -> DType:
    return DType(Kind.DECIMAL, scale)


class Dictionary:
    """String dictionary (host side). Hash/eq by identity."""

    __slots__ = ("values", "_index")

    def __init__(self, values: np.ndarray):
        self.values = np.asarray(values, dtype=object)
        self._index: Optional[dict] = None

    def index(self) -> dict:
        if self._index is None:
            self._index = {v: i for i, v in enumerate(self.values)}
        return self._index

    def code_of(self, s) -> int:
        """Code of string s, or -1 if absent."""
        return self.index().get(s, -1)

    def __len__(self):
        return len(self.values)

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    def __repr__(self):
        return f"Dictionary(n={len(self.values)}, id={id(self):#x})"


@dataclass(frozen=True)
class Field:
    name: str
    dtype: DType
    nullable: bool = True
    dictionary: Optional[Dictionary] = None

    def with_name(self, name: str) -> "Field":
        return replace(self, name=name)


@dataclass(frozen=True)
class Schema:
    fields: Tuple[Field, ...]

    def __init__(self, fields: Sequence[Field]):
        object.__setattr__(self, "fields", tuple(fields))
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names in schema: {names}")

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(f"no column {name!r}; have {self.names}")

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(name)

    def __len__(self):
        return len(self.fields)


# ---------------------------------------------------------------------------
# Host table
# ---------------------------------------------------------------------------

_HOST_DTYPE = {
    Kind.INT32: np.int32,
    Kind.INT64: np.int64,
    Kind.FLOAT32: np.float32,
    Kind.FLOAT64: np.float64,
    Kind.BOOL: np.bool_,
    Kind.DATE32: np.int32,
    Kind.STRING: np.int32,
    Kind.DECIMAL: np.int64,
}

_EPOCH = np.datetime64("1970-01-01", "D")


def date32_of(s: str) -> int:
    """'1994-03-15' -> days since epoch."""
    return int((np.datetime64(s, "D") - _EPOCH).astype(np.int64))


def _copy_host(dst: torch.Tensor, arr: np.ndarray) -> None:
    """Copy the host column `arr` into the head of `dst` in one copy: a
    zero-stride view (a broadcast validity mask) as a fill, a read-only
    memmap straight from its pages, each read once."""
    n = len(arr)
    if n == 0:
        return
    if arr.strides == (0,):
        dst[:n].fill_(arr[0].item())
        return
    with warnings.catch_warnings():
        # copy_ only reads the array
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        src = torch.from_numpy(np.ascontiguousarray(arr))
    dst[:n].copy_(src)


class HostTable:
    """Host-resident columnar table: numpy values + validity per column."""

    def __init__(self, schema: Schema, columns: Dict[str, Tuple[np.ndarray, np.ndarray]],
                 num_rows: int):
        self.schema = schema
        self.columns = columns
        self.num_rows = int(num_rows)

    @staticmethod
    def from_pydict(data: Dict[str, list], dtypes: Optional[Dict[str, DType]] = None
                    ) -> "HostTable":
        """Build from python lists; None means null. Strings dict-encode."""
        dtypes = dtypes or {}
        fields, columns = [], {}
        num_rows = None
        for name, vals in data.items():
            vals = list(vals)
            if num_rows is None:
                num_rows = len(vals)
            elif num_rows != len(vals):
                raise ValueError("ragged columns")
            validity = np.array([v is not None for v in vals], dtype=np.bool_)
            dt = dtypes.get(name)
            dictionary = None
            nonnull = [v for v in vals if v is not None]
            if dt is None:
                if any(isinstance(v, str) for v in nonnull):
                    dt = STRING
                elif any(isinstance(v, float) for v in nonnull):
                    dt = FLOAT64
                elif all(isinstance(v, (bool, np.bool_)) for v in nonnull) and nonnull:
                    dt = BOOL
                else:
                    dt = INT32
                    if any(abs(int(v)) > 2**31 - 1 for v in nonnull):
                        dt = INT64
            if dt.kind is Kind.STRING:
                uniq = sorted({v for v in nonnull})
                dictionary = Dictionary(np.array(uniq, dtype=object))
                idx = dictionary.index()
                values = np.array([idx[v] if v is not None else 0 for v in vals],
                                  dtype=np.int32)
            else:
                np_dt = _HOST_DTYPE[dt.kind]
                fill = np_dt(0)
                if dt.kind is Kind.DECIMAL:
                    scale = 10 ** dt.scale
                    values = np.array(
                        [np.int64(round(float(v) * scale)) if v is not None else fill
                         for v in vals], dtype=np_dt)
                elif dt.kind is Kind.DATE32:
                    values = np.array(
                        [date32_of(v) if isinstance(v, str) else (v if v is not None else 0)
                         for v in vals], dtype=np_dt)
                else:
                    values = np.array([v if v is not None else fill for v in vals],
                                      dtype=np_dt)
            fields.append(Field(name, dt, nullable=not validity.all(),
                                dictionary=dictionary))
            columns[name] = (values, validity)
        return HostTable(Schema(fields), columns, num_rows or 0)

    @staticmethod
    def from_numpy(data: Dict[str, np.ndarray],
                   dtypes: Optional[Dict[str, DType]] = None,
                   dictionaries: Optional[Dict[str, Dictionary]] = None,
                   validity: Optional[Dict[str, np.ndarray]] = None) -> "HostTable":
        dtypes = dtypes or {}
        dictionaries = dictionaries or {}
        validity = validity or {}
        fields, columns = [], {}
        num_rows = None
        for name, arr in data.items():
            arr = np.asarray(arr)
            if num_rows is None:
                num_rows = len(arr)
            dt = dtypes.get(name)
            if dt is None:
                dt = {np.dtype(np.int32): INT32, np.dtype(np.int64): INT64,
                      np.dtype(np.float32): FLOAT32, np.dtype(np.float64): FLOAT64,
                      np.dtype(np.bool_): BOOL}[arr.dtype]
            valid = validity.get(name)
            if valid is None:
                valid = np.ones(len(arr), dtype=np.bool_)
            fields.append(Field(name, dt, nullable=not valid.all(),
                                dictionary=dictionaries.get(name)))
            columns[name] = (arr.astype(_HOST_DTYPE[dt.kind], copy=False), valid)
        return HostTable(Schema(fields), columns, num_rows or 0)

    def to_device(self, capacity: Optional[int] = None, *,
                  device) -> "DeviceTable":
        """Upload, padded to `capacity` rows (default: round_capacity)."""
        cap = capacity or round_capacity(self.num_rows)
        if cap < self.num_rows:
            raise ValueError("capacity < num_rows")
        cols = {}
        for f in self.schema.fields:
            v, valid = self.columns[f.name]
            tv = torch.zeros(cap, dtype=f.dtype.device_dtype, device=device)
            tm = torch.zeros(cap, dtype=torch.bool, device=device)
            _copy_host(tv, v)
            _copy_host(tm, valid)
            cols[f.name] = (tv, tm)
        return DeviceTable(self.schema, cols,
                           torch.tensor(self.num_rows, dtype=torch.int32, device=device))

    def to_pylist(self) -> List[dict]:
        out = []
        for i in range(self.num_rows):
            row = {}
            for f in self.schema.fields:
                v, valid = self.columns[f.name]
                if not valid[i]:
                    row[f.name] = None
                elif f.dtype.kind is Kind.STRING:
                    row[f.name] = f.dictionary.values[int(v[i])]
                elif f.dtype.kind is Kind.DECIMAL:
                    row[f.name] = int(v[i]) / (10 ** f.dtype.scale)
                elif f.dtype.kind is Kind.BOOL:
                    row[f.name] = bool(v[i])
                elif f.dtype.kind in (Kind.FLOAT32, Kind.FLOAT64):
                    row[f.name] = float(v[i])
                else:
                    row[f.name] = int(v[i])
            out.append(row)
        return out


# ---------------------------------------------------------------------------
# Device table
# ---------------------------------------------------------------------------

class DeviceTable:
    """Fixed-capacity device-resident columnar table.

    columns: name -> (values[capacity], validity[capacity]) tensors
    num_rows: 0-dim int32 tensor on the table's device
    """

    __slots__ = ("schema", "columns", "num_rows")

    def __init__(self, schema: Schema,
                 columns: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                 num_rows: torch.Tensor):
        self.schema = schema
        self.columns = columns
        self.num_rows = num_rows

    @property
    def capacity(self) -> int:
        for v, _ in self.columns.values():
            return int(v.shape[0])
        return 0

    @property
    def device(self) -> torch.device:
        return self.num_rows.device

    def column(self, name: str) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.columns[name]

    def row_mask(self) -> torch.Tensor:
        return (torch.arange(self.capacity, dtype=torch.int32, device=self.device)
                < self.num_rows)

    def rename(self, mapping: Dict[str, str]) -> "DeviceTable":
        fields = [f.with_name(mapping.get(f.name, f.name)) for f in self.schema.fields]
        cols = {mapping.get(n, n): c for n, c in self.columns.items()}
        return DeviceTable(Schema(fields), cols, self.num_rows)

    def to_host(self) -> HostTable:
        """Copy the valid rows (never the padding) to the host."""
        n = int(self.num_rows)
        cols = {}
        for f in self.schema.fields:
            v, valid = self.columns[f.name]
            cols[f.name] = (v[:n].cpu().numpy(), valid[:n].cpu().numpy())
        return HostTable(self.schema, cols, n)

    def __repr__(self):
        return f"DeviceTable(cap={self.capacity}, cols={self.schema.names})"


def null_columns_like(schema: Schema, capacity: int, *, device
                      ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    cols = {}
    for f in schema.fields:
        cols[f.name] = (torch.zeros(capacity, dtype=f.dtype.device_dtype, device=device),
                        torch.zeros(capacity, dtype=torch.bool, device=device))
    return cols


def hstack_tables(a: DeviceTable, b: DeviceTable, num_rows) -> DeviceTable:
    """Combine columns of two same-capacity tables (e.g. join pair output)."""
    if a.capacity != b.capacity:
        raise ValueError(f"capacities differ: {a.capacity} vs {b.capacity}")
    fields = list(a.schema.fields) + list(b.schema.fields)
    cols = dict(a.columns)
    cols.update(b.columns)
    return DeviceTable(Schema(fields), cols,
                       torch.as_tensor(num_rows, dtype=torch.int32, device=a.device))


# ---------------------------------------------------------------------------
# Row packing: all columns + validity of a table in ONE [W, cap] int32 matrix
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PackedLayout:
    fields: Tuple[Tuple[str, Kind, int, int], ...]  # (name, kind, slot, nslots)
    f64_fields: Tuple[str, ...]  # carried beside the packed words
    valid_base: int
    width: int


class PackedTable(NamedTuple):
    packed: torch.Tensor                 # [W, cap] int32, word-major
    f64s: Dict[str, torch.Tensor]        # name -> float64[cap]
    layout: Optional[PackedLayout]

    def take_rows(self, indices: torch.Tensor, n=None, kernels=None) -> "PackedTable":
        """Row j = row indices[j] (clipped into range, as the JAX package's
        mode="clip"), through K5's gather; with `n` (a 0-dim count), rows at
        or past n are zeros."""
        words, f64 = _chain(kernels).gather_rows(self.packed, f64_matrix(self),
                                                 indices.to(torch.int32), n)
        return PackedTable(words, dict(zip(self.f64s, f64)), self.layout)


def _chain(kernels):
    """The compaction family's kernels: `kernels` (a kernels/chain.py
    ChainKernels), or its KERNELS when None. Imported here because the
    kernel modules import this one."""
    if kernels is not None:
        return kernels
    from ..kernels.chain import KERNELS
    return KERNELS


def f64_matrix(pt: PackedTable) -> torch.Tensor:
    """The float64 sidecar columns as one [F, cap] matrix (F may be 0)."""
    if not pt.f64s:
        return torch.empty((0, pt.packed.shape[1]), dtype=torch.float64,
                           device=pt.packed.device)
    return torch.stack(list(pt.f64s.values()))


def _fuse(pts: Sequence[PackedTable]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Several same-capacity packed tables as one word matrix and one
    float64 matrix (stacked on the width axis), so one gather moves all."""
    words = pts[0].packed if len(pts) == 1 else torch.cat([pt.packed for pt in pts])
    f64s = [f64_matrix(pt) for pt in pts]
    return words, f64s[0] if len(f64s) == 1 else torch.cat(f64s)


def _split(pts: Sequence[PackedTable], words: torch.Tensor, f64: torch.Tensor
           ) -> List[PackedTable]:
    out, w, f = [], 0, 0
    for pt in pts:
        nw, nf = pt.packed.shape[0], len(pt.f64s)
        out.append(PackedTable(words[w:w + nw], dict(zip(pt.f64s, f64[f:f + nf])), pt.layout))
        w, f = w + nw, f + nf
    return out


def take_rows_fused(pts: Sequence[PackedTable], indices: torch.Tensor,
                    kernels=None) -> List[PackedTable]:
    """Gather the same rows from several packed tables with ONE K5 gather
    (their word matrices stacked on the width axis; float64 column names
    must be disjoint across them)."""
    names = [n for pt in pts for n in pt.f64s]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate float64 columns in a fused gather: {names}")
    words, f64 = _chain(kernels).gather_rows(*_fuse(pts), indices.to(torch.int32))
    return _split(pts, words, f64)


def compaction_indices(mask: torch.Tensor, kernels=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gather_idx int32[cap], n int32): gather_idx[j] = index of the j-th
    True in mask (stable), through K5 over the row ids. Entries at or past
    n are 0 (the JAX package leaves failing rows' ids there); callers mask
    with j < n."""
    cap = mask.shape[0]
    iota = torch.arange(cap, dtype=torch.int32, device=mask.device)[None]
    rows, _, n = _chain(kernels).filter_compact(
        mask, iota, torch.empty((0, cap), dtype=torch.float64, device=mask.device), cap)
    return rows[0], n.to(torch.int32)


def compact_rows(pts: Sequence[PackedTable], mask: torch.Tensor, out_cap: int,
                 kernels=None) -> Tuple[List[PackedTable], torch.Tensor]:
    """Rows where mask is True, in order, at the front of out_cap-capacity
    packed tables: ONE K5 launch for all of them. Survivors past out_cap
    drop; the returned n (int32 0-dim) is the TRUE survivor count for the
    caller's overflow check. Rows at or past n are zeros (the JAX package
    zeroes only their validity words)."""
    words, f64, n = _chain(kernels).filter_compact(mask, *_fuse(pts), out_cap)
    return _split(pts, words, f64), n.to(torch.int32)


def filter_rows(t: "DeviceTable", mask: torch.Tensor, kernels=None) -> "DeviceTable":
    """Compact rows where mask is True to the front (stable order)."""
    (pt,), n = compact_rows([pack_table(t, kernels)], mask, t.capacity, kernels)
    return unpack_table(pt, t.schema, n, kernels)


def concat_tables(parts: Sequence[DeviceTable], concat_rows=None,
                  kernels=None) -> DeviceTable:
    """Stack tables with identical schemas: each part's valid rows, in
    order, at the front of a table of capacity sum(cap); the rest read
    NULL. Each part is packed (K12 through `kernels`) and all go through
    ONE K11 launch (`concat_rows`, kernels/concat_rows.py's wrapper by
    default)."""
    if concat_rows is None:
        from ..kernels.concat_rows import concat_rows
    pts = [pack_table(p, kernels) for p in parts]
    words, f64, n = concat_rows([(pt.packed, f64_matrix(pt), p.num_rows)
                                 for pt, p in zip(pts, parts)])
    layout = pts[0].layout
    return unpack_table(PackedTable(words, dict(zip(layout.f64_fields, f64)), layout),
                        parts[0].schema, n, kernels)


def gather_table(t: "DeviceTable", indices: torch.Tensor, new_num_rows,
                 kernels=None) -> "DeviceTable":
    """New table of capacity len(indices): row j = t[indices[j]], as pack ->
    ONE K5 row gather -> unpack. (The JAX package's `row_valid` argument,
    for outer-join padding, has no caller in either package and is left
    out.)"""
    return unpack_table(pack_table(t, kernels).take_rows(indices, None, kernels), t.schema,
                        new_num_rows, kernels)


def packed_layout(schema: Schema) -> PackedLayout:
    fields = []
    f64s = []
    slot = 0
    for f in schema.fields:
        if f.dtype.kind is Kind.FLOAT64:
            f64s.append(f.name)
            fields.append((f.name, f.dtype.kind, -1, 0))
            continue
        n = 2 if f.dtype.kind in (Kind.INT64, Kind.DECIMAL) else 1
        fields.append((f.name, f.dtype.kind, slot, n))
        slot += n
    valid_base = slot
    width = slot + (len(schema.fields) + 31) // 32
    return PackedLayout(tuple(fields), tuple(f64s), valid_base, width)


def int64_words(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) int32 words of an int64 tensor; the int32 cast keeps the low
    32 bits, and hi is the arithmetic shift."""
    return v.to(torch.int32), (v >> 32).to(torch.int32)


def pack_host_slice(t: HostTable, names, lo: int, n: int, cap: int,
                    rename_prefix: str = "", rows=None, out=None):
    """Numpy mirror of pack_table over host rows [lo, lo+n), padded to `cap`:
    ONE [W, cap] int32 matrix (+ separate f64 columns) so a streamed chunk
    crosses the host->device link as a single transfer instead of one
    padded upload per column.

    `rows` (optional int array, len n): select THESE rows instead of the
    contiguous [lo, lo+n) range — grace-partitioned streaming packs a
    key-hash partition, whose row set is scattered across the table.

    `out` (optional (words [W, cap] int32, f64 [F, cap] float64) numpy
    arrays, e.g. views of pinned host buffers that are used again): pack
    into them instead of new arrays; the f64s returned are their rows.

    Returns (schema, layout, packed, f64s); the device side reconstructs the
    chunk with unpack_table."""
    fields = [f.with_name(rename_prefix + f.name)
              for f in t.schema.fields if f.name in names]
    schema = Schema(fields)
    layout = packed_layout(schema)
    strip = len(rename_prefix)

    def take(arr):
        if rows is not None:
            return np.asarray(arr)[rows]
        return np.asarray(arr[lo:lo + n])

    if out is None:
        packed = np.zeros((layout.width, cap), np.int32)
        f64_rows = np.zeros((len(layout.f64_fields), cap), np.float64)
    else:
        packed, f64_rows = out
        packed[:, n:] = 0
        f64_rows[:, n:] = 0
    f64s = {}
    for name, kind, slot, nw in layout.fields:
        v, _ = t.columns[name[strip:]]
        v = take(v)
        if kind is Kind.FLOAT64:
            out_row = f64_rows[len(f64s)]
            out_row[:n] = v
            f64s[name] = out_row
        elif nw == 2:
            vv = v.astype(np.int64, copy=False)
            packed[slot, :n] = (vv & np.int64(0xFFFFFFFF)).astype(
                np.uint32).view(np.int32)
            packed[slot + 1, :n] = (vv >> np.int64(32)).astype(np.int32)
        elif kind is Kind.FLOAT32:
            packed[slot, :n] = v.view(np.int32)
        else:
            packed[slot, :n] = v.astype(np.int32, copy=False)
    n_fields = len(layout.fields)
    for w in range((n_fields + 31) // 32):
        word = np.zeros(n, np.uint32)
        for j in range(w * 32, min((w + 1) * 32, n_fields)):
            _, valid = t.columns[layout.fields[j][0][strip:]]
            word |= (take(valid).astype(np.uint32)
                     << np.uint32(j - w * 32))
        packed[layout.valid_base + w, :n] = word.view(np.int32)
        packed[layout.valid_base + w, n:] = 0
    return schema, layout, packed, f64s


def pack_table(t: DeviceTable, kernels=None) -> PackedTable:
    """All columns + validity bitmask in one [W, cap] int32 matrix (float64
    columns ride alongside), through K12's pack (`kernels`, a
    kernels/chain.py ChainKernels, its KERNELS when None)."""
    layout = packed_layout(t.schema)
    cols = [t.columns[name] for name, _, _, _ in layout.fields]
    packed = _chain(kernels).pack_rows(layout, cols)
    f64s = {name: t.columns[name][0] for name in layout.f64_fields}
    return PackedTable(packed, f64s, layout)


def unpack_table(pt: PackedTable, schema: Schema, num_rows, kernels=None) -> DeviceTable:
    """Inverse of pack_table over (possibly gathered) packed rows, through
    K12's unpack."""
    layout = pt.layout
    cols = {}
    for (name, _, _, _), (v, valid) in zip(layout.fields,
                                          _chain(kernels).unpack_rows(layout, pt.packed)):
        cols[name] = (pt.f64s[name] if v is None else v, valid)
    return DeviceTable(schema, cols,
                       torch.as_tensor(num_rows, dtype=torch.int32, device=pt.packed.device))
