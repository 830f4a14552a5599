"""Table catalog with statistics (torch).

Copied from the JAX package's `utils/catalog.py` (analog of reference
StaticTable, which carries exact synthetic Statistics to steer the
optimizer — reference src/utils/static_table.rs:45-140). The changes: a
`Catalog` is given the device its tables live on, and
`RegisteredTable.device()` / `device_subset()` upload there;
`release_device()` drops the cached device tables (the out-of-core
fallback frees the device before it retries); `grace_parts` is the grace
host partition pass's cache, per (column, K); distinct counts are taken by
a sort (`distinct_count`), with np.unique's value."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from .columnar import DeviceTable, HostTable, round_capacity


def distinct_count(v) -> int:
    """np.unique(v).size through a sort: NumPy 2.3+ finds plain uniques
    with a hash table, many times slower than a sort over SF10's tens of
    millions of keys."""
    import numpy as np
    s = np.sort(v)
    return int(np.count_nonzero(s[1:] != s[:-1])) + 1 if len(s) else 0


@dataclass
class Statistics:
    row_count: int
    distinct: Dict[str, int] = field(default_factory=dict)
    # most-common-value share per column (0..1); registrations may supply it,
    # otherwise it is computed lazily from the data (mcv_share_of). Drives
    # the automatic skew-salting decision (optimizer.ChooseDistModeRule).
    mcv_share: Dict[str, float] = field(default_factory=dict)


class RegisteredTable:
    def __init__(self, name: str, host: HostTable,
                 statistics: Optional[Statistics] = None, *, device):
        self.name = name
        self.host = host
        self.target_device = device
        self.statistics = statistics or Statistics(row_count=host.num_rows)
        self._device: Optional[DeviceTable] = None
        self._device_subsets: Dict[frozenset, DeviceTable] = {}
        # (partition column, K) -> (row order, partition bounds, largest
        # partition) of runtime/grace.py's host partition pass
        self.grace_parts: Dict[tuple, tuple] = {}

    def distinct_of(self, col) -> int:
        """Distinct count for a column or a TUPLE of columns (composite join
        keys); computed once (np.unique over the host data) unless the
        registration supplied it. Join ordering keys off this (reference
        steers its planner with exact synthetic Statistics the same way,
        static_table.rs:45-140). Composite counts hash-combine the columns —
        an estimate, not exact — because per-key independence is wildly
        wrong for FK pairs (TPC-H lineitem (l_partkey, l_suppkey) has ~800k
        distinct pairs, not 200k*10k)."""
        key = col if isinstance(col, str) else "\x00".join(col)
        d = self.statistics.distinct.get(key)
        if d is None:
            import numpy as np
            cols = (col,) if isinstance(col, str) else col
            h, mask = None, None
            for c in cols:
                vals, valid = self.host.columns[c]
                v = np.asarray(vals)
                if v.dtype.kind == "f":
                    v = v.view(np.uint64 if v.itemsize == 8 else np.uint32)
                v = v.astype(np.uint64)
                # polynomial rolling hash (h*M + v): XOR-combining collides
                # massively for small-int key pairs (reported 782 distinct
                # of partsupp's 8000 true pairs)
                m = np.uint64(0x9E3779B97F4A7C15)
                h = v * m if h is None else h * m + v
                mask = valid if mask is None else (mask & valid)
            d = max(distinct_count(h[mask]), 1)
            self.statistics.distinct[key] = d
        return d

    def range_of(self, col: str):
        """(min, max) of a column's valid values as floats (decimal columns
        return the SCALED integer domain), None for empty/string columns.
        Computed once; drives range-predicate selectivity estimates that
        seed filter output capacities (each avoided overflow retry is a full
        recompile)."""
        if not hasattr(self, "_ranges"):
            self._ranges: Dict[str, object] = {}
        if col not in self._ranges:
            import numpy as np
            vals, valid = self.host.columns[col]
            v = np.asarray(vals)
            if v.dtype.kind not in "iuf":
                self._ranges[col] = None
            else:
                v = v[np.asarray(valid)]
                self._ranges[col] = (float(v.min()), float(v.max())) \
                    if v.size else None
        return self._ranges[col]

    def mcv_share_of(self, col: str) -> float:
        """Share (0..1) of the most common valid value of `col` — the cheap
        histogram behind automatic skew salting (the reference mitigates the
        same skew dynamically with work stealing,
        work_stealing_repartition_exec.rs:50-115; TPUs cannot steal, so the
        planner decides statically from this statistic). Computed once, on a
        bounded STRIDED sample for very large tables — a prefix sample
        grossly mis-estimates the hot-key share on value-clustered/sorted
        columns (common for generated or ingested-sorted data) and would
        silently flip the automatic skew_salted decision."""
        d = self.statistics.mcv_share.get(col)
        if d is None:
            import numpy as np
            vals, valid = self.host.columns[col]
            n = len(vals)
            stride = max(1, n >> 22)   # ≤4M sampled rows, spread over n
            v = np.asarray(vals[::stride])[np.asarray(valid[::stride])]
            if v.size == 0:
                d = 0.0
            else:
                _, counts = np.unique(v, return_counts=True)
                d = float(counts.max()) / float(v.size)
            self.statistics.mcv_share[col] = d
        return d

    def device(self) -> DeviceTable:
        if self._device is None:
            self._device = self.host.to_device(device=self.target_device)
        return self._device

    def device_subset(self, cols: frozenset) -> DeviceTable:
        """Device table holding only `cols` (HBM residency = live columns).
        Cached per column-set; a full-width device() upload is reused."""
        if frozenset(self.host.schema.names) <= cols or \
                self._device is not None:
            return self.device()
        cached = self._device_subsets.get(cols)
        if cached is None:
            # evict other layouts: stale subsets from earlier queries would
            # pin HBM (queries run sequentially; re-upload costs far less)
            self._device_subsets.clear()
            from .columnar import HostTable, Schema
            sub = HostTable(
                Schema([f for f in self.host.schema.fields if f.name in cols]),
                {n: v for n, v in self.host.columns.items() if n in cols},
                self.host.num_rows)
            cached = sub.to_device(device=self.target_device)
            self._device_subsets[cols] = cached
        return cached

    def release_device(self):
        """Drop the cached device tables (the whole table and the column
        subsets); the next use uploads again."""
        self._device = None
        self._device_subsets.clear()


class Catalog:
    def __init__(self, *, device):
        self.device = device
        self.tables: Dict[str, RegisteredTable] = {}

    def register(self, name: str, host: HostTable,
                 statistics: Optional[Statistics] = None):
        self.tables[name] = RegisteredTable(name, host, statistics, device=self.device)

    def get(self, name: str) -> RegisteredTable:
        if name not in self.tables:
            raise KeyError(f"table {name!r} is not registered; "
                           f"have {sorted(self.tables)}")
        return self.tables[name]
