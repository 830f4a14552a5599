"""Hash-partition shuffle over an Exchange.

Counterpart of the JAX package's `parallel/shuffle.py`. Every shard packs,
per destination, the rows whose key hash routes there into a fixed-size
send block, the blocks cross in one all-to-all, and each shard compacts
what it received: the same static capacities (a per-destination send
capacity, and a dropped-row count that makes the caller grow it and run
again), the same routing (the high bits of the row hash whose low bits
pick hash-table slots), and shards equal to the JAX package's row for row.

The steps run over the local shards of the Exchange (a list of
DeviceTables, one per partition this process holds) through the kernels:
K1 hashes the keys, K18 `dest_pack` routes the rows and lays out the
index grid, K12 packs the rows, K5 gathers the send blocks and compacts
what arrives, K12 unpacks it. Past a budget of received bytes
(RECV_BUDGET_BYTES over the local shards) the send capacity is sized
from K18's counts instead of the static one (`_fit_send_cap`): the same
rows, in smaller send blocks and received shards.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import dest_pack as k18
from ..kernels import key_histogram as k19
from ..kernels.concat_rows import MAX_PARTS
from ..ops.hashing import hash_rows
from ..utils.columnar import (DeviceTable, HostTable, PackedTable, Schema, compact_rows,
                              concat_tables, f64_matrix, pack_table, packed_layout,
                              round_capacity, unpack_table)
from .exchange import Exchange, uncounted

Shards = List[DeviceTable]

# the bytes the received blocks of one shuffle may hold over the local shards
# before their send capacity is sized from the rows sent (`_fit_send_cap`).
# Set from tools/dist_sql_memory.py's readings (TPC-H SF10, 8 partitions on
# one H100; PERF.md): at 1 GiB the 22 queries peak no higher than with
# every shuffle sized from its counts, and take 7% longer in all; at 4 GiB
# they peak 31% higher and take 48% longer; with no budget Q10, Q18 and Q20
# exhaust the 80 GB. Below the budget the capacities are the JAX package's.
RECV_BUDGET_BYTES = 1 << 30


class DistKernels(NamedTuple):
    """The kernels of the distributed layer, as one table (ops/join.py's
    JoinKernels for the joins): KERNELS (the wrappers: the kernels on CUDA
    tensors, the plain versions on CPU tensors) or PLAIN."""
    dest_pack: Callable       # K18
    key_histogram: Callable   # K19


KERNELS = DistKernels(k18.dest_pack, k19.key_histogram)
PLAIN = DistKernels(k18.dest_pack_plain, k19.key_histogram_plain)


def _hashes(t: DeviceTable, keys: Sequence[str]) -> torch.Tensor:
    return hash_rows([t.column(k) for k in keys])


def _row_mask(t: DeviceTable, valid: Optional[torch.Tensor]) -> torch.Tensor:
    mask = t.row_mask()
    return mask if valid is None else mask & valid


def _exchange_and_compact(ex: Exchange, schema: Schema, packs, P: int,
                          send_cap: int) -> Shards:
    """packs[k] = (packed table of local shard k's send rows [W, P *
    send_cap], send_valid bool [P, send_cap]): all_to_all the blocks, then
    compact each shard's received rows to the front (K5) and unpack them
    (K12). A received shard holds P * send_cap rows, source by source."""
    layout = packs[0][0].layout
    valid = ex.all_to_all([v for _, v in packs], 0)
    words = ex.all_to_all([pt.packed.reshape(-1, P, send_cap) for pt, _ in packs], 1)
    f64 = ([f64_matrix(pt).reshape(-1, P, send_cap) for pt, _ in packs]
           if not layout.f64_fields else
           ex.all_to_all([f64_matrix(pt).reshape(-1, P, send_cap) for pt, _ in packs], 1))
    out = []
    for v, w, f in zip(valid, words, f64):
        recv = PackedTable(w.reshape(w.shape[0], P * send_cap),
                           dict(zip(layout.f64_fields, f.reshape(f.shape[0], P * send_cap))),
                           layout)
        (cpt,), n = compact_rows([recv], v.reshape(P * send_cap), P * send_cap)
        out.append(unpack_table(cpt, schema, n))
    return out


def _fit_send_cap(ex: Exchange, schema: Schema, hashes, masks, replicate, send_cap: int,
                  kernels: DistKernels, heavy, heavy_to_all: bool) -> int:
    """The per-destination send capacity a shuffle runs at: `send_cap`,
    the JAX package's static capacity, unless the local shards' received
    blocks (P x send_cap rows each) would pass RECV_BUDGET_BYTES; then
    the most rows one source sends one destination, read from K18's
    counts (a pass at send capacity 0, the max over the partitions in one
    sync), rounded up: never more than `send_cap`, so rows drop (and the
    caller grows the capacity) exactly where they would at `send_cap`."""
    layout = packed_layout(schema)
    row_bytes = 4 * layout.width + 8 * len(layout.f64_fields)
    if len(hashes) * ex.P * send_cap * row_bytes <= RECV_BUDGET_BYTES:
        return send_cap
    most = [kernels.dest_pack(h, m, ex.P, 0, heavy, rank, rep, heavy_to_all)[1].max()
            for rank, h, m, rep in zip(ex.ranks, hashes, masks, replicate)]
    return min(send_cap, round_capacity(int(ex.all_reduce(most, "max")[0])))


def _shuffle(ex: Exchange, shards: Shards, keys: List[str], send_cap: int, valid,
             kernels: DistKernels, heavy: Optional[torch.Tensor] = None,
             replicate: Optional[Sequence[torch.Tensor]] = None,
             heavy_to_all: bool = False,
             hashes: Optional[Sequence[torch.Tensor]] = None) -> Tuple[Shards, torch.Tensor]:
    """K1 (unless the shards' `hashes` are given) and K18 per local shard
    (K18's route arguments as dest_pack takes them, `valid` and
    `replicate` per shard), the send blocks, the exchange; and the dropped
    rows summed over the partitions."""
    valid = valid or [None] * len(shards)
    replicate = replicate or [None] * len(shards)
    hashes = [_hashes(t, keys) if h is None else h
              for t, h in zip(shards, hashes or [None] * len(shards))]
    masks = [_row_mask(t, v) for t, v in zip(shards, valid)]
    send_cap = _fit_send_cap(ex, shards[0].schema, hashes, masks, replicate, send_cap, kernels,
                             heavy, heavy_to_all)
    packs, dropped = [], []
    for rank, t, h, m, rep in zip(ex.ranks, shards, hashes, masks, replicate):
        grid, counts, d = kernels.dest_pack(h, m, ex.P, send_cap, heavy, rank, rep, heavy_to_all)
        send_valid = (torch.arange(send_cap, dtype=torch.int32, device=t.device)[None, :]
                      < counts[:, None])
        packs.append((pack_table(t).take_rows(grid.reshape(ex.P * send_cap)), send_valid))
        dropped.append(d)
    out = _exchange_and_compact(ex, shards[0].schema, packs, ex.P, send_cap)
    return out, ex.all_reduce(dropped)[0]


def shuffle_by_hash(ex: Exchange, shards: Shards, keys: List[str], send_cap: int,
                    heavy: Optional[torch.Tensor] = None,
                    valid: Optional[Sequence[Optional[torch.Tensor]]] = None,
                    kernels: DistKernels = KERNELS,
                    hashes: Optional[Sequence[torch.Tensor]] = None
                    ) -> Tuple[Shards, torch.Tensor]:
    """Repartition the local shards by key hash: (received shards, each of
    capacity P * send_cap, and the dropped row count summed over the
    partitions). `heavy` (bool [256]) salts the route as the JAX
    package's `salted_route` dest_override does: a row in a heavy hash
    bucket stays on its own partition. `valid` (per shard, or None): late
    materialization, rows where it is False are never sent. `hashes`: the
    shards' key hashes where the caller made them already (the salted
    step's histogram reads the same ones)."""
    return _shuffle(ex, shards, keys, send_cap, valid, kernels, heavy=heavy, hashes=hashes)


def replicating_shuffle(ex: Exchange, shards: Shards, keys: List[str], send_cap: int,
                        replicate: Optional[Sequence[torch.Tensor]] = None,
                        valid: Optional[Sequence[Optional[torch.Tensor]]] = None,
                        kernels: DistKernels = KERNELS,
                        heavy: Optional[torch.Tensor] = None) -> Tuple[Shards, torch.Tensor]:
    """shuffle_by_hash, with the rows flagged in `replicate` (bool [cap]
    per shard) sent to every partition; or, given `heavy` (bool [256]),
    the rows in its heavy hash buckets, which K18 reads off the hash (the
    skewed build side; the same rows as skew.build_replication_mask
    flags)."""
    return _shuffle(ex, shards, keys, send_cap, valid, kernels, heavy=heavy,
                    replicate=replicate, heavy_to_all=heavy is not None)


# ---------------------------------------------------------------------------
# Host-side shard construction and collection
# ---------------------------------------------------------------------------

def partition_table(t: HostTable, P: int, shard_cap: Optional[int] = None):
    """Split a host table into P contiguous row shards as stacked numpy
    arrays: (columns name -> ([P, cap] values, [P, cap] validity),
    num_rows [P] int32, schema, cap), as the JAX package's
    partition_table (its arrays are jnp, these numpy)."""
    n = t.num_rows
    per = -(-n // P) if n else 0
    cap = shard_cap or round_capacity(max(per, 1))
    num_rows = np.zeros((P,), dtype=np.int32)
    cols = {}
    for f in t.schema.fields:
        v, valid = t.columns[f.name]
        sv = np.zeros((P, cap), dtype=v.dtype)
        svalid = np.zeros((P, cap), dtype=np.bool_)
        for p in range(P):
            lo, hi = p * per, min((p + 1) * per, n)
            k = max(hi - lo, 0)
            num_rows[p] = k
            if k:
                sv[p, :k] = v[lo:hi]
                svalid[p, :k] = valid[lo:hi]
        cols[f.name] = (sv, svalid)
    return cols, num_rows, t.schema, cap


def local_table(schema: Schema, cols, num_rows, rank: int, *, device) -> DeviceTable:
    """Partition `rank`'s shard of partition_table's arrays, on `device`."""
    local = {n: (torch.from_numpy(np.ascontiguousarray(v[rank])).to(device),
                 torch.from_numpy(np.ascontiguousarray(valid[rank])).to(device))
             for n, (v, valid) in cols.items()}
    return DeviceTable(schema, local,
                       torch.tensor(int(num_rows[rank]), dtype=torch.int32, device=device))


def unlocal_table(t: DeviceTable):
    """Inverse of local_table: (columns with a leading length-1 shard axis,
    num_rows [1])."""
    cols = {n: (v[None], valid[None]) for n, (v, valid) in t.columns.items()}
    return cols, t.num_rows[None]


def local_shards(ex: Exchange, schema: Schema, cols, num_rows) -> Shards:
    """The shards of partition_table's arrays that this process holds."""
    return [local_table(schema, cols, num_rows, r, device=ex.device) for r in ex.ranks]


def all_gather_table(ex: Exchange, shards: Sequence[DeviceTable]) -> Shards:
    """Every partition's valid rows on every local shard: one all-gather
    of the row counts, one of the packed rows (K12) and one of the float64
    columns, then one compaction of the shards' valid prefixes (K5) and
    the unpack (K12). Local shards that receive the same tensors (in
    process) share one result."""
    t0 = shards[0]
    cap, schema = t0.capacity, t0.schema
    nr = uncounted(ex.all_gather, [t.num_rows.reshape(1) for t in shards], 0)
    pts = [pack_table(t) for t in shards]
    layout = pts[0].layout
    words = ex.all_gather([pt.packed for pt in pts], 1)
    f64 = (ex.all_gather([f64_matrix(pt) for pt in pts], 1) if layout.f64_fields
           else [f64_matrix(pts[0]).new_empty((0, ex.P * cap))] * len(shards))
    out, done = [], {}
    for n_k, w, f in zip(nr, words, f64):
        key = (id(n_k), id(w), id(f))
        if key not in done:
            row = torch.arange(cap, dtype=torch.int32, device=w.device)
            mask = (row[None, :] < n_k[:, None]).reshape(ex.P * cap)
            packed = PackedTable(w, dict(zip(layout.f64_fields, f)), layout)
            (cpt,), n = compact_rows([packed], mask, ex.P * cap)
            done[key] = unpack_table(cpt, schema, n)
        out.append(done[key])
    return out


def gather_shards(ex: Exchange, shards: Shards) -> HostTable:
    """Every partition's valid rows in one host table, on every process:
    the local shards are concatenated on the device (K11, at most
    MAX_PARTS parts a launch), across processes all-gathered first."""
    if len(shards) < ex.P:
        return all_gather_table(ex, shards)[0].to_host()
    parts = list(shards)
    while len(parts) > 1:
        parts = [concat_tables(parts[i:i + MAX_PARTS]) for i in range(0, len(parts), MAX_PARTS)]
    return parts[0].to_host()
