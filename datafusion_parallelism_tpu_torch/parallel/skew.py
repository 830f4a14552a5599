"""Skewed-key handling: a histogram of the probe keys' hash buckets, then a
salted repartition.

Counterpart of the JAX package's `parallel/skew.py`: buckets holding more
than `factor` x the mean row count are heavy; build rows in heavy buckets
go to every partition (replicating_shuffle), probe rows in heavy buckets
stay on their own partition, the rest shuffle by hash. The histogram is
one K19 `key_histogram` launch over the local shards plus the exchange's
all-reduce; both routes are K18 `dest_pack`'s heavy-table input:
shuffle_by_hash(heavy=) keeps the heavy probe rows,
replicating_shuffle(heavy=) replicates the heavy build rows. `salted_route` and `build_replication_mask` give the
same routes as tensors, as the JAX package's functions do, for the tests.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..kernels.dest_pack import bucket_of, route_of
from ..utils.columnar import DeviceTable
from .exchange import Exchange
from .shuffle import KERNELS, DistKernels, _hashes, _row_mask

HIST_BITS = 8
HIST_SIZE = 1 << HIST_BITS


def key_histogram(ex: Exchange, shards: Sequence[DeviceTable], keys: List[str],
                  valid: Optional[Sequence[Optional[torch.Tensor]]] = None,
                  kernels: DistKernels = KERNELS,
                  hashes: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """The HIST_SIZE-bucket histogram (int32) of the key hashes over every
    partition's rows (in `valid`, where given). `hashes`: the shards' key
    hashes where the caller made them already."""
    hashes = hashes or [_hashes(t, keys) for t in shards]
    local = kernels.key_histogram(hashes, [t.num_rows for t in shards], valid)
    return ex.all_reduce(list(local))[0]


def heavy_buckets(hist: torch.Tensor, factor: float = 8.0) -> torch.Tensor:
    """bool [HIST_SIZE]: buckets holding more than factor x the mean row
    count, compared in float32 as the JAX package does."""
    mean = hist.sum().to(torch.float32) / HIST_SIZE
    return hist.to(torch.float32) > factor * mean


def salted_route(ex: Exchange, shards: Sequence[DeviceTable], keys: List[str],
                 heavy: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per local shard (dest int32, is_heavy bool) of the probe side: heavy
    rows keep their partition, the others route by hash. (The join runs
    this route inside K18, shuffle_by_hash(heavy=).)"""
    out = []
    for rank, t in zip(ex.ranks, shards):
        h = _hashes(t, keys)
        is_heavy = heavy[bucket_of(h).long()]
        out.append((torch.where(is_heavy, rank, route_of(h, ex.P)).to(torch.int32), is_heavy))
    return out


def build_replication_mask(shards: Sequence[DeviceTable], keys: List[str],
                           heavy: torch.Tensor,
                           valid: Optional[Sequence[Optional[torch.Tensor]]] = None
                           ) -> List[torch.Tensor]:
    """Per local shard, bool [cap]: the build rows (in the shard and in
    `valid`) whose key bucket is heavy, which replicating_shuffle(heavy=)
    sends to every partition."""
    valid = valid or [None] * len(shards)
    return [heavy[bucket_of(_hashes(t, keys)).long()] & _row_mask(t, v)
            for t, v in zip(shards, valid)]
