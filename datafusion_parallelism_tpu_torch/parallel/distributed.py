"""Distributed hash join over an Exchange.

Counterpart of the JAX package's `parallel/distributed.py`, with its three
modes:

  * partitioned: both sides shuffled by key hash, then each partition
    joins its hash range (every join type: each key lives on exactly one
    partition);
  * broadcast: the build side all-gathered to every partition, the probe
    side stays put (probe-driven join types only);
  * skew_salted: a histogram of the probe keys finds heavy hash buckets;
    heavy build rows go to every partition, heavy probe rows stay, the
    rest shuffle by hash (probe-driven join types only).

Each partition then runs the single-device `hash_join` under the config's
strategy. `distributed_hash_join` owns the grow-and-retry loop with the
JAX package's capacity rules: send capacities start at the shard
capacity and double while rows are dropped, out_cap grows to
round_capacity(total). It returns the config it ended with, equal to the
JAX package's for the same inputs.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import torch

from ..ops.hash_table import JoinStrategy
from ..ops.join import JoinType, hash_join
from ..utils.columnar import DeviceTable, HostTable, round_capacity
from .exchange import Exchange
from .shuffle import (KERNELS, DistKernels, _hashes, all_gather_table, gather_shards,
                      local_shards, partition_table, replicating_shuffle, shuffle_by_hash)
from .skew import heavy_buckets, key_histogram

Shards = List[DeviceTable]
_log = logging.getLogger(__name__)


@dataclass(frozen=True)
class DistJoinConfig:
    mode: str = "partitioned"            # partitioned | broadcast | skew_salted
    join_type: JoinType = JoinType.INNER
    strategy: JoinStrategy = JoinStrategy.CSR
    build_send_cap: int = 1024           # per-destination send block (rows)
    probe_send_cap: int = 1024
    out_cap: int = 4096                  # per-partition join candidate capacity
    skew_factor: float = 8.0

    def probe_driven(self) -> bool:
        return self.join_type in (JoinType.INNER, JoinType.RIGHT,
                                  JoinType.RIGHT_SEMI, JoinType.RIGHT_ANTI)


def dist_join_shard(ex: Exchange, builds: Shards, probes: Shards, build_keys: List[str],
                    probe_keys: List[str], cfg: DistJoinConfig,
                    kernels: DistKernels = KERNELS
                    ) -> Tuple[Shards, torch.Tensor, torch.Tensor]:
    """One distributed join step over the local shards: (the local result
    shards, the candidate total's max over the partitions, the dropped
    rows summed over them). total > out_cap or dropped > 0 means the
    caller grows the capacities and runs it again."""
    dev = builds[0].device
    dropped = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.mode == "broadcast":
        if not cfg.probe_driven():
            raise ValueError(f"broadcast join invalid for {cfg.join_type}")
        b, p = all_gather_table(ex, builds), probes
    elif cfg.mode == "skew_salted":
        if not cfg.probe_driven():
            raise ValueError(f"salted join invalid for {cfg.join_type}")
        # each probe shard hashed once, for the histogram and the shuffle
        hashes = [_hashes(t, probe_keys) for t in probes]
        hist = key_histogram(ex, probes, probe_keys, kernels=kernels, hashes=hashes)
        heavy = heavy_buckets(hist, cfg.skew_factor)
        b, d1 = replicating_shuffle(ex, builds, build_keys, cfg.build_send_cap,
                                    kernels=kernels, heavy=heavy)
        p, d2 = shuffle_by_hash(ex, probes, probe_keys, cfg.probe_send_cap, heavy=heavy,
                                kernels=kernels, hashes=hashes)
        dropped = d1 + d2
    elif cfg.mode == "partitioned":
        b, d1 = shuffle_by_hash(ex, builds, build_keys, cfg.build_send_cap, kernels=kernels)
        p, d2 = shuffle_by_hash(ex, probes, probe_keys, cfg.probe_send_cap, kernels=kernels)
        dropped = d1 + d2
    else:
        raise ValueError(f"unknown distributed join mode {cfg.mode!r}")
    outs, totals = [], []
    for bk, pk in zip(b, p):
        out, total = hash_join(bk, pk, build_keys, probe_keys, cfg.join_type, cfg.out_cap,
                               strategy=cfg.strategy)
        outs.append(out)
        totals.append(total.to(torch.int64).reshape(()))
    return outs, ex.all_reduce(totals, "max")[0], dropped


def distributed_hash_join(mesh: Exchange, build: HostTable, probe: HostTable,
                          build_keys: List[str], probe_keys: List[str],
                          cfg: Optional[DistJoinConfig] = None,
                          kernels: DistKernels = KERNELS
                          ) -> Tuple[HostTable, DistJoinConfig]:
    """Partition both tables over the mesh, join, grow and run again on an
    overflow: (the result on the host, the config it ended with; callers
    running the same shapes again reuse it). Each retry is logged at INFO
    on this module's logger, with the grown config."""
    cfg = cfg or DistJoinConfig()
    P = mesh.P
    bcols, bnum, bschema, bcap = partition_table(build, P)
    pcols, pnum, pschema, pcap = partition_table(probe, P)
    # capacities from the actual shard sizes, as the JAX package's
    if cfg.build_send_cap < bcap:
        cfg = replace(cfg, build_send_cap=bcap)
    if cfg.probe_send_cap < pcap:
        cfg = replace(cfg, probe_send_cap=pcap)
    builds = local_shards(mesh, bschema, bcols, bnum)
    probes = local_shards(mesh, pschema, pcols, pnum)
    while True:
        outs, total, dropped = dist_join_shard(mesh, builds, probes, build_keys, probe_keys,
                                               cfg, kernels)
        total, dropped = int(total), int(dropped)
        if dropped > 0:
            del outs
            cfg = replace(cfg, build_send_cap=2 * cfg.build_send_cap,
                          probe_send_cap=2 * cfg.probe_send_cap)
            _log.info("dropped retry: %d rows dropped, send caps -> %d/%d", dropped,
                      cfg.build_send_cap, cfg.probe_send_cap)
            continue
        if total > cfg.out_cap:
            del outs
            cfg = replace(cfg, out_cap=round_capacity(total))
            _log.info("out_cap retry: %d candidates, out_cap -> %d", total, cfg.out_cap)
            continue
        return gather_shards(mesh, outs), cfg
