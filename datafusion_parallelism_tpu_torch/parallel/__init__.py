"""Partition-parallel execution: the hash shuffle, skew salting and the
distributed hash join over an Exchange (P partitions on one device, or
several per process of a torch.distributed process group, started by
multihost.init_multihost)."""

from .distributed import DistJoinConfig, distributed_hash_join
from .exchange import InProcessExchange, ProcessGroupExchange
from .mesh import PARTITION_AXIS, make_mesh
from .multihost import init_multihost, shutdown_multihost
from .shuffle import gather_shards, partition_table, shuffle_by_hash
from .skew import key_histogram, salted_route

__all__ = [
    "make_mesh", "PARTITION_AXIS",
    "shuffle_by_hash", "partition_table", "gather_shards",
    "distributed_hash_join", "DistJoinConfig",
    "key_histogram", "salted_route",
    "InProcessExchange", "ProcessGroupExchange",
    "init_multihost", "shutdown_multihost",
]
