"""Partition-parallel execution: the hash shuffle, skew salting and the
distributed hash join over an Exchange (P partitions on one device, or
one per process of a torch.distributed process group)."""

from .distributed import DistJoinConfig, distributed_hash_join
from .exchange import InProcessExchange, ProcessGroupExchange
from .mesh import PARTITION_AXIS, make_mesh
from .shuffle import gather_shards, partition_table, shuffle_by_hash
from .skew import key_histogram, salted_route

__all__ = [
    "make_mesh", "PARTITION_AXIS",
    "shuffle_by_hash", "partition_table", "gather_shards",
    "distributed_hash_join", "DistJoinConfig",
    "key_histogram", "salted_route",
    "InProcessExchange", "ProcessGroupExchange",
]
