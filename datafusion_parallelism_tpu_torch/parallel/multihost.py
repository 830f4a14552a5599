"""The process bootstrap: several processes, each holding several
partitions, running one distributed query.

Counterpart of the JAX package's `parallel/multihost.py`, where
`jax.distributed.initialize` gives every process a slice of one global
device mesh. Here each process joins a `torch.distributed` process group
(NCCL between GPUs, gloo between CPU processes) and holds
`local_device_count` partitions of it: process `pid` holds partitions
`pid * L` to `pid * L + L - 1`, and P = world size x L
(`parallel/exchange.py::ProcessGroupExchange`). After `init_multihost`,
`SessionContext(SessionConfig(target_partitions=P))` runs its queries over
that Exchange; nothing above it knows how the partitions are spread.

JAX's other two pieces have counterparts already: `globalize_tree` (each
process uploads only its own shards of a host table) is
`parallel/shuffle.py::local_shards`, and `allgather_tree` (every process
gets every shard back) is `parallel/shuffle.py::gather_shards`.

Start, per process (the same script in every one, `pid` 0 to N - 1):

    init_multihost("localhost:29500", num_processes=N, process_id=pid,
                   local_device_count=4, backend="gloo")
"""

from __future__ import annotations

from typing import Optional

import torch

_LOCAL = [1]   # the partitions this process holds


def local_device_count() -> int:
    """The partitions each process of the initialised group holds (1 unless
    init_multihost said otherwise)."""
    return _LOCAL[0]


def init_multihost(coordinator_address: str, num_processes: int, process_id: int,
                   local_device_count: Optional[int] = None, backend: str = "nccl") -> None:
    """Join the process group at `coordinator_address` ("host:port", or a
    URL such as "tcp://host:port") as rank `process_id` of `num_processes`,
    holding `local_device_count` partitions (1 when None). Under NCCL the
    process's GPU is cuda:(process_id mod the visible GPUs)."""
    import torch.distributed as dist
    if local_device_count is not None and local_device_count < 1:
        raise ValueError(f"local_device_count = {local_device_count}")
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    kw = {}
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("init_multihost: NCCL needs a CUDA device; pass backend='gloo' "
                               "to run on the CPU")
        device = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id, **kw)
    _LOCAL[0] = local_device_count or 1


def shutdown_multihost() -> None:
    """Leave the process group; the process holds one partition again."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    _LOCAL[0] = 1
