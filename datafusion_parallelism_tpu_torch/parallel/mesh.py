"""The partitions a distributed query runs over.

Counterpart of the JAX package's `parallel/mesh.py`, whose 1-D
`jax.sharding.Mesh` holds one partition per device. The port's mesh is an
`Exchange` (parallel/exchange.py): P partitions on one device, or L per
process of a `torch.distributed` process group (parallel/multihost.py).
"""

from __future__ import annotations

from typing import Optional

from .exchange import Exchange, InProcessExchange, ProcessGroupExchange

# the one mesh axis of the JAX package (the port's collectives name none)
PARTITION_AXIS = "p"


def make_mesh(n_devices: Optional[int] = None, device="cuda", *,
              process_group: bool = False) -> Exchange:
    """An Exchange over `n_devices` partitions: with `process_group`, the
    initialised default process group's (`multihost.local_device_count()`
    partitions per process; world size x that count must equal n_devices
    where given); else all of them
    in-process on `device`, the card unless the caller names the CPU."""
    if process_group:
        ex = ProcessGroupExchange(None if device == "cuda" else device)
        if n_devices is not None and n_devices != ex.P:
            raise ValueError(f"requested {n_devices} partitions, the process group has {ex.P}")
        return ex
    return InProcessExchange(n_devices or 1, device)
