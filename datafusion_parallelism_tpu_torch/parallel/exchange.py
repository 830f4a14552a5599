"""The seam between the distributed operators and the devices: an
`Exchange` holds P partitions and the collectives the shuffle and the
distributed join use (JAX's `lax.all_to_all`, tiled `lax.all_gather`,
`lax.psum`, `lax.pmax` over the mesh axis).

The JAX package runs one program per device under `shard_map`. The port
writes each step over the sequence of the partitions this process holds,
its *local shards*, and the collectives take and return one tensor per
local shard:

  * `InProcessExchange(P, device)`: all P shards on one device (the card,
    or the CPU for the tests). An all-to-all is one block transpose, an
    all-gather one concatenation, a reduction one sum or max. It is a copy
    on one device, not a link between devices.
  * `ProcessGroupExchange(device)`: L shards per process over an
    initialised `torch.distributed` process group (NCCL between GPUs, gloo
    between CPU processes), P = world size x L; process `pid` holds
    partitions pid * L to pid * L + L - 1 (`parallel/multihost.py` starts
    the group and sets L). Each collective is one call for the L shards:
    their blocks stacked into one `all_to_all_single`, one
    `all_gather_into_tensor`, a local reduction then one `all_reduce`.

Every collective notes the bytes one device receives (`record_comm_bytes`,
the JAX package's comm-bytes counter, parallel/shuffle.py:42-59).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

_COMM_BYTES = [0]


def reset_comm_bytes() -> None:
    _COMM_BYTES[0] = 0


def record_comm_bytes(n: int) -> None:
    _COMM_BYTES[0] += int(n)


def get_comm_bytes() -> int:
    """Bytes received per device by the collectives since the last reset."""
    return _COMM_BYTES[0]


def uncounted(collective, *args):
    """`collective(*args)` left out of the comm bytes: the row counts an
    all-gather of a table moves first, which the JAX package's count
    leaves out too."""
    before = _COMM_BYTES[0]
    try:
        return collective(*args)
    finally:
        _COMM_BYTES[0] = before


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A bool tensor as its bytes: not every backend moves bool."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


class Exchange:
    """P partitions, of which this process holds `ranks` (its local
    shards, in order), on `device`."""

    P: int
    ranks: List[int]
    device: torch.device

    def all_to_all(self, xs: Sequence[torch.Tensor], dim: int) -> List[torch.Tensor]:
        """xs[k] (local shard k) has size P along `dim`: block d goes to
        partition d. Returns what each local shard receives: block s along
        `dim` is the block partition s sent it (lax.all_to_all with
        split_axis = concat_axis = dim)."""
        raise NotImplementedError

    def all_gather(self, xs: Sequence[torch.Tensor], dim: int = 0) -> List[torch.Tensor]:
        """Every partition's tensor, concatenated along `dim` in partition
        order, on every local shard (a tiled lax.all_gather)."""
        raise NotImplementedError

    def all_reduce(self, xs: Sequence[torch.Tensor], op: str = "sum") -> List[torch.Tensor]:
        """The elementwise sum ("sum") or max ("max") over the partitions,
        on every local shard."""
        raise NotImplementedError


class InProcessExchange(Exchange):
    """P shards on one device; the collectives are copies on that device."""

    def __init__(self, P: int, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("InProcessExchange: no CUDA device; pass device='cpu' to run "
                               "the kernels' plain versions on the CPU")
        if P < 1:
            raise ValueError(f"P = {P}")
        self.P = P
        self.ranks = list(range(P))

    def __repr__(self):
        return f"InProcessExchange(P={self.P}, device={self.device})"

    def all_to_all(self, xs, dim):
        record_comm_bytes(_nbytes(xs[0]))
        # out[r] = the blocks r of every source, stacked along dim
        return [torch.stack([x.select(dim, r) for x in xs], dim) for r in range(self.P)]

    def all_gather(self, xs, dim=0):
        record_comm_bytes(_nbytes(xs[0]) * self.P)
        out = torch.cat(list(xs), dim)
        return [out] * self.P

    def all_reduce(self, xs, op="sum"):
        st = torch.stack(list(xs))
        out = st.sum(0, dtype=st.dtype) if op == "sum" else st.amax(0)
        return [out] * self.P


class ProcessGroupExchange(Exchange):
    """`multihost.local_device_count()` shards per process of the default
    `torch.distributed` process group, on `device` (the process's GPU under
    NCCL, the CPU under gloo, when None)."""

    def __init__(self, device=None):
        import torch.distributed as dist

        from .multihost import local_device_count
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupExchange: initialise torch.distributed first")
        self.L = local_device_count()
        self.world = dist.get_world_size()
        self.P = self.world * self.L
        pid = dist.get_rank()
        self.ranks = list(range(pid * self.L, (pid + 1) * self.L))
        if device is None:
            device = ("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" \
                else "cpu"
            device = torch.device(*device) if isinstance(device, tuple) else device
        self.device = torch.device(device)

    def __repr__(self):
        return (f"ProcessGroupExchange(P={self.P}, ranks={self.ranks[0]}-{self.ranks[-1]}, "
                f"device={self.device})")

    def all_to_all(self, xs, dim):
        import torch.distributed as dist
        record_comm_bytes(_nbytes(xs[0]))
        # send[q, s, d]: local shard s's block for partition q * L + d
        blocks = [x.movedim(dim, 0) for x in xs]
        rest = tuple(blocks[0].shape[1:])
        send = torch.stack(blocks).reshape((self.L, self.world, self.L) + rest)
        send = send.transpose(0, 1).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(_wire(recv), _wire(send))
        # recv[q, s, d]: what partition q * L + s sent local shard d
        return [recv[:, :, d].reshape((self.P,) + rest).movedim(0, dim).contiguous()
                for d in range(self.L)]

    def all_gather(self, xs, dim=0):
        import torch.distributed as dist
        record_comm_bytes(_nbytes(xs[0]) * self.P)
        send = torch.cat([x.movedim(dim, 0) for x in xs]).contiguous()
        out = torch.empty((self.world * send.shape[0],) + tuple(send.shape[1:]),
                          dtype=send.dtype, device=send.device)
        dist.all_gather_into_tensor(_wire(out), _wire(send))
        out = out.movedim(0, dim).contiguous()
        return [out] * self.L

    def all_reduce(self, xs, op="sum"):
        import torch.distributed as dist
        st = torch.stack(list(xs))
        out = st.sum(0, dtype=st.dtype) if op == "sum" else st.amax(0)
        dist.all_reduce(out, dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX)
        return [out] * self.L
