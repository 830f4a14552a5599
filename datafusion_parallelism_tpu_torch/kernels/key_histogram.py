"""K19 key_histogram: per local shard, the 256-bucket histogram of the row
hashes' top 8 bits over the shard's rows, every shard in one launch.

Replaces the JAX package's `bucket_of` and the local scatter-add of
`key_histogram` (parallel/skew.py:42-58) over its row mask; the psum over
the mesh is the exchange's all_reduce. The CUDA kernel is
`csrc/key_histogram.cu`, whose header says what bounds it on the H100; the
plain version below is the same function in torch ops. On CPU tensors the
wrapper runs the plain version; on CUDA tensors it launches the kernel or
raises.

A shard is its hashes (int32 [cap], uint32 bits), its row count (int32
0-dim on the device) and, where given, its validity (bool [cap]): the
kernel makes the row mask, `arange(cap) < num_rows` and the validity, from
them, as `DeviceTable.row_mask` does around it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import _build
from .dest_pack import bucket_of

BINS = 256
THREADS = 512       # a block (csrc/key_histogram.cu)
CLUSTER = 16        # blocks of the thread block cluster that counts one shard
MAX_SHARDS = 64     # shard descriptors a launch
PLAN = ("BINS", "THREADS", "CLUSTER", "MAX_SHARDS")

Valid = Optional[Sequence[Optional[torch.Tensor]]]


def compiled_plan() -> dict:
    """PLAN's constants as csrc/key_histogram.cu was built with them
    (builds the kernel), to hold against this module's copies."""
    fn = _build.function("dfp_key_histogram_plan", (_build.I32,), _build.I64)
    return {name: fn(i) for i, name in enumerate(PLAN)}


def row_mask(hashes: torch.Tensor, num_rows: torch.Tensor,
             valid: Optional[torch.Tensor]) -> torch.Tensor:
    """A shard's rows: below its row count, and in `valid` where given."""
    mask = torch.arange(hashes.shape[0], device=hashes.device) < num_rows
    return mask if valid is None else mask & valid


def key_histogram_plain(hashes: Sequence[torch.Tensor], num_rows: Sequence[torch.Tensor],
                        valid: Valid = None) -> torch.Tensor:
    """int32 [S, 256]: row k counts shard k's rows (row_mask) in each
    bucket_of(hash)."""
    valid = valid or [None] * len(hashes)
    return torch.stack([
        torch.bincount(bucket_of(h)[row_mask(h, n, v)].long(), minlength=BINS).to(torch.int32)
        for h, n, v in zip(hashes, num_rows, valid, strict=True)])


# csrc/key_histogram.cu's Spec as int64 words: n (its int and the padding
# after it), then per shard its hash, num_rows and valid pointers and cap
SPEC_WORDS = 1 + 4 * MAX_SHARDS


def check_args(hashes: Sequence[torch.Tensor], num_rows: Sequence[torch.Tensor],
               valid: Valid = None) -> int:
    """The wrapper's checks before a launch; returns the shard count.
    Raises on what the kernel does not take: no shard or more than
    MAX_SHARDS, a capacity of 2^31 rows or more, a row count that is not
    int32 0-dim, tensors on another device than the first hashes."""
    S = len(hashes)
    if not 1 <= S <= MAX_SHARDS:
        raise ValueError(f"{S} shards: one launch takes 1 to {MAX_SHARDS}")
    valid = valid or [None] * S
    if len(num_rows) != S or len(valid) != S:
        raise ValueError(f"{S} shards of hashes, {len(num_rows)} row counts, "
                         f"{len(valid)} validity masks")
    dev = hashes[0].device
    for h, n, v in zip(hashes, num_rows, valid):
        # each tensor tested in one expression (a launch's host time is most
        # of K19's time); _build.require says what failed
        cap = h.shape[0] if h.dim() == 1 else -1
        if not (h.is_cuda and h.device == dev and h.dtype == torch.int32 and cap >= 0
                and h.is_contiguous()):
            _build.require(h, "hashes", torch.int32, (cap,), dev)
        if cap >= 2**31:
            raise ValueError(f"hashes: {cap} rows, at most 2^31 - 1")
        if not (n.is_cuda and n.device == dev and n.dtype == torch.int32 and n.dim() == 0):
            _build.require(n, "num_rows", torch.int32, (), dev)
        if v is not None and not (v.is_cuda and v.device == dev and v.dtype == torch.bool
                                  and v.shape == h.shape and v.is_contiguous()):
            _build.require(v, "valid", torch.bool, (cap,), dev)
    return S


def key_histogram(hashes: Sequence[torch.Tensor], num_rows: Sequence[torch.Tensor],
                  valid: Valid = None) -> torch.Tensor:
    """key_histogram_plain's contract; launches K19 once for CUDA tensors."""
    if not hashes[0].is_cuda:
        return key_histogram_plain(hashes, num_rows, valid)
    S = check_args(hashes, num_rows, valid)
    dev = hashes[0].device
    spec = np.zeros(SPEC_WORDS, dtype=np.int64)
    spec[0] = S
    spec[1:1 + 4 * S] = [x for h, n, v in zip(hashes, num_rows, valid or [None] * S)
                         for x in (h.data_ptr(), n.data_ptr(), 0 if v is None else v.data_ptr(),
                                   h.shape[0])]
    hist = torch.empty((S, BINS), dtype=torch.int32, device=dev)
    fn = _build.function("dfp_key_histogram", (_build.P, _build.P, _build.P))
    err = fn(spec.ctypes.data, hist.data_ptr(), _build.stream(dev))
    key_histogram.launches += 1
    _build.check(err, "key_histogram")
    return hist


key_histogram.launches = 0
