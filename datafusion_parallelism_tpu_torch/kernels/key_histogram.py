"""K19 key_histogram: the 256-bucket histogram of the row hashes' top 8
bits over the rows in a mask.

Replaces the JAX package's `bucket_of` and the local scatter-add of
`key_histogram` (parallel/skew.py:42-58); the psum over the mesh is the
exchange's all_reduce. The CUDA kernel is `csrc/key_histogram.cu`, whose
header says what bounds it on the H100; the plain version below is the
same function in torch ops. On CPU tensors the wrapper runs the plain
version; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from .dest_pack import bucket_of

BINS = 256


def key_histogram_plain(hashes: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """int32 [256]: how many rows in `mask` fall in each bucket_of(hash)."""
    return torch.bincount(bucket_of(hashes)[mask].long(), minlength=BINS).to(torch.int32)


def check_args(hashes: torch.Tensor, mask: torch.Tensor) -> int:
    """The wrapper's checks before a launch; returns the row count."""
    n = hashes.shape[0] if hashes.dim() == 1 else -1
    _build.require(hashes, "hashes", torch.int32, (n,))
    _build.require(mask, "mask", torch.bool, (n,), hashes.device)
    return n


def key_histogram(hashes: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """key_histogram_plain's contract; launches K19 for CUDA tensors."""
    if not hashes.is_cuda:
        return key_histogram_plain(hashes, mask)
    n = check_args(hashes, mask)
    hist = torch.empty(BINS, dtype=torch.int32, device=hashes.device)
    fn = _build.function("dfp_key_histogram", (_build.P, _build.P, _build.I64, _build.P,
                                               _build.P))
    err = fn(hashes.data_ptr(), mask.data_ptr(), n, hist.data_ptr(),
             _build.stream(hashes.device))
    key_histogram.launches += 1
    _build.check(err, "key_histogram")
    return hist


key_histogram.launches = 0
