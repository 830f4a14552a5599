"""The lean launch path of K11's and K13's wrappers, for calls whose host
time is a large share of the whole: the arguments' checks in one pass and
the current stream's handle without building a `torch.cuda.Stream`. (The
wrappers also hold their ctypes entry point in a module-level handle,
resolved at first use.)"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch

Spec = Tuple[torch.Tensor, str, torch.dtype, tuple]


def check(specs: Iterable[Spec], index: int, where: str = "") -> None:
    """Raise unless every (tensor, name, dtype, shape) is on device `index`
    (`get_device()`: -1 for the CPU), of that dtype and shape, and
    contiguous: `_build.require`'s checks and exceptions, in one pass.
    `where` prefixes the names in a message."""
    for t, name, dtype, shape in specs:
        if t.get_device() != index:
            raise ValueError(f"{where}{name}: on {t.device}, expected device {index}")
        if t.dtype != dtype:
            raise TypeError(f"{where}{name}: dtype {t.dtype}, expected {dtype}")
        if t.shape != shape:
            raise ValueError(f"{where}{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{where}{name}: must be contiguous")


def current_stream(index: int) -> int:
    """The current CUDA stream of device `index`, as the C launchers take it."""
    return torch._C._cuda_getCurrentRawStream(index)
