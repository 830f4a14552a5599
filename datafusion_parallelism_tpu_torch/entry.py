"""The port's twin of the JAX package's `__graft_entry__.entry()`: the
flagship single-device step, an INNER hash join plus a sum over its output,
on the same seed-0 data and sizes."""

from __future__ import annotations

import numpy as np
import torch

from .ops.join import JoinType, hash_join
from .utils.columnar import HostTable


def make_tables(rng: np.random.Generator, n_build: int, n_probe: int, key_range: int,
                *, device):
    """Uniform int32 keys in [0, key_range) and float32 values, in the
    order `__graft_entry__.entry()` draws them."""
    build = HostTable.from_numpy({
        "b_key": rng.integers(0, key_range, n_build).astype(np.int32),
        "b_val": rng.random(n_build).astype(np.float32),
    }).to_device(device=device)
    probe = HostTable.from_numpy({
        "p_key": rng.integers(0, key_range, n_probe).astype(np.int32),
        "p_val": rng.random(n_probe).astype(np.float32),
    }).to_device(device=device)
    return build, probe


def entry(device="cuda"):
    """(step, (build, probe)): step(build, probe) -> (sum of p_val over the
    join's output rows, candidate total)."""
    n_build, n_probe = 512, 1024
    build, probe = make_tables(np.random.default_rng(0), n_build, n_probe, 256,
                               device=device)
    out_cap = 4 * n_probe

    def step(build, probe):
        out, total = hash_join(build, probe, ["b_key"], ["p_key"],
                               JoinType.INNER, out_cap)
        v, valid = out.column("p_val")
        s = torch.where(valid & out.row_mask(), v, 0.0).sum()
        return s, total

    return step, (build, probe)
