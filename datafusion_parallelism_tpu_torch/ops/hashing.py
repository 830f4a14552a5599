"""Deterministic vectorized row hashing (torch).

Counterpart of `datafusion_parallelism_tpu/ops/hashing.py`: a murmur3 fmix32
finalizer per key column, a boost-style combine across columns, and a
reserved hash for NULL keys. The hashes are bit-identical to the JAX
package's, so a table built by one package can be probed by the other.

The plain version computes in int64 holding uint32 values: CPU torch has no
`>>` on uint32, and a 32x32-bit product is split so that no intermediate
reaches 2^63. A hash leaves this module as int32 holding the uint32 bits.
`hash_rows` goes through kernel K1's wrapper (kernels/hash_slot.py): the
CUDA kernel on CUDA tensors, the plain version built on this module's
primitives on CPU tensors.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..utils.columnar import int64_words

SEED = 0x9747B28C
# hash value reserved for NULL keys; equality recheck keeps nulls from matching
NULL_HASH = 0xDEADBEEF
_M32 = 0xFFFFFFFF

# key-column kinds as the hash sees them: one int word, two int words
# (lo, hi), one float32 word, two float64 words
KIND_I32, KIND_I64, KIND_F32, KIND_F64 = 0, 1, 2, 3


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 `a` in [0, 2^32) and a 32-bit constant."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def _u32(w: torch.Tensor) -> torch.Tensor:
    return w.long() & _M32


def hash_words(words: Sequence[torch.Tensor], kind: int) -> torch.Tensor:
    """u32 hash (in int64) of one key column given as its int32 words."""
    if kind == KIND_I32:
        return _fmix32(_u32(words[0]))
    if kind == KIND_F32:
        w = _u32(words[0])
        # canonicalize -0.0 == 0.0
        return _fmix32(torch.where((w & 0x7FFFFFFF) == 0, 0, w))
    lo, hi = _u32(words[0]), _u32(words[1])
    if kind == KIND_F64:
        zero = (lo == 0) & ((hi & 0x7FFFFFFF) == 0)
        hi = torch.where(zero, 0, hi)
    return _fmix32(lo ^ _mul32(_fmix32(hi), 0x9E3779B1))


def column_words(values: torch.Tensor) -> Tuple[List[torch.Tensor], int]:
    """(int32 words, kind) of a numeric column, the form K1 hashes."""
    dt = values.dtype
    if dt in (torch.int32, torch.bool):
        return [values.to(torch.int32)], KIND_I32
    if dt == torch.float32:
        return [values.view(torch.int32)], KIND_F32
    if dt == torch.int64:
        return list(int64_words(values)), KIND_I64
    if dt == torch.float64:
        return list(int64_words(values.view(torch.int64))), KIND_F64
    raise TypeError(f"unhashable column dtype {dt}")


def combine(h: torch.Tensor, hv: torch.Tensor) -> torch.Tensor:
    """boost::hash_combine-style mixing, uint32 (held in int64)."""
    return h ^ ((hv + 0x9E3779B9 + ((h << 6) & _M32) + (h >> 2)) & _M32)


def key_words(columns: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
    """Key columns -> (words [Wk + C, n] int32, cols), the input of K1: each
    column's words, then each column's validity as a 0/1 word row; `cols`
    names each column's kind, word rows and validity (row, bit)."""
    words, parts = [], []
    for values, _ in columns:
        w, kind = column_words(values)
        parts.append((kind, tuple(range(len(words), len(words) + len(w)))))
        words += w
    cols = [(kind, rows, (len(words) + c, 0)) for c, (kind, rows) in enumerate(parts)]
    words += [valid.to(torch.int32) for _, valid in columns]
    return torch.stack(words).contiguous(), cols


def hash_rows(columns: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
    """Hash rows over (values, validity) key columns -> int32[cap] holding
    the uint32 hash bits.

    NULL keys get a reserved hash; they can land in a bucket but the equality
    recheck (which requires both sides valid) rejects any match.
    """
    if len(columns) < 1:
        raise ValueError("hash_rows needs at least one key column")
    # imported here: the kernel module builds its plain version on this
    # module's primitives
    from ..kernels.hash_slot import hash_slot
    return hash_slot(*key_words(columns))[0]
