"""K12 pack_rows: a table's columns to and from its packed word matrix.

Replaces the JAX package's `utils/columnar.py:753` `pack_table` and `:783`
`unpack_table`: every column of a table and one validity bit per column in
ONE [W, cap] int32 word-major matrix (`packed_layout`), float64 columns
carried beside it. Every operator that moves whole rows packs its input
and unpacks its output, and every streamed chunk and grace partition
arrives packed from the host. The CUDA kernel is `csrc/pack_rows.cu`,
whose header says what bounds it on the H100; the plain versions below are
the same functions in torch ops. On CPU tensors the wrappers run the plain
versions; on CUDA tensors they launch the kernel or raise.

`pack_rows(layout, cols)`: cols[j] = (values, validity) of layout field j
(a float64 field's values stay out of the words: only its validity bit is
packed) -> packed int32 [W, cap].
`unpack_rows(layout, packed)` -> [(values or None for a float64 field,
validity bool)] per field. The values of int32, date32, string-code and
float32 fields are views of their word row in both versions; int64,
decimal and bool values and every validity are new tensors.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from ..utils.columnar import Kind, PackedLayout
from . import _build

_M32 = 0xFFFFFFFF
# fields per launch: four validity words; a wider table takes one launch
# per 128 fields (each launch writes whole validity words)
MAX_FIELDS = 128
# what the kernel does with a field's values: nothing (float64, or a view
# on unpack), one 32-bit word, two words of an int64, a bool byte
V_NONE, V_I32, V_I64, V_BOOL = 0, 1, 2, 3
Column = Tuple[torch.Tensor, torch.Tensor]


def _value_op(kind: Kind) -> Tuple[int, Optional[torch.dtype]]:
    """(value op, the dtype the kernel reads or writes) of a field kind."""
    if kind is Kind.FLOAT64:
        return V_NONE, None
    if kind in (Kind.INT64, Kind.DECIMAL):
        return V_I64, torch.int64
    if kind is Kind.BOOL:
        return V_BOOL, torch.bool
    if kind is Kind.FLOAT32:
        return V_I32, torch.float32
    return V_I32, torch.int32


def pack_rows_plain(layout: PackedLayout, cols: Sequence[Column]) -> torch.Tensor:
    """The packed [W, cap] int32 matrix of `cols` under `layout`."""
    cap = cols[0][0].shape[0]
    dev = cols[0][0].device
    words = []
    for (name, kind, _, _), (v, _) in zip(layout.fields, cols):
        if kind is Kind.FLOAT64:
            continue
        if kind in (Kind.INT64, Kind.DECIMAL):
            words += [v.to(torch.int32), (v >> 32).to(torch.int32)]
        elif kind is Kind.FLOAT32:
            words.append(v.view(torch.int32))
        else:  # int32/date32/string codes/bool
            words.append(v.to(torch.int32))
    n_fields = len(layout.fields)
    for w in range((n_fields + 31) // 32):
        word = torch.zeros(cap, dtype=torch.int64, device=dev)
        for j in range(w * 32, min((w + 1) * 32, n_fields)):
            word |= cols[j][1].to(torch.int64) << (j - w * 32)
        words.append(word.to(torch.int32))
    return torch.stack(words, dim=0)


def unpack_rows_plain(layout: PackedLayout, packed: torch.Tensor
                      ) -> List[Tuple[Optional[torch.Tensor], torch.Tensor]]:
    """Each field's (values, validity) read back from `packed`; a float64
    field's values are None (they ride beside the words)."""
    out = []
    for j, (_, kind, slot, n) in enumerate(layout.fields):
        if kind is Kind.FLOAT64:
            v = None
        elif n == 2:
            lo = packed[slot].long() & _M32
            hi = packed[slot + 1].long()
            v = (hi << 32) | lo
        elif kind is Kind.FLOAT32:
            v = packed[slot].contiguous().view(torch.float32)
        elif kind is Kind.BOOL:
            v = packed[slot] != 0
        else:
            v = packed[slot]
        word = packed[layout.valid_base + j // 32]
        out.append((v, ((word >> (j % 32)) & 1).to(torch.bool)))
    return out


class FieldC(ctypes.Structure):
    _fields_ = [("values", ctypes.c_void_p), ("valid", ctypes.c_void_p),
                ("op", ctypes.c_int), ("slot", ctypes.c_int)]


class SpecC(ctypes.Structure):
    """One launch's fields, passed by value in the kernel's parameters."""
    _fields_ = [("n", ctypes.c_int), ("valid_row", ctypes.c_int),
                ("f", FieldC * MAX_FIELDS)]


def _launches(layout: PackedLayout):
    """(first field, field count, first validity row) of each launch."""
    n = len(layout.fields)
    for lo in range(0, n, MAX_FIELDS):
        yield lo, min(MAX_FIELDS, n - lo), layout.valid_base + lo // 32


def _check_packed(layout: PackedLayout, packed: torch.Tensor) -> int:
    if packed.dim() != 2 or packed.shape[0] != layout.width:
        raise ValueError(f"packed: expected [{layout.width}, cap], got {tuple(packed.shape)}")
    _build.require(packed, "packed", torch.int32)
    return packed.shape[1]


def pack_rows(layout: PackedLayout, cols: Sequence[Column]) -> torch.Tensor:
    """pack_rows_plain's contract; launches K12's pack for CUDA tensors."""
    if not cols or not cols[0][0].is_cuda:
        return pack_rows_plain(layout, cols)
    if len(cols) != len(layout.fields):
        raise ValueError(f"{len(cols)} columns for {len(layout.fields)} fields")
    dev = cols[0][0].device
    cap = cols[0][0].shape[0]
    keep = []   # converted inputs stay alive until the launches are queued
    packed = torch.empty((layout.width, cap), dtype=torch.int32, device=dev)
    fn = _build.function("dfp_pack_rows", (ctypes.POINTER(SpecC), _build.P, _build.I64,
                                           _build.P))
    for lo, n, valid_row in _launches(layout):
        spec = SpecC(n=n, valid_row=valid_row)
        for k in range(n):
            (_, kind, slot, _), (v, valid) = layout.fields[lo + k], cols[lo + k]
            op, dtype = _value_op(kind)
            valid = valid.to(torch.bool).contiguous()
            _build.require(valid, f"field {lo + k} validity", torch.bool, (cap,), dev)
            keep.append(valid)
            spec.f[k].valid, spec.f[k].op, spec.f[k].slot = valid.data_ptr(), op, max(slot, 0)
            if op != V_NONE:
                v = v.to(dtype).contiguous()
                _build.require(v, f"field {lo + k} values", dtype, (cap,), dev)
                keep.append(v)
                spec.f[k].values = v.data_ptr()
        if cap > 0:
            err = fn(ctypes.byref(spec), packed.data_ptr(), cap, _build.stream(dev))
            pack_rows.launches += 1
            _build.check(err, "pack_rows")
    return packed


def unpack_rows(layout: PackedLayout, packed: torch.Tensor
                ) -> List[Tuple[Optional[torch.Tensor], torch.Tensor]]:
    """unpack_rows_plain's contract; launches K12's unpack for CUDA tensors
    (the word-row views need no kernel)."""
    if not packed.is_cuda:
        return unpack_rows_plain(layout, packed)
    packed = packed.contiguous()
    cap = _check_packed(layout, packed)
    dev = packed.device
    out = []
    for _, kind, slot, _ in layout.fields:
        op, dtype = _value_op(kind)
        if op == V_I32:
            v = packed[slot] if dtype == torch.int32 else packed[slot].view(dtype)
        elif op == V_NONE:
            v = None
        else:
            v = torch.empty(cap, dtype=dtype, device=dev)
        out.append((v, torch.empty(cap, dtype=torch.bool, device=dev)))
    fn = _build.function("dfp_unpack_rows", (ctypes.POINTER(SpecC), _build.P, _build.I64,
                                             _build.P))
    for lo, n, valid_row in _launches(layout):
        spec = SpecC(n=n, valid_row=valid_row)
        for k in range(n):
            (_, kind, slot, _), (v, valid) = layout.fields[lo + k], out[lo + k]
            op, _ = _value_op(kind)
            op = op if op in (V_I64, V_BOOL) else V_NONE
            spec.f[k].valid, spec.f[k].op, spec.f[k].slot = valid.data_ptr(), op, max(slot, 0)
            if op != V_NONE:
                spec.f[k].values = v.data_ptr()
        if cap > 0:
            err = fn(ctypes.byref(spec), packed.data_ptr(), cap, _build.stream(dev))
            unpack_rows.launches += 1
            _build.check(err, "unpack_rows")
    return out


pack_rows.launches = 0
unpack_rows.launches = 0
