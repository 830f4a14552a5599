"""K17 expr_eval: fused evaluation of compiled expression programs.

Replaces the JAX package's elementwise expression evaluation,
`ops/expressions.py:84-325` (`Col`, `Lit`, `BinOp`, `Not`, `IsNull`, `Cast`,
`InCodes`, `Case`, `ExtractDatePart`, `Coalesce` `.eval`) and
`models/planner.py:85` (`DictMap.eval`), which XLA fuses into one loop per
jitted program. `ops/expressions.py::compile_exprs` turns expression trees
into a `Program`: a flat list of typed instructions over per-row registers,
each holding an 8-byte value and a validity bit. The CUDA kernel is
`csrc/expr_eval.cu`, whose header says what bounds it on the H100 (the
bytes of the columns it reads and the outputs it writes) and how it
interprets the program over tiles of rows, its registers in shared memory
(`plan_tile` below sizes the tile); `expr_eval_plain` below runs the same
program one instruction at a time with the torch ops of the trees'
`.eval`. On CPU tensors the wrapper runs the plain version; on CUDA tensors
it launches the kernel or raises.

An instruction is eight int32: (op, dt, dst, a, b, c, imm lo, imm hi).
`dt` is the result's register type (DT_*); a, b, c are registers (or a
column, a scalar slot, a type code or a flag, per op); imm is a 64-bit
literal (the bits of a CONST, or a table's offset << 32 | length).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

# register types
DT_BOOL, DT_I32, DT_I64, DT_F32, DT_F64 = range(5)
DTYPES = (torch.bool, torch.int32, torch.int64, torch.float32, torch.float64)
DT_OF = {d: i for i, d in enumerate(DTYPES)}

# ops
(COL, CONST, SCALAR, CAST, EQ, NE, LT, LE, GT, GE, ADD, SUB, MUL, IDIV, FDIV, MOD, AND, OR,
 NOT, ISNULL, INSET, SELECT, COALESCE, DATEPART, LUT, ROUND) = range(26)
CMP_OPS = (EQ, NE, LT, LE, GT, GE)
# the register operands each op reads
READS = {**{op: () for op in (COL, CONST, SCALAR)},
         **{op: ("a",) for op in (CAST, NOT, ISNULL, INSET, DATEPART, LUT, ROUND)},
         **{op: ("a", "b") for op in (*CMP_OPS, ADD, SUB, MUL, IDIV, FDIV, MOD, AND, OR,
                                      COALESCE)},
         SELECT: ("a", "b", "c")}

MAX_CODE, MAX_REGS, MAX_COLS, MAX_OUTS, MAX_SCALARS = 256, 64, 64, 32, 8
_M32 = 0xFFFFFFFF

# the kernel's tiles: BLOCK threads a block, DEC_BYTES a decoded instruction
# (csrc/expr_eval.cu `Dec`), at most MAX_TILE rows a tile, sized so that
# TILE_BLOCKS blocks share an SM's shared memory where they can (each block
# also holds BLOCK_RESERVE bytes the runtime keeps)
BLOCK, DEC_BYTES, MAX_TILE, TILE_BLOCKS, BLOCK_RESERVE = 256, 72, 4096, 3, 1024


def smem_bytes(n_regs: int, n_code: int, n_roots: int, tile: int) -> int:
    """The dynamic shared memory of a launch (csrc/expr_eval.cu
    `smem_bytes`), each part 16-byte aligned: n_regs columns of `tile`
    8-byte values and one uniform slot per instruction; their 32-bit
    validity words (one per register and 32 rows, one per instruction) and
    a scratch word per 32 rows; one decoded instruction per instruction and
    per root."""
    values = (8 * (n_regs * tile + n_code) + 15) // 16 * 16
    words = (4 * ((n_regs + 1) * (tile // 32) + n_code) + 15) // 16 * 16
    return values + words + (n_code + n_roots) * DEC_BYTES


@functools.lru_cache(maxsize=None)
def plan_tile(n_regs: int, n_code: int, n_roots: int, block_limit: int,
              sm_limit: int) -> Tuple[int, int]:
    """(rows a tile, dynamic shared memory bytes) of a launch: the largest
    multiple of BLOCK up to MAX_TILE whose shared memory lets TILE_BLOCKS
    blocks share an SM (`sm_limit` bytes), else one row a thread (BLOCK
    rows), which must fit the `block_limit` a block may opt into."""
    budget = min(block_limit, sm_limit // TILE_BLOCKS - BLOCK_RESERVE)
    tile = MAX_TILE
    while tile > BLOCK and smem_bytes(n_regs, n_code, n_roots, tile) > budget:
        tile -= BLOCK
    need = smem_bytes(n_regs, n_code, n_roots, tile)
    if need > block_limit:
        raise ValueError(f"expr_eval: {n_regs} registers and {n_code} instructions need {need} "
                         f"bytes of shared memory at {tile} rows a tile; the device grants "
                         f"{block_limit}")
    return tile, need


@dataclass
class Program:
    """A compiled expression program (ops/expressions.py::compile_exprs).

    code: int32 [n, 8] instructions; n_regs: registers it uses; cols: the
    columns COL reads, by index; roots: (register, torch dtype) of each
    output; tables: int64 code sets (InCodes) and LUTs (DictMap); scalars:
    the ScalarValue nodes whose literal a SCALAR reads at each launch."""
    code: np.ndarray
    n_regs: int
    cols: Tuple[str, ...]
    roots: Tuple[Tuple[int, torch.dtype], ...]
    tables: np.ndarray
    scalars: Tuple[object, ...] = ()
    _device: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = field(default_factory=dict,
                                                                  repr=False)

    def device_arrays(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(code, tables) on `device`, uploaded once per device."""
        key = str(device)
        if key not in self._device:
            self._device[key] = (torch.from_numpy(self.code).to(device),
                                 torch.from_numpy(self.tables).to(device))
        return self._device[key]


def literal_bits(value, dtype: torch.dtype) -> int:
    """The register bits of `torch.full((n,), value, dtype=dtype)`'s
    elements (what `Lit.eval` makes): floats as their IEEE bits, the rest as
    integers (bool 0/1)."""
    x = torch.full((1,), value, dtype=dtype)
    if dtype == torch.float32:
        return int(x.view(torch.int32)[0]) & _M32
    if dtype == torch.float64:
        return int(x.view(torch.int64)[0])
    return int(x[0])


def _imm(ins) -> int:
    v = (int(ins[7]) << 32) | (int(ins[6]) & _M32)
    return v - (1 << 64) if v >= 1 << 63 else v


def _from_bits(bits: int, dtype: torch.dtype, n: int, device) -> torch.Tensor:
    if dtype == torch.float32:
        b = bits - (1 << 32) if bits >= 1 << 31 else bits
        return torch.full((n,), b, dtype=torch.int32, device=device).view(torch.float32)
    if dtype == torch.float64:
        return torch.full((n,), bits, dtype=torch.int64, device=device).view(torch.float64)
    return torch.full((n,), bits, dtype=dtype, device=device)


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _date_part(v: torch.Tensor, part: int) -> torch.Tensor:
    """ExtractDatePart.eval's civil-calendar algorithm on int32 days."""
    z = v + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524) - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(y.dtype)
    return (y, m, d)[part].to(torch.int32)


_CMP = {EQ: torch.eq, NE: torch.ne, LT: torch.lt, LE: torch.le, GT: torch.gt, GE: torch.ge}


def _device(columns, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    return columns[0][0].device if columns else torch.device("cpu")


def expr_eval_plain(program: Program, columns: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                    n: int, scalars: Sequence[Tuple[int, bool]], mask=None, device=None):
    """Run `program` over n rows on `device` (the columns' by default), one
    instruction at a time in torch ops. `columns`: (values, validity) of
    program.cols; `scalars`: (bits, valid) of each SCALAR slot. Without
    `mask`: [(values, validity)] of each root. With mask = (num_rows or
    None, and_mask or None): the bool [n] mask valid & value of the one
    root, False at rows >= num_rows and where and_mask is False."""
    dev = _device(columns, device)
    tables = torch.from_numpy(program.tables).to(dev)
    regs: List[Optional[Tuple[torch.Tensor, torch.Tensor]]] = [None] * program.n_regs
    for ins in program.code:
        op, dt, dst, a, b, c = (int(x) for x in ins[:6])
        dd = DTYPES[dt]
        if op == COL:
            out = columns[a]
        elif op in (CONST, SCALAR):
            bits, ok = (_imm(ins), bool(b)) if op == CONST else scalars[a]
            if not ok:
                bits = 0
            out = (_from_bits(bits, dd, n, dev),
                   (torch.ones if ok else torch.zeros)(n, dtype=torch.bool, device=dev))
        elif op == CAST:
            out = (regs[a][0].to(dd), regs[a][1])
        elif op in CMP_OPS:
            out = (_CMP[op](regs[a][0], regs[b][0]), regs[a][1] & regs[b][1])
        elif op in (ADD, SUB, MUL):
            x, y = regs[a][0], regs[b][0]
            out = (x + y if op == ADD else x - y if op == SUB else x * y,
                   regs[a][1] & regs[b][1])
        elif op == IDIV:
            (x, vx), (y, vy) = regs[a], regs[b]
            nz = y != 0
            q = torch.div(x, torch.where(nz, y, 1), rounding_mode="floor")
            valid = vx & vy
            out = (torch.where(valid & nz, q, 0), valid & nz)
        elif op == FDIV:
            (x, vx), (y, vy) = regs[a], regs[b]
            nz = y != 0
            out = (x / torch.where(nz, y, 1.0), vx & vy & nz)
        elif op == MOD:
            (x, vx), (y, vy) = regs[a], regs[b]
            nz = y != 0
            out = (torch.remainder(x, torch.where(nz, y, 1)), vx & vy & nz)
        elif op in (AND, OR):
            (lb, lval), (rb, rval) = regs[a], regs[b]
            la = torch.where(lval, lb, op == AND)
            ra = torch.where(rval, rb, op == AND)
            if op == AND:
                out = (la & ra, (lval & rval) | (lval & ~lb) | (rval & ~rb))
            else:
                out = (la | ra, (lval & rval) | (lval & lb) | (rval & rb))
        elif op == NOT:
            out = (~regs[a][0], regs[a][1])
        elif op == ISNULL:
            valid = regs[a][1]
            out = (valid if b else ~valid, torch.ones_like(valid))
        elif op == INSET:
            imm = _imm(ins)
            off, cnt = imm >> 32, imm & _M32
            codes = tables[off:off + cnt]
            x = regs[a][0]
            if x.is_floating_point():
                codes = codes.view(torch.float64).to(x.dtype)
            else:
                codes = codes.to(x.dtype)
            member = torch.isin(x, codes)
            out = (~member if b else member, regs[a][1])
        elif op == SELECT:
            (hv, hvalid), (x, vx), (y, vy) = regs[a], regs[b], regs[c]
            hit = hvalid & hv
            out = (torch.where(hit, x, y), torch.where(hit, vx, vy))
        elif op == COALESCE:
            (x, vx), (y, vy) = regs[a], regs[b]
            out = (torch.where(vx, x, y), vx | vy)
        elif op == DATEPART:
            out = (_date_part(regs[a][0], b), regs[a][1])
        elif op == LUT:
            imm = _imm(ins)
            lut = tables[imm >> 32:(imm >> 32) + (imm & _M32)].to(torch.int32)
            out = (lut[regs[a][0].clamp(0, lut.shape[0] - 1)], regs[a][1])
        elif op == ROUND:
            out = (torch.round(regs[a][0]), regs[a][1])
        else:
            raise ValueError(f"unknown op {op}")
        regs[dst] = out
    if mask is None:
        return [regs[r] for r, _ in program.roots]
    num_rows, and_mask = mask
    v, valid = regs[program.roots[0][0]]
    m = valid & v.to(torch.bool)
    if num_rows is not None:
        m = m & (torch.arange(n, dtype=torch.int32, device=dev) < num_rows)
    if and_mask is not None:
        m = m & and_mask
    return m


class _ColRef(ctypes.Structure):
    _fields_ = [("values", ctypes.c_void_p), ("valid", ctypes.c_void_p), ("dt", ctypes.c_int),
                ("pad", ctypes.c_int)]


class _OutRef(ctypes.Structure):
    _fields_ = [("values", ctypes.c_void_p), ("valid", ctypes.c_void_p), ("reg", ctypes.c_int),
                ("dt", ctypes.c_int)]


class _Params(ctypes.Structure):
    """csrc/expr_eval.cu's Params, field for field."""
    _fields_ = [("code", ctypes.c_void_p), ("tables", ctypes.c_void_p),
                ("num_rows", ctypes.c_void_p), ("and_mask", ctypes.c_void_p),
                ("mask_out", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("n_code", ctypes.c_int), ("n_out", ctypes.c_int), ("mask_reg", ctypes.c_int),
                ("n_regs", ctypes.c_int), ("tile", ctypes.c_int), ("pad", ctypes.c_int),
                ("scalar_bits", ctypes.c_longlong * MAX_SCALARS),
                ("scalar_valid", ctypes.c_int * MAX_SCALARS),
                ("cols", _ColRef * MAX_COLS), ("outs", _OutRef * MAX_OUTS)]


def expr_eval(program: Program, columns: Sequence[Tuple[torch.Tensor, torch.Tensor]], n: int,
              scalars: Sequence[Tuple[int, bool]], mask=None, device=None):
    """expr_eval_plain's contract; launches K17 on a CUDA device, in tiles
    that `plan_tile` sizes from the program and the device's shared memory.
    The program's instructions and tables reach the card once per program;
    everything a launch names rides by value in the kernel's parameters."""
    dev = _device(columns, device)
    if dev.type != "cuda":
        return expr_eval_plain(program, columns, n, scalars, mask, device)
    return _launch(program, columns, n, scalars, mask, dev)


def _launch(program: Program, columns, n: int, scalars, mask, dev: torch.device,
            tile: Optional[int] = None):
    """One K17 launch over tiles of `tile` rows: plan_tile's, or another
    where a measurement compares them."""
    if len(program.code) > MAX_CODE or program.n_regs > MAX_REGS:
        raise ValueError(f"expr_eval takes {MAX_CODE} instructions over {MAX_REGS} registers, "
                         f"got {len(program.code)} over {program.n_regs}")
    if (len(columns) != len(program.cols) or len(columns) > MAX_COLS
            or len(program.roots) > MAX_OUTS or len(scalars) > MAX_SCALARS):
        raise ValueError("expr_eval: columns, roots or scalars out of range")
    if tile is None:
        limits = _build.device_limits(dev)
        tile = plan_tile(max(program.n_regs, 1), len(program.code),
                         1 if mask is not None else len(program.roots), limits.smem_block,
                         limits.smem_sm)[0]
    p = _Params()
    code, tables = program.device_arrays(dev)
    p.code, p.tables, p.n, p.n_code = code.data_ptr(), tables.data_ptr(), n, len(program.code)
    p.n_regs, p.tile = program.n_regs, tile
    for k, (v, valid) in enumerate(columns):
        if v.dtype not in DT_OF:
            raise TypeError(f"expr_eval: column {program.cols[k]} of dtype {v.dtype}")
        _build.require(v, f"column {program.cols[k]}", v.dtype, (n,), dev)
        _build.require(valid, f"validity {program.cols[k]}", torch.bool, (n,), dev)
        p.cols[k] = _ColRef(v.data_ptr(), valid.data_ptr(), DT_OF[v.dtype], 0)
    for k, (bits, ok) in enumerate(scalars):
        p.scalar_bits[k], p.scalar_valid[k] = (bits if ok else 0), int(bool(ok))
    outs = []
    if mask is None:
        for k, (reg, dtype) in enumerate(program.roots):
            outs.append((torch.empty(n, dtype=dtype, device=dev),
                         torch.empty(n, dtype=torch.bool, device=dev)))
            p.outs[k] = _OutRef(outs[-1][0].data_ptr(), outs[-1][1].data_ptr(), reg,
                                DT_OF[dtype])
        p.n_out = len(outs)
    else:
        num_rows, and_mask = mask
        if len(program.roots) != 1:
            raise ValueError("expr_eval's mask mode takes one root")
        out = torch.empty(n, dtype=torch.bool, device=dev)
        if num_rows is not None:
            _build.require(num_rows, "num_rows", torch.int32, (), dev)
            p.num_rows = num_rows.data_ptr()
        if and_mask is not None:
            _build.require(and_mask, "and_mask", torch.bool, (n,), dev)
            p.and_mask = and_mask.data_ptr()
        p.mask_out, p.mask_reg = out.data_ptr(), program.roots[0][0]
    fn = _build.function("dfp_expr_eval", (ctypes.POINTER(_Params), _build.P))
    err = fn(ctypes.byref(p), _build.stream(dev))
    expr_eval.launches += 1
    _build.check(err, "expr_eval")
    return outs if mask is None else out


expr_eval.launches = 0
