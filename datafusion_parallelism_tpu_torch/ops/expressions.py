"""Vectorized expression evaluation over device tables (torch).

Counterpart of `datafusion_parallelism_tpu/ops/expressions.py`, with the
same classes, fields and SQL semantics: (values, validity) pairs carry
three-valued logic, comparisons reject NULLs, decimal + - * stay exact in
scaled int64 up to scale 4, division by zero gives NULL, and strings are
dictionary codes (string predicates arrive as `InCodes` code sets).

Each `eval(t)` returns (values, validity, DType) as torch tensors on the
table's device, in plain elementwise torch ops: the reference. The engine
evaluates through `evaluate` and `predicate_mask`, which compile the trees
(each class's `emit`, the same type rules as its `eval`) into one typed
program (`compile_exprs`, cached per tree) and run it through K17
(kernels/expr_eval.py): the kernel on CUDA tables, its plain version, the
program one torch op at a time, on CPU tables.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import expr_eval as k17
from ..utils.columnar import (BOOL, DATE32, DECIMAL, FLOAT64, INT32, INT64,
                              DeviceTable, DType, Field, Kind, Schema)

EvalResult = Tuple[torch.Tensor, torch.Tensor, DType]


def _as_float(vals: torch.Tensor, dt: DType) -> torch.Tensor:
    if dt.kind is Kind.DECIMAL:
        return vals.to(torch.float64) / (10.0 ** dt.scale)
    return vals.to(torch.float64)


def _promote(lv, ldt: DType, rv, rdt: DType):
    """Numeric promotion; decimals and mixed int/float go to float64."""
    if ldt == rdt and ldt.kind is not Kind.DECIMAL:
        return lv, rv, ldt
    num_f = (Kind.FLOAT32, Kind.FLOAT64, Kind.DECIMAL)
    if ldt.kind in num_f or rdt.kind in num_f:
        return _as_float(lv, ldt), _as_float(rv, rdt), FLOAT64
    # integer family (int32/int64/date32)
    wide = torch.promote_types(lv.dtype, rv.dtype)
    out = INT64 if wide == torch.int64 else (
        DATE32 if Kind.DATE32 in (ldt.kind, rdt.kind) else INT32)
    return lv.to(wide), rv.to(wide), out


_MAX_DECIMAL_SCALE = 4


def _decimal_arith(op, lv, ldt: DType, rv, rdt: DType):
    """Exact decimal + - * in the scaled int64 domain; None where the JAX
    package falls back to float64 (division, or a result scale past 4)."""
    kinds = (ldt.kind, rdt.kind)
    ints = (Kind.INT32, Kind.INT64)
    if Kind.DECIMAL not in kinds or op not in ("+", "-", "*"):
        return None
    if not all(k is Kind.DECIMAL or k in ints for k in kinds):
        return None
    ls = ldt.scale if ldt.kind is Kind.DECIMAL else 0
    rs = rdt.scale if rdt.kind is Kind.DECIMAL else 0
    a, b = lv.to(torch.int64), rv.to(torch.int64)
    if op == "*":
        if ls + rs > _MAX_DECIMAL_SCALE:
            return None
        return a * b, DECIMAL(ls + rs)
    s = max(ls, rs)
    if s > _MAX_DECIMAL_SCALE:
        return None
    a, b = a * (10 ** (s - ls)), b * (10 ** (s - rs))
    return (a + b if op == "+" else a - b), DECIMAL(s)


class Expr:
    def eval(self, t: DeviceTable) -> EvalResult:
        raise NotImplementedError

    def emit(self, c: "Compiler") -> Tuple[int, DType]:
        """Append this node's instructions to `c`: (its register, DType)."""
        raise NotImplementedError(f"{type(self).__name__} has no compiled form")

    def __repr__(self):
        return self.__class__.__name__


@dataclass(repr=False)
class Col(Expr):
    name: str

    def eval(self, t):
        v, valid = t.column(self.name)
        return v, valid, t.schema.field(self.name).dtype

    def emit(self, c):
        return c.col(self.name), c.schema.field(self.name).dtype

    def __repr__(self):
        return self.name


@dataclass(repr=False)
class Lit(Expr):
    value: object            # python scalar or None
    dtype: DType
    raw: bool = False        # DECIMAL only: value is already in scaled units

    def eval(self, t):
        cap, dev = t.capacity, t.device
        if self.value is None:
            return (torch.zeros(cap, dtype=self.dtype.device_dtype, device=dev),
                    torch.zeros(cap, dtype=torch.bool, device=dev), self.dtype)
        v = torch.full((cap,), self.raw_value(), dtype=self.dtype.device_dtype, device=dev)
        return v, torch.ones(cap, dtype=torch.bool, device=dev), self.dtype

    def raw_value(self):
        """The value as the column holds it (a DECIMAL scaled to int)."""
        if self.dtype.kind is Kind.DECIMAL and not self.raw:
            return int(round(float(self.value) * 10 ** self.dtype.scale))
        return self.value

    def bits(self) -> Tuple[int, bool]:
        """(register bits, valid) of this literal's elements."""
        if self.value is None:
            return 0, False
        return k17.literal_bits(self.raw_value(), self.dtype.device_dtype), True

    def emit(self, c):
        bits, ok = self.bits()
        return c.const(bits, self.dtype.device_dtype, ok), self.dtype

    def __repr__(self):
        return f"lit({self.value})"


_CMP = {"=": torch.eq, "<>": torch.ne, "<": torch.lt, "<=": torch.le,
        ">": torch.gt, ">=": torch.ge}
_ARITH = ("+", "-", "*", "/", "%")


@dataclass(repr=False)
class BinOp(Expr):
    op: str
    left: Expr
    right: Expr

    def eval(self, t):
        lv, lval, ldt = self.left.eval(t)
        rv, rval, rdt = self.right.eval(t)
        op = self.op
        if op in ("and", "or"):
            # three-valued logic; invalid operands read as the identity value
            lb, rb = lv.to(torch.bool), rv.to(torch.bool)
            la = torch.where(lval, lb, op == "and")
            ra = torch.where(rval, rb, op == "and")
            if op == "and":
                return la & ra, (lval & rval) | (lval & ~lb) | (rval & ~rb), BOOL
            return la | ra, (lval & rval) | (lval & lb) | (rval & rb), BOOL
        valid = lval & rval
        if op in _CMP:
            cmp = _CMP[op]
            if ldt.kind is Kind.STRING or rdt.kind is Kind.STRING:
                return cmp(lv, rv), valid, BOOL
            if ldt.kind is Kind.DECIMAL and rdt.kind is Kind.DECIMAL \
                    and ldt.scale == rdt.scale:
                return cmp(lv, rv), valid, BOOL
            if ldt.kind is Kind.DECIMAL and rdt.kind in (Kind.INT32, Kind.INT64):
                return cmp(lv.to(torch.int64), rv.to(torch.int64) * 10 ** ldt.scale), valid, BOOL
            if rdt.kind is Kind.DECIMAL and ldt.kind in (Kind.INT32, Kind.INT64):
                return cmp(lv.to(torch.int64) * 10 ** rdt.scale, rv.to(torch.int64)), valid, BOOL
            a, b, _ = _promote(lv, ldt, rv, rdt)
            return cmp(a, b), valid, BOOL
        if op in _ARITH:
            d = _decimal_arith(op, lv, ldt, rv, rdt)
            if d is not None:
                return d[0], valid, d[1]
            a, b, dt = _promote(lv, ldt, rv, rdt)
            if op == "+":
                v = a + b
            elif op == "-":
                v = a - b
            elif op == "*":
                v = a * b
            elif op == "/":
                nz = b != 0
                if dt.kind in (Kind.INT32, Kind.INT64):
                    q = torch.div(a, torch.where(nz, b, 1), rounding_mode="floor")
                    v = torch.where(valid & nz, q, 0)
                else:
                    v = a / torch.where(nz, b, 1.0)
                valid = valid & nz
            else:  # % (the sign of the divisor, as jnp's %)
                nz = b != 0
                v = torch.remainder(a, torch.where(nz, b, 1))
                valid = valid & nz
            return v, valid, dt
        raise ValueError(f"unknown op {op}")

    def emit(self, c):
        lr, ldt = self.left.emit(c)
        rr, rdt = self.right.emit(c)
        op = self.op
        if op in ("and", "or"):
            return c.op(k17.AND if op == "and" else k17.OR, torch.bool, c.to_bool(lr),
                        c.to_bool(rr)), BOOL
        if op in _CMP:
            ints = (Kind.INT32, Kind.INT64)
            if ldt.kind is Kind.STRING or rdt.kind is Kind.STRING or (
                    ldt.kind is Kind.DECIMAL and rdt.kind is Kind.DECIMAL
                    and ldt.scale == rdt.scale):
                a, b = lr, rr
            elif ldt.kind is Kind.DECIMAL and rdt.kind in ints:
                a, b = c.cast(lr, torch.int64), c.scale(c.cast(rr, torch.int64), ldt.scale)
            elif rdt.kind is Kind.DECIMAL and ldt.kind in ints:
                a, b = c.scale(c.cast(lr, torch.int64), rdt.scale), c.cast(rr, torch.int64)
            else:
                a, b, _ = c.promote(lr, ldt, rr, rdt)
            a, b = c.common(a, b)
            return c.op(_CMP_OP[op], torch.bool, a, b, k17.DT_OF[c.dtype[a]]), BOOL
        if op in _ARITH:
            d = c.decimal_arith(op, lr, ldt, rr, rdt)
            if d is not None:
                return d
            a, b, dt = c.promote(lr, ldt, rr, rdt)
            if op in ("+", "-", "*"):
                # torch refuses `-` with a bool operand, even beside an int
                # (a CASE's BOOL-typed result can hold its ELSE's ints)
                if op == "-" and torch.bool in (c.dtype[a], c.dtype[b]):
                    raise TypeError("subtraction with a bool operand")
                a, b = c.common(a, b)
                return c.op(_ARITH_OP[op], c.dtype[a], a, b), dt
            if op == "/" and dt.kind in (Kind.INT32, Kind.INT64):
                a, b = c.common(a, b)
                return c.op(k17.IDIV, c.dtype[a], a, b), dt
            if op == "/":   # a / where(b != 0, b, 1.0): b's float type, else float32
                bt = c.dtype[b] if c.dtype[b].is_floating_point else torch.float32
                b = c.cast(b, bt)
                a, b = c.common(a, b)
                return c.op(k17.FDIV, c.dtype[a], a, b), dt
            # %: remainder(a, where(b != 0, b, 1))
            if c.dtype[b] == torch.bool:
                b = c.cast(b, torch.int64)
            a, b = c.common(a, b)
            return c.op(k17.MOD, c.dtype[a], a, b), dt
        raise ValueError(f"unknown op {op}")

    def __repr__(self):
        return f"({self.left} {self.op} {self.right})"


@dataclass(repr=False)
class Not(Expr):
    child: Expr

    def eval(self, t):
        v, valid, _ = self.child.eval(t)
        return ~v.to(torch.bool), valid, BOOL

    def emit(self, c):
        r, _ = self.child.emit(c)
        return c.op(k17.NOT, torch.bool, c.to_bool(r)), BOOL


@dataclass(repr=False)
class IsNull(Expr):
    child: Expr
    negated: bool = False

    def eval(self, t):
        _, valid, _ = self.child.eval(t)
        return (valid if self.negated else ~valid), torch.ones_like(valid), BOOL

    def emit(self, c):
        r, _ = self.child.emit(c)
        return c.op(k17.ISNULL, torch.bool, r, int(self.negated)), BOOL


@dataclass(repr=False)
class Cast(Expr):
    child: Expr
    to: DType

    def eval(self, t):
        v, valid, dt = self.child.eval(t)
        if dt == self.to:
            return v, valid, dt
        if self.to.kind in (Kind.FLOAT32, Kind.FLOAT64):
            return _as_float(v, dt).to(self.to.device_dtype), valid, self.to
        if self.to.kind is Kind.DECIMAL:
            f = _as_float(v, dt) * (10 ** self.to.scale)
            return torch.round(f).to(torch.int64), valid, self.to
        return v.to(self.to.device_dtype), valid, self.to

    def emit(self, c):
        r, dt = self.child.emit(c)
        if dt == self.to:
            return r, dt
        if self.to.kind in (Kind.FLOAT32, Kind.FLOAT64):
            return c.cast(c.as_float(r, dt), self.to.device_dtype), self.to
        if self.to.kind is Kind.DECIMAL:
            f = c.as_float(r, dt)
            f = c.op(k17.MUL, torch.float64, f,
                     c.const(k17.literal_bits(10 ** self.to.scale, torch.float64),
                             torch.float64))
            return c.cast(c.op(k17.ROUND, torch.float64, f), torch.int64), self.to
        return c.cast(r, self.to.device_dtype), self.to


@dataclass(repr=False)
class InCodes(Expr):
    """Set membership against a static sorted int array (string predicates,
    integer IN-lists)."""
    child: Expr
    codes: np.ndarray
    negated: bool = False

    def eval(self, t):
        v, valid, _ = self.child.eval(t)
        codes = torch.from_numpy(np.sort(np.asarray(self.codes))).to(v.device)
        member = torch.isin(v.to(codes.dtype), codes)
        return (~member if self.negated else member), valid, BOOL

    def emit(self, c):
        r, _ = self.child.emit(c)
        codes = np.sort(np.asarray(self.codes))
        cdt = torch.from_numpy(codes).dtype
        if cdt not in k17.DT_OF:
            raise TypeError(f"InCodes over {cdt} codes has no compiled form")
        r = c.cast(r, cdt)
        floating = cdt.is_floating_point
        words = codes.astype(np.float64).view(np.int64) if floating else codes.astype(np.int64)
        return c.op(k17.INSET, torch.bool, r, int(self.negated), k17.DT_OF[cdt],
                    imm=c.table(words)), BOOL


def _widen(a: torch.Tensor, b: torch.Tensor):
    if a.dtype == b.dtype:
        return a, b
    wide = torch.promote_types(a.dtype, b.dtype)
    return a.to(wide), b.to(wide)


@dataclass(repr=False)
class Case(Expr):
    whens: List[Tuple[Expr, Expr]]
    otherwise: Optional[Expr] = None

    def eval(self, t):
        branches = [(c.eval(t), v.eval(t)) for c, v in self.whens]
        _, _, vdt = branches[0][1]
        if self.otherwise is not None:
            out_v, out_valid, _ = self.otherwise.eval(t)
        else:
            out_v = torch.zeros(t.capacity, dtype=vdt.device_dtype, device=t.device)
            out_valid = torch.zeros(t.capacity, dtype=torch.bool, device=t.device)
        # fold in reverse so the FIRST matching when wins
        for (cv, cvalid, _), (vv, vvalid, _) in reversed(branches):
            hit = cvalid & cv.to(torch.bool)
            vv, out_v = _widen(vv, out_v)
            out_v = torch.where(hit, vv, out_v)
            out_valid = torch.where(hit, vvalid, out_valid)
        return out_v, out_valid, vdt

    def emit(self, c):
        # last branch first, each folded in as soon as it is emitted: the
        # fold holds the running result and one branch's registers, however
        # many branches there are
        first = None
        if self.otherwise is not None:
            out = self.otherwise.emit(c)[0]
        else:   # a NULL of the first branch's type
            first = self.whens[0][1].emit(c)
            out = c.const(0, first[1].device_dtype, False)
        for k in reversed(range(len(self.whens))):
            cond, val = self.whens[k]
            hit = c.to_bool(cond.emit(c)[0])
            r, vdt = first if k == 0 and first is not None else val.emit(c)
            r, out = c.common(r, out)
            out = c.op(k17.SELECT, c.dtype[r], hit, r, out)
        return out, vdt


@dataclass(repr=False)
class ExtractDatePart(Expr):
    """EXTRACT(YEAR|MONTH|DAY FROM date32) by the civil-calendar algorithm,
    in integers."""
    part: str  # 'year' | 'month' | 'day'
    child: Expr

    def eval(self, t):
        v, valid, _ = self.child.eval(t)

        def fdiv(a, b):
            return torch.div(a, b, rounding_mode="floor")

        z = v.to(torch.int32) + 719468
        era = fdiv(z, 146097)
        doe = z - era * 146097
        yoe = fdiv(doe - fdiv(doe, 1460) + fdiv(doe, 36524) - fdiv(doe, 146096), 365)
        y = yoe + era * 400
        doy = doe - (365 * yoe + fdiv(yoe, 4) - fdiv(yoe, 100))
        mp = fdiv(5 * doy + 2, 153)
        d = doy - fdiv(153 * mp + 2, 5) + 1
        m = mp + torch.where(mp < 10, 3, -9)
        y = y + (m <= 2).to(y.dtype)
        out = {"year": y, "month": m, "day": d}[self.part]
        return out.to(torch.int32), valid, INT32

    def emit(self, c):
        r, _ = self.child.emit(c)
        part = ("year", "month", "day").index(self.part)
        return c.op(k17.DATEPART, torch.int32, c.cast(r, torch.int32), part), INT32


@dataclass(repr=False)
class Coalesce(Expr):
    children: List[Expr]

    def eval(self, t):
        rs = [c.eval(t) for c in self.children]
        out_v, out_valid, dt = rs[-1]
        for v, valid, vdt in reversed(rs[:-1]):
            v, out_v = _widen(v, out_v)
            out_v = torch.where(valid, v, out_v)
            out_valid = valid | out_valid
            dt = vdt
        return out_v, out_valid, dt

    def emit(self, c):
        # last child first, folded in as it comes (a few live registers)
        out, dt = self.children[-1].emit(c)
        for ch in reversed(self.children[:-1]):
            r, dt = ch.emit(c)
            r, out = c.common(r, out)
            out = c.op(k17.COALESCE, c.dtype[r], r, out)
        return out, dt


_CMP_OP = {"=": k17.EQ, "<>": k17.NE, "<": k17.LT, "<=": k17.LE, ">": k17.GT, ">=": k17.GE}
_ARITH_OP = {"+": k17.ADD, "-": k17.SUB, "*": k17.MUL}


class Compiler:
    """Builds a K17 program from expression trees over one table's schema
    and column dtypes (`compile_exprs`). Registers are virtual while the
    nodes emit (one per instruction); `finish` maps them onto the few
    physical registers that are live at once. Type rules are those of the
    trees' `eval`: a register's torch dtype is its tensor's dtype there."""

    def __init__(self, t: DeviceTable):
        self.schema = t.schema
        self._col_dtype = {n: v.dtype for n, (v, _) in t.columns.items()}
        self.code: List[List[int]] = []     # op, dt, dst, a, b, c, imm
        self.dtype: List[torch.dtype] = []  # per virtual register
        self.cols: List[str] = []
        self._tables: List[np.ndarray] = []
        self._table_len = 0
        self.scalars: List[object] = []

    def op(self, op: int, dtype: torch.dtype, a: int = 0, b: int = 0, c: int = 0,
           imm: int = 0) -> int:
        self.code.append([op, k17.DT_OF[dtype], len(self.dtype), a, b, c, imm])
        self.dtype.append(dtype)
        return len(self.dtype) - 1

    def col(self, name: str) -> int:
        if name not in self.cols:
            self.cols.append(name)
        return self.op(k17.COL, self._col_dtype[name], self.cols.index(name))

    def const(self, bits: int, dtype: torch.dtype, valid: bool = True) -> int:
        return self.op(k17.CONST, dtype, 0, int(valid), imm=bits if valid else 0)

    def scalar(self, node, dtype: torch.dtype) -> int:
        """A register filled at each launch from `node.literal()`."""
        self.scalars.append(node)
        return self.op(k17.SCALAR, dtype, len(self.scalars) - 1)

    def table(self, words: np.ndarray) -> int:
        """imm of an int64 table appended to the program: offset << 32 | length."""
        off = self._table_len
        self._tables.append(np.asarray(words, dtype=np.int64))
        self._table_len += len(words)
        return (off << 32) | len(words)

    def cast(self, r: int, dtype: torch.dtype) -> int:
        """torch's `.to(dtype)` (no instruction when the dtype is the same)."""
        if self.dtype[r] == dtype:
            return r
        return self.op(k17.CAST, dtype, r, 0, k17.DT_OF[self.dtype[r]])

    def to_bool(self, r: int) -> int:
        return self.cast(r, torch.bool)

    def common(self, a: int, b: int) -> Tuple[int, int]:
        """Both operands in torch's promoted dtype (`_widen`, and the
        implicit promotion of a binary torch op)."""
        wide = torch.promote_types(self.dtype[a], self.dtype[b])
        return self.cast(a, wide), self.cast(b, wide)

    def scale(self, r: int, scale: int) -> int:
        """int64 register times 10**scale (no instruction for scale 0)."""
        if scale == 0:
            return r
        return self.op(k17.MUL, torch.int64, r, self.const(10 ** scale, torch.int64))

    def as_float(self, r: int, dt: DType) -> int:
        """`_as_float`: float64, a DECIMAL divided by 10.0 ** scale."""
        f = self.cast(r, torch.float64)
        if dt.kind is Kind.DECIMAL:
            ten = self.const(k17.literal_bits(10.0 ** dt.scale, torch.float64), torch.float64)
            f = self.op(k17.FDIV, torch.float64, f, ten)
        return f

    def promote(self, lr: int, ldt: DType, rr: int, rdt: DType):
        """`_promote` over registers."""
        if ldt == rdt and ldt.kind is not Kind.DECIMAL:
            return lr, rr, ldt
        num_f = (Kind.FLOAT32, Kind.FLOAT64, Kind.DECIMAL)
        if ldt.kind in num_f or rdt.kind in num_f:
            return self.as_float(lr, ldt), self.as_float(rr, rdt), FLOAT64
        wide = torch.promote_types(self.dtype[lr], self.dtype[rr])
        out = INT64 if wide == torch.int64 else (
            DATE32 if Kind.DATE32 in (ldt.kind, rdt.kind) else INT32)
        return self.cast(lr, wide), self.cast(rr, wide), out

    def decimal_arith(self, op, lr, ldt: DType, rr, rdt: DType):
        """`_decimal_arith` over registers: (register, DType) or None."""
        kinds = (ldt.kind, rdt.kind)
        ints = (Kind.INT32, Kind.INT64)
        if Kind.DECIMAL not in kinds or op not in ("+", "-", "*"):
            return None
        if not all(k is Kind.DECIMAL or k in ints for k in kinds):
            return None
        ls = ldt.scale if ldt.kind is Kind.DECIMAL else 0
        rs = rdt.scale if rdt.kind is Kind.DECIMAL else 0
        a, b = self.cast(lr, torch.int64), self.cast(rr, torch.int64)
        if op == "*":
            if ls + rs > _MAX_DECIMAL_SCALE:
                return None
            return self.op(k17.MUL, torch.int64, a, b), DECIMAL(ls + rs)
        s = max(ls, rs)
        if s > _MAX_DECIMAL_SCALE:
            return None
        a, b = self.scale(a, s - ls), self.scale(b, s - rs)
        return self.op(_ARITH_OP[op], torch.int64, a, b), DECIMAL(s)

    def finish(self, roots: Sequence[int]) -> k17.Program:
        """The program with its virtual registers mapped onto physical ones:
        a register is free again after its last read (a root's never)."""
        last = {}
        for i, (op, *_rest) in enumerate(self.code):
            for f in k17.READS[op]:
                last[self.code[i][3 + "abc".index(f)]] = i
        for r in roots:
            last[r] = len(self.code)
        phys, free, n_regs, code = {}, [], 0, []
        for i, (op, dt, dst, a, b, c, imm) in enumerate(self.code):
            ops = {"a": a, "b": b, "c": c}
            for f in k17.READS[op]:
                ops[f] = phys[ops[f]]
            for f in set(k17.READS[op]):
                v = (a, b, c)["abc".index(f)]
                if last[v] == i and phys[v] not in free:
                    free.append(phys[v])
            if free:
                free.sort()
                phys[dst] = free.pop(0)
            else:
                phys[dst], n_regs = n_regs, n_regs + 1
            if dst not in last:             # never read
                free.append(phys[dst])
            u = imm & 0xFFFFFFFFFFFFFFFF
            code.append([op, dt, phys[dst], ops["a"], ops["b"], ops["c"],
                         u & 0xFFFFFFFF, u >> 32])
        arr = np.array(code, dtype=np.int64).reshape(-1, 8)
        arr = ((arr + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)
        tables = (np.concatenate(self._tables) if self._tables
                  else np.zeros(1, dtype=np.int64))
        return k17.Program(arr, n_regs, tuple(self.cols),
                           tuple((phys[r], self.dtype[r]) for r in roots), tables,
                           tuple(self.scalars))


def _schema_key(t: DeviceTable):
    return tuple((f.name, f.dtype, t.columns[f.name][0].dtype) for f in t.schema.fields)


def compile_exprs(exprs: Sequence[Expr], t: DeviceTable) -> Tuple[k17.Program, List[DType]]:
    """One K17 program computing every expression of `exprs` over tables of
    t's schema and column dtypes, and their DTypes. Cached on the first
    tree, by the identity of the trees and the schema's fields and dtypes."""
    key = (tuple(id(e) for e in exprs), _schema_key(t))
    cache = exprs[0].__dict__.setdefault("_k17_programs", {})
    hit = cache.get(key)
    if hit is not None and all(a is b for a, b in zip(hit[0], exprs)):
        return hit[1], hit[2]
    c = Compiler(t)
    emitted = [e.emit(c) for e in exprs]
    program = c.finish([r for r, _ in emitted])
    cache[key] = (tuple(exprs), program, [dt for _, dt in emitted])
    return program, cache[key][2]


def _launch(program: k17.Program, t: DeviceTable, kernels, mask=None):
    scalars = tuple(node.literal().bits() for node in program.scalars)
    columns = [t.column(n) for n in program.cols]
    fn = kernels.expr_eval if kernels is not None else k17.expr_eval
    return fn(program, columns, t.capacity, scalars, mask, t.device)


def evaluate(exprs: Sequence[Expr], t: DeviceTable, kernels=None) -> List[EvalResult]:
    """(values, validity, DType) of each expression over t, as its `eval`
    gives them: one K17 launch (through `kernels`, a ChainKernels table)
    computes all of them (one launch per 32); an expression that is a
    column as it stands (a Col, or a Cast to its own type) is that
    column's tensors. A tree past one launch runs in several
    (`_materialised`)."""
    out: List[Optional[EvalResult]] = []
    for e in exprs:
        name = _passthrough(e, t)
        out.append(None if name is None else (*t.column(name), t.schema.field(name).dtype))
    computed = [e for e, o in zip(exprs, out) if o is None]
    results = []
    for group in _groups(computed, t):
        gt = t
        if len(group) == 1 and not _fits(compile_exprs(group, t)[0]):
            gt, root = _materialised(group[0], t, kernels)
            group = [root]
        program, dts = compile_exprs(group, gt)
        results += [_with_dtype(r, dt) for r, dt in zip(_launch(program, gt, kernels), dts)]
    results = iter(results)
    return [o if o is not None else next(results) for o in out]


def _fits(program: k17.Program) -> bool:
    return (len(program.code) <= k17.MAX_CODE and program.n_regs <= k17.MAX_REGS
            and len(program.cols) <= k17.MAX_COLS and len(program.scalars) <= k17.MAX_SCALARS)


def _groups(exprs: List[Expr], t: DeviceTable) -> List[List[Expr]]:
    """`exprs` cut into runs that one launch takes: at most MAX_OUTS roots,
    halved until each program fits the kernel's instruction, register,
    column and scalar limits (a single tree past them stays a run of its
    own, which `evaluate` splits further)."""
    if not exprs:
        return []
    if len(exprs) == 1 or (len(exprs) <= k17.MAX_OUTS and _fits(compile_exprs(exprs, t)[0])):
        return [exprs]
    half = min(len(exprs) // 2, k17.MAX_OUTS)
    return _groups(exprs[:half], t) + _groups(exprs[half:], t)


def _with_dtype(result, dt: DType) -> EvalResult:
    return result[0], result[1], dt


def _passthrough(e: Expr, t: DeviceTable) -> Optional[str]:
    """The column an expression is as it stands, or None."""
    while isinstance(e, Cast) and isinstance(e.child, Col) \
            and t.schema.field(e.child.name).dtype == e.to:
        e = e.child
    return e.name if isinstance(e, Col) else None


def predicate_mask(predicate: Expr, t: DeviceTable, kernels=None, in_rows: bool = False,
                   and_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bool [capacity]: valid & value of `predicate` over t (a NULL rejects
    the row), False past t.num_rows where `in_rows`, and ANDed with
    `and_mask`: one K17 launch in mask mode, or several for a predicate
    past one launch (`_split_mask`)."""
    program, _ = compile_exprs([predicate], t)
    if not _fits(program):
        return _split_mask(predicate, t, kernels, in_rows, and_mask)
    num_rows = t.num_rows.to(torch.int32) if in_rows else None
    return _launch(program, t, kernels, (num_rows, and_mask))


# ---------------------------------------------------------------------------
# Trees past one launch. The JAX package has no limit on a tree; K17 holds
# MAX_CODE instructions, MAX_REGS registers, MAX_COLS columns and
# MAX_SCALARS scalars. A predicate's AND or OR chain runs in runs of terms,
# each a mask-mode launch; any other tree runs as stages, each computing a
# subtree into a column of a widened table that the next stage reads.
# ---------------------------------------------------------------------------

_SPLIT_COLUMN = "__k17_stage_{}"


def _cached(e: Expr, t: DeviceTable, tag: str, make):
    """make() once per tree, tag and schema (the split of a tree is as
    static as its program)."""
    cache = e.__dict__.setdefault("_k17_splits", {})
    key = (tag, _schema_key(t))
    if key not in cache:
        cache[key] = make()
    return cache[key]


def _terms(e: Expr, op: str) -> List[Expr]:
    """The operands of an `op` chain ("and" / "or"), left to right."""
    if isinstance(e, BinOp) and e.op == op:
        return _terms(e.left, op) + _terms(e.right, op)
    return [e]


def _chain(terms: Sequence[Expr], op: str) -> Expr:
    out = terms[0]
    for term in terms[1:]:
        out = BinOp(op, out, term)
    return out


def _term_runs(terms: Sequence[Expr], op: str, t: DeviceTable) -> List[Expr]:
    """The chain's terms in runs, in order, each run's chain one launch
    (a single term past a launch stays a run of its own)."""
    runs: List[List[Expr]] = []
    for term in terms:
        if runs and _fits(compile_exprs([_chain(runs[-1] + [term], op)], t)[0]):
            runs[-1].append(term)
        else:
            runs.append([term])
    return [_chain(r, op) for r in runs]


def _split_mask(predicate: Expr, t: DeviceTable, kernels, in_rows: bool,
                and_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """predicate_mask of a predicate past one launch. Under SQL's
    three-valued logic a chain of ANDs is true where every term is and a
    chain of ORs where any term is, so the runs' masks combine exactly:
    each AND run's mask is the next run's and_mask, OR runs' masks are
    ORed. Any other tree is evaluated over its materialised parts."""
    op = predicate.op if isinstance(predicate, BinOp) else None
    if op not in ("and", "or"):
        gt, root = _materialised(predicate, t, kernels)
        return predicate_mask(root, gt, kernels, in_rows, and_mask)
    runs = _cached(predicate, t, op, lambda: _term_runs(_terms(predicate, op), op, t))
    if op == "and":
        for run in runs:
            and_mask = predicate_mask(run, t, kernels, in_rows, and_mask)
        return and_mask
    mask = None
    for run in runs:
        m = predicate_mask(run, t, kernels, in_rows)
        mask = m if mask is None else mask | m
    return mask if and_mask is None else mask & and_mask


def _with_column(t: DeviceTable, name: str, dt: DType, values: torch.Tensor,
                 valid: torch.Tensor) -> DeviceTable:
    return DeviceTable(Schema(list(t.schema.fields) + [Field(name, dt)]),
                       {**t.columns, name: (values, valid)}, t.num_rows)


def _children(e: Expr) -> List[Expr]:
    """A node's direct subtrees, in field order (a Case's (cond, value)
    pairs flattened)."""
    out = []
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        for x in (v if isinstance(v, list) else [v]):
            out += [y for y in (x if isinstance(x, tuple) else (x,)) if isinstance(y, Expr)]
    return out


def _with_children(e: Expr, kids: Sequence[Expr]) -> Expr:
    """A copy of `e` over `kids` in `_children`'s order."""
    it = iter(kids)

    def sub(x):
        if isinstance(x, Expr):
            return next(it)
        if isinstance(x, tuple):
            return tuple(sub(y) for y in x)
        return x

    changes = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, list):   # a Case's whens, a Coalesce's children
            if any(isinstance(x, (Expr, tuple)) for x in v):
                changes[f.name] = [sub(x) for x in v]
        else:
            changes[f.name] = sub(v)
    return dataclasses.replace(e, **changes)


class _Stages:
    """A tree cut into stages that each fit one K17 launch: `stages` holds
    (column name, subtree) in order, each subtree over t's columns and the
    stages before it; `fit` returns the tree left over them."""

    def __init__(self, t: DeviceTable):
        self.t = t        # t widened by the stages' columns (dtypes only)
        self.stages: List[Tuple[str, Expr]] = []

    def fits(self, e: Expr) -> bool:
        return _fits(compile_exprs([e], self.t)[0])

    def size(self, e: Expr) -> int:
        return len(compile_exprs([e], self.t)[0].code)

    def column(self, e: Expr) -> Expr:
        """A stage computing `e` (which fits), and the Col that reads it."""
        program, (dt,) = compile_exprs([e], self.t)
        name = _SPLIT_COLUMN.format(len(self.stages))
        self.t = _with_column(self.t, name, dt, torch.empty(0, dtype=program.roots[0][1]),
                              torch.empty(0, dtype=torch.bool))
        self.stages.append((name, e))
        return Col(name)

    def fit(self, e: Expr) -> Expr:
        if self.fits(e):
            return e
        if isinstance(e, Case) and len(e.whens) > 1:
            return self._fit_case(e)
        if isinstance(e, Coalesce) and len(e.children) > 2:
            return self._fit_coalesce(e)
        kids = [self.fit(k) for k in _children(e)]
        # the largest operands become columns until the node fits
        for i in sorted(range(len(kids)), key=lambda i: -self.size(kids[i])):
            if self.fits(_with_children(e, kids)):
                break
            if not isinstance(kids[i], Col):
                kids[i] = self.column(kids[i])
        e = _with_children(e, kids)
        if not self.fits(e):
            raise ValueError(f"{e!r} over column operands does not fit one expr_eval launch")
        return e

    def _fit_case(self, e: Case) -> Expr:
        """From the last branch: the branches that fit one launch over the
        rest's result become a stage, the rest for the branches before
        them (the first matching branch wins, so CASE w1..wn ELSE r is
        CASE w1..wk ELSE (CASE wk+1..wn ELSE r), with the first branch's
        type for a NULL ELSE, as `eval` widens either way)."""
        rest, run = e.otherwise, []
        for when in reversed(e.whens):
            if run and not self.fits(Case([when] + run, rest)):
                rest, run = self.column(self.fit(Case(run, rest))), []
            run.insert(0, when)
        return self.fit(Case(run, rest))

    def _fit_coalesce(self, e: Coalesce) -> Expr:
        """As `_fit_case`: COALESCE(c1..cn) is COALESCE(c1..ck, COALESCE(ck+1..cn))."""
        run = [e.children[-1]]
        for child in reversed(e.children[:-1]):
            if len(run) > 1 and not self.fits(Coalesce([child] + run)):
                run = [self.column(self.fit(Coalesce(run)))]
            run.insert(0, child)
        return self.fit(Coalesce(run))


def _materialised(e: Expr, t: DeviceTable, kernels) -> Tuple[DeviceTable, Expr]:
    """(t widened by the columns of `e`'s stages, the tree left over them):
    one K17 launch per stage, then the tree fits one more."""
    def plan():
        st = _Stages(t)
        root = st.fit(e)
        return st.stages, root

    stages, root = _cached(e, t, "stages", plan)
    for name, sub in stages:
        program, (dt,) = compile_exprs([sub], t)
        ((values, valid),) = _launch(program, t, kernels)
        t = _with_column(t, name, dt, values, valid)
    return t, root
