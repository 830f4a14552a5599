"""Vectorized expression evaluation over device tables (torch).

Counterpart of `datafusion_parallelism_tpu/ops/expressions.py`, with the
same classes, fields and SQL semantics: (values, validity) pairs carry
three-valued logic, comparisons reject NULLs, decimal + - * stay exact in
scaled int64 up to scale 4, division by zero gives NULL, and strings are
dictionary codes (string predicates arrive as `InCodes` code sets).

Each `eval(t)` returns (values, validity, DType) as torch tensors on the
table's device. These are plain elementwise torch ops; a fused expression
kernel is still to port (ROADMAP queue 2).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils.columnar import (BOOL, DATE32, DECIMAL, FLOAT64, INT32, INT64,
                              DeviceTable, DType, Kind)

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

    def __repr__(self):
        return self.__class__.__name__


@dataclass(repr=False)
class Col(Expr):
    name: str

    def eval(self, t):
        v, valid = t.column(self.name)
        return v, valid, t.schema.field(self.name).dtype

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
        raw = self.value
        if self.dtype.kind is Kind.DECIMAL and not self.raw:
            raw = int(round(float(raw) * 10 ** self.dtype.scale))
        v = torch.full((cap,), raw, dtype=self.dtype.device_dtype, device=dev)
        return v, torch.ones(cap, dtype=torch.bool, device=dev), self.dtype

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

    def __repr__(self):
        return f"({self.left} {self.op} {self.right})"


@dataclass(repr=False)
class Not(Expr):
    child: Expr

    def eval(self, t):
        v, valid, _ = self.child.eval(t)
        return ~v.to(torch.bool), valid, BOOL


@dataclass(repr=False)
class IsNull(Expr):
    child: Expr
    negated: bool = False

    def eval(self, t):
        _, valid, _ = self.child.eval(t)
        return (valid if self.negated else ~valid), torch.ones_like(valid), BOOL


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
