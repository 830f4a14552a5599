"""Recursive-descent / Pratt SQL parser (postgres-flavoured subset).

Covers what the reference exercises through DataFusion's parser
(reference src/lib.rs test matrix: joins, EXISTS/NOT EXISTS, FULL OUTER,
residual predicates) plus the TPC-H query set: aggregates, GROUP BY/HAVING,
ORDER BY/LIMIT, CASE, LIKE, IN (lists + subqueries), BETWEEN, EXTRACT,
SUBSTRING, DATE/INTERVAL literals and their constant arithmetic.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

from .sql_ast import (EBetween, EBinary, ECase, ECast, EDate, EExists,
                      EExtract, EFunc, EIdent, EInList, EInSubquery,
                      EInterval, EIsNull, ELike, ELit, EScalarSubquery,
                      ESubstring, EUnary, JoinClause, OrderItem, SelectStmt,
                      SubqueryRef, TableRef)

_TOKEN_RE = re.compile(r"""
    \s+
  | --[^\n]*
  | (?P<num>\d+\.\d+(e[+-]?\d+)?|\.\d+|\d+(e[+-]?\d+)?)
  | (?P<str>'(?:[^']|'')*')
  | (?P<qid>"[^"]*")
  | (?P<op><>|<=|>=|!=|\|\||[-+*/%(),.;=<>])
  | (?P<id>[A-Za-z_][A-Za-z0-9_]*)
""", re.VERBOSE | re.IGNORECASE)

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "join", "inner", "left", "right", "full", "outer", "cross", "on", "as",
    "and", "or", "not", "in", "exists", "between", "like", "is", "null",
    "case", "when", "then", "else", "end", "cast", "extract", "substring",
    "distinct", "asc", "desc", "nulls", "first", "last", "interval", "date",
    "true", "false", "union", "all", "for",
}


class Token:
    __slots__ = ("kind", "value")

    def __init__(self, kind: str, value: str):
        self.kind = kind      # 'num' | 'str' | 'id' | 'kw' | 'op' | 'eof'
        self.value = value

    def __repr__(self):
        return f"{self.kind}:{self.value}"


def tokenize(sql: str) -> List[Token]:
    out, pos = [], 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise SyntaxError(f"cannot tokenize at: {sql[pos:pos+30]!r}")
        pos = m.end()
        if m.lastgroup is None:
            continue
        text = m.group(m.lastgroup)
        if m.lastgroup == "num":
            out.append(Token("num", text))
        elif m.lastgroup == "str":
            out.append(Token("str", text[1:-1].replace("''", "'")))
        elif m.lastgroup == "qid":
            out.append(Token("id", text[1:-1]))
        elif m.lastgroup == "op":
            out.append(Token("op", "<>" if text == "!=" else text))
        else:
            low = text.lower()
            out.append(Token("kw" if low in KEYWORDS else "id",
                             low if low in KEYWORDS else text))
    out.append(Token("eof", ""))
    return out


class Parser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0

    # -- token helpers ------------------------------------------------------
    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind: str, value: Optional[str] = None) -> Optional[Token]:
        t = self.peek()
        if t.kind == kind and (value is None or t.value == value):
            return self.next()
        return None

    def expect(self, kind: str, value: Optional[str] = None) -> Token:
        t = self.accept(kind, value)
        if t is None:
            raise SyntaxError(f"expected {value or kind}, got {self.peek()} "
                              f"(near token {self.i})")
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "kw" and t.value in kws

    # -- statements ---------------------------------------------------------
    def parse(self) -> SelectStmt:
        stmt = self.parse_select()
        self.accept("op", ";")
        if self.peek().kind != "eof":
            raise SyntaxError(f"trailing input at {self.peek()}")
        return stmt

    def parse_select(self) -> SelectStmt:
        self.expect("kw", "select")
        distinct = bool(self.accept("kw", "distinct"))
        projections: List[Tuple] = []
        while True:
            if self.accept("op", "*"):
                projections.append((EIdent(["*"]), None))
            else:
                e = self.parse_expr()
                alias = None
                if self.accept("kw", "as"):
                    alias = self.expect_name()
                elif self.peek().kind == "id":
                    alias = self.next().value
                projections.append((e, alias))
            if not self.accept("op", ","):
                break
        stmt = SelectStmt(projections=projections, distinct=distinct)
        if self.accept("kw", "from"):
            stmt.from_tables.append(self.parse_table_ref())
            while True:
                if self.accept("op", ","):
                    stmt.from_tables.append(self.parse_table_ref())
                    continue
                kind = None
                if self.at_kw("join", "inner"):
                    if self.accept("kw", "inner"):
                        pass
                    kind = "inner"
                elif self.at_kw("left", "right", "full"):
                    kind = self.next().value
                    self.accept("kw", "outer")
                elif self.at_kw("cross"):
                    self.next()
                    kind = "cross"
                else:
                    break
                self.expect("kw", "join")
                tref = self.parse_table_ref()
                on = None
                if kind != "cross":
                    self.expect("kw", "on")
                    on = self.parse_expr()
                stmt.joins.append(JoinClause(kind, tref, on))
        if self.accept("kw", "where"):
            stmt.where = self.parse_expr()
        if self.accept("kw", "group"):
            self.expect("kw", "by")
            stmt.group_by.append(self.parse_expr())
            while self.accept("op", ","):
                stmt.group_by.append(self.parse_expr())
        if self.accept("kw", "having"):
            stmt.having = self.parse_expr()
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            while True:
                e = self.parse_expr()
                asc = True
                if self.accept("kw", "desc"):
                    asc = False
                else:
                    self.accept("kw", "asc")
                nulls_first = None
                if self.accept("kw", "nulls"):
                    if self.accept("kw", "first"):
                        nulls_first = True
                    else:
                        self.expect("kw", "last")
                        nulls_first = False
                stmt.order_by.append(OrderItem(e, asc, nulls_first))
                if not self.accept("op", ","):
                    break
        if self.accept("kw", "limit"):
            stmt.limit = int(self.expect("num").value)
        return stmt

    def expect_name(self) -> str:
        t = self.peek()
        if t.kind == "id":
            return self.next().value
        raise SyntaxError(f"expected identifier, got {t}")

    def parse_table_ref(self):
        if self.accept("op", "("):
            sub = self.parse_select()
            self.expect("op", ")")
            self.accept("kw", "as")
            alias = self.expect_name()
            return SubqueryRef(sub, alias)
        name = self.expect_name()
        alias = None
        if self.accept("kw", "as"):
            alias = self.expect_name()
        elif self.peek().kind == "id":
            alias = self.next().value
        return TableRef(name, alias)

    # -- expressions (Pratt) -------------------------------------------------
    def parse_expr(self) -> object:
        return self.parse_or()

    def parse_or(self):
        e = self.parse_and()
        while self.accept("kw", "or"):
            e = EBinary("or", e, self.parse_and())
        return e

    def parse_and(self):
        e = self.parse_not()
        while self.accept("kw", "and"):
            e = EBinary("and", e, self.parse_not())
        return e

    def parse_not(self):
        if self.accept("kw", "not"):
            return EUnary("not", self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self):
        e = self.parse_additive()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("=", "<>", "<", "<=", ">", ">="):
                self.next()
                e = EBinary(t.value, e, self.parse_additive())
                continue
            negated = False
            save = self.i
            if self.accept("kw", "not"):
                negated = True
            if self.accept("kw", "between"):
                lo = self.parse_additive()
                self.expect("kw", "and")
                hi = self.parse_additive()
                e = EBetween(e, lo, hi, negated)
                continue
            if self.accept("kw", "like"):
                pat = self.expect("str").value
                e = ELike(e, pat, negated)
                continue
            if self.accept("kw", "in"):
                self.expect("op", "(")
                if self.at_kw("select"):
                    sub = self.parse_select()
                    self.expect("op", ")")
                    e = EInSubquery(e, sub, negated)
                else:
                    items = [self.parse_expr()]
                    while self.accept("op", ","):
                        items.append(self.parse_expr())
                    self.expect("op", ")")
                    e = EInList(e, items, negated)
                continue
            if negated:
                self.i = save  # bare NOT belongs to parse_not
                break
            if self.accept("kw", "is"):
                neg = bool(self.accept("kw", "not"))
                self.expect("kw", "null")
                e = EIsNull(e, neg)
                continue
            break
        return e

    def parse_additive(self):
        e = self.parse_multiplicative()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-"):
                self.next()
                e = EBinary(t.value, e, self.parse_multiplicative())
            else:
                return e

    def parse_multiplicative(self):
        e = self.parse_unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                self.next()
                e = EBinary(t.value, e, self.parse_unary())
            else:
                return e

    def parse_unary(self):
        if self.accept("op", "-"):
            return EUnary("-", self.parse_unary())
        if self.accept("op", "+"):
            return self.parse_unary()
        return self.parse_primary()

    def parse_primary(self):
        t = self.peek()
        if self.accept("op", "("):
            if self.at_kw("select"):
                sub = self.parse_select()
                self.expect("op", ")")
                return EScalarSubquery(sub)
            e = self.parse_expr()
            self.expect("op", ")")
            return e
        if t.kind == "num":
            self.next()
            if "." in t.value or "e" in t.value.lower():
                return ELit(float(t.value), "float")
            return ELit(int(t.value), "int")
        if t.kind == "str":
            self.next()
            return ELit(t.value, "string")
        if self.accept("kw", "true"):
            return ELit(True, "bool")
        if self.accept("kw", "false"):
            return ELit(False, "bool")
        if self.accept("kw", "null"):
            return ELit(None, "null")
        if self.accept("kw", "date"):
            s = self.expect("str").value
            return EDate(s)
        if self.accept("kw", "interval"):
            s = self.expect("str").value
            parts = s.split()
            if len(parts) == 2:      # INTERVAL '3 month'
                qty, unit = int(parts[0]), parts[1]
            else:                     # INTERVAL '3' month
                qty = int(parts[0])
                unit = self.expect_name()
            unit = unit.lower().rstrip("s")
            return EInterval(qty, unit)
        if self.accept("kw", "case"):
            whens = []
            operand = None
            if not self.at_kw("when"):
                operand = self.parse_expr()
            while self.accept("kw", "when"):
                c = self.parse_expr()
                if operand is not None:
                    c = EBinary("=", operand, c)
                self.expect("kw", "then")
                v = self.parse_expr()
                whens.append((c, v))
            otherwise = None
            if self.accept("kw", "else"):
                otherwise = self.parse_expr()
            self.expect("kw", "end")
            return ECase(whens, otherwise)
        if self.accept("kw", "cast"):
            self.expect("op", "(")
            e = self.parse_expr()
            self.expect("kw", "as")
            tn = self.expect_name()
            # consume optional (p[,s])
            if self.accept("op", "("):
                args = [self.expect("num").value]
                while self.accept("op", ","):
                    args.append(self.expect("num").value)
                self.expect("op", ")")
                tn = f"{tn}({','.join(args)})"
            self.expect("op", ")")
            return ECast(e, tn.lower())
        if self.accept("kw", "extract"):
            self.expect("op", "(")
            part = self.expect_name().lower()
            self.expect("kw", "from")
            e = self.parse_expr()
            self.expect("op", ")")
            return EExtract(part, e)
        if self.accept("kw", "substring"):
            self.expect("op", "(")
            e = self.parse_expr()
            if self.accept("kw", "from"):
                start = int(self.expect("num").value)
                length = None
                if self.accept("kw", "for"):
                    length = int(self.expect("num").value)
            else:
                self.expect("op", ",")
                start = int(self.expect("num").value)
                length = None
                if self.accept("op", ","):
                    length = int(self.expect("num").value)
            self.expect("op", ")")
            return ESubstring(e, start, length)
        if self.accept("kw", "exists"):
            self.expect("op", "(")
            sub = self.parse_select()
            self.expect("op", ")")
            return EExists(sub, negated=False)
        if t.kind == "id":
            name = self.next().value
            if self.peek().kind == "op" and self.peek().value == "(":
                self.next()
                distinct = bool(self.accept("kw", "distinct"))
                star = False
                args: List[object] = []
                if self.accept("op", "*"):
                    star = True
                elif not (self.peek().kind == "op" and self.peek().value == ")"):
                    args.append(self.parse_expr())
                    while self.accept("op", ","):
                        args.append(self.parse_expr())
                self.expect("op", ")")
                return EFunc(name.lower(), args, distinct, star)
            parts = [name]
            while self.accept("op", "."):
                parts.append(self.expect_name())
            return EIdent(parts)
        raise SyntaxError(f"unexpected token {t}")


def parse_sql(sql: str) -> SelectStmt:
    """Parse one SELECT statement (reference parse_sql, src/parse_sql.rs:73-76)."""
    return Parser(sql).parse()
