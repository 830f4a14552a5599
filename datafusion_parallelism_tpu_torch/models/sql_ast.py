"""SQL AST nodes (front-end analog of reference src/parse_sql.rs, which
delegates parsing to DataFusion's postgres-dialect parser; here the dialect
subset needed by the reference test matrix + TPC-H is parsed natively)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple


class ENode:
    pass


@dataclass
class EIdent(ENode):
    parts: List[str]           # ["alias", "col"] or ["col"]

    def __repr__(self):
        return ".".join(self.parts)


@dataclass
class ELit(ENode):
    value: object              # int | float | str | bool | None
    kind: str                  # 'int' | 'float' | 'string' | 'bool' | 'null'


@dataclass
class EDate(ENode):
    value: str                 # 'YYYY-MM-DD'


@dataclass
class EInterval(ENode):
    value: int
    unit: str                  # 'year' | 'month' | 'day'


@dataclass
class EBinary(ENode):
    op: str                    # + - * / % = <> < <= > >= and or
    left: ENode
    right: ENode


@dataclass
class EUnary(ENode):
    op: str                    # 'not' | '-'
    child: ENode


@dataclass
class EFunc(ENode):
    name: str                  # lower-cased
    args: List[ENode]
    distinct: bool = False
    star: bool = False         # count(*)


@dataclass
class ECase(ENode):
    whens: List[Tuple[ENode, ENode]]
    otherwise: Optional[ENode]


@dataclass
class ECast(ENode):
    child: ENode
    type_name: str


@dataclass
class EIsNull(ENode):
    child: ENode
    negated: bool


@dataclass
class EBetween(ENode):
    child: ENode
    low: ENode
    high: ENode
    negated: bool


@dataclass
class EInList(ENode):
    child: ENode
    items: List[ENode]
    negated: bool


@dataclass
class ELike(ENode):
    child: ENode
    pattern: str
    negated: bool


@dataclass
class EExtract(ENode):
    part: str                  # 'year' | 'month' | 'day'
    child: ENode


@dataclass
class ESubstring(ENode):
    child: ENode
    start: int                 # 1-based
    length: Optional[int]


@dataclass
class EExists(ENode):
    query: "SelectStmt"
    negated: bool


@dataclass
class EInSubquery(ENode):
    child: ENode
    query: "SelectStmt"
    negated: bool


@dataclass
class EScalarSubquery(ENode):
    query: "SelectStmt"


@dataclass
class TableRef:
    name: str
    alias: Optional[str] = None

    @property
    def label(self) -> str:
        return self.alias or self.name


@dataclass
class SubqueryRef:
    query: "SelectStmt"
    alias: str

    @property
    def label(self) -> str:
        return self.alias


@dataclass
class JoinClause:
    kind: str                  # 'inner' | 'left' | 'right' | 'full' | 'cross'
    table: object              # TableRef | SubqueryRef
    on: Optional[ENode]


@dataclass
class OrderItem:
    expr: ENode
    ascending: bool = True
    nulls_first: Optional[bool] = None  # None -> postgres default


@dataclass
class SelectStmt:
    projections: List[Tuple[ENode, Optional[str]]]  # (expr, alias)
    from_tables: List[object] = field(default_factory=list)  # TableRef|SubqueryRef
    joins: List[JoinClause] = field(default_factory=list)
    where: Optional[ENode] = None
    group_by: List[ENode] = field(default_factory=list)
    having: Optional[ENode] = None
    order_by: List[OrderItem] = field(default_factory=list)
    limit: Optional[int] = None
    distinct: bool = False
