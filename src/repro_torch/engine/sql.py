# Copy of src/repro/engine/sql.py, kept numpy-only; change both copies together.
"""A deliberately small SQL front-end.

Grammar (case-insensitive keywords)::

    query   := SELECT select_list FROM ident [WHERE expr] [LIMIT int]
    select  := '*' | item (',' item)*
    item    := ident | agg '(' (ident|'*') ')'
    agg     := SUM | MIN | MAX | COUNT | AVG
    expr    := or_expr
    or      := and (OR and)*
    and     := unary (AND unary)*
    unary   := NOT unary | cmp
    cmp     := add (op add)? | add IS [NOT] NULL
    add     := mul (('+'|'-') mul)*
    mul     := atom (('*'|'/'|'%') atom)*
    atom    := number | string | ident | '(' expr ')'

Enough for every query shape in the paper's evaluation (column-selectivity
SELECTs, filtered scans, simple aggregates) without dragging in a parser dep.
"""
from __future__ import annotations

import dataclasses
import re

from .expressions import BinOp, Col, Expr, IsNull, Lit, Not

_TOKEN = re.compile(r"""
    \s*(?:
      (?P<num>(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?)
    | (?P<str>'(?:[^']|'')*')
    | (?P<ident>[A-Za-z_][A-Za-z_0-9]*)
    | (?P<op><=|>=|!=|<>|==|[-+*/%(),=<>])
    | (?P<star>\*)
    )""", re.VERBOSE)

_KEYWORDS = {"select", "from", "where", "limit", "and", "or", "not", "is",
             "null", "sum", "min", "max", "count", "avg"}
_AGGS = {"sum", "min", "max", "count", "avg"}


@dataclasses.dataclass
class SelectItem:
    column: str | None          # None for count(*)
    agg: str | None = None      # None for plain column

    @property
    def output_name(self) -> str:
        if self.agg is None:
            return self.column
        return f"{self.agg}({self.column or '*'})"


@dataclasses.dataclass
class Query:
    select: list[SelectItem] | None   # None == SELECT *
    table: str
    where: Expr | None = None
    limit: int | None = None

    @property
    def is_aggregate(self) -> bool:
        return bool(self.select) and any(s.agg for s in self.select)


class _Tokens:
    def __init__(self, sql: str):
        self.toks: list[tuple[str, str]] = []
        pos = 0
        while pos < len(sql):
            m = _TOKEN.match(sql, pos)
            if not m or m.end() == pos:
                if sql[pos:].strip():
                    raise ValueError(f"bad token at: {sql[pos:pos+20]!r}")
                break
            pos = m.end()
            for kind in ("num", "str", "ident", "op", "star"):
                v = m.group(kind)
                if v is not None:
                    if kind == "ident" and v.lower() in _KEYWORDS:
                        self.toks.append(("kw", v.lower()))
                    else:
                        self.toks.append((kind, v))
                    break
        self.i = 0

    def peek(self) -> tuple[str, str] | None:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> tuple[str, str]:
        t = self.peek()
        if t is None:
            raise ValueError("unexpected end of query")
        self.i += 1
        return t

    def accept(self, kind: str, value: str | None = None) -> bool:
        t = self.peek()
        if t and t[0] == kind and (value is None or t[1] == value):
            self.i += 1
            return True
        return False

    def expect(self, kind: str, value: str | None = None) -> str:
        t = self.next()
        if t[0] != kind or (value is not None and t[1] != value):
            raise ValueError(f"expected {value or kind}, got {t}")
        return t[1]


def parse(sql: str) -> Query:
    tk = _Tokens(sql)
    tk.expect("kw", "select")
    select: list[SelectItem] | None
    if tk.accept("op", "*") or tk.accept("star", "*"):
        select = None
    else:
        select = [_select_item(tk)]
        while tk.accept("op", ","):
            select.append(_select_item(tk))
    tk.expect("kw", "from")
    table = tk.expect("ident")
    where = None
    limit = None
    if tk.accept("kw", "where"):
        where = _expr(tk)
    if tk.accept("kw", "limit"):
        limit = int(tk.expect("num"))
    if tk.peek() is not None:
        raise ValueError(f"trailing tokens: {tk.peek()}")
    return Query(select, table, where, limit)


def _select_item(tk: _Tokens) -> SelectItem:
    t = tk.next()
    if t[0] == "kw" and t[1] in _AGGS:
        tk.expect("op", "(")
        if tk.accept("op", "*") or tk.accept("star", "*"):
            col = None
        else:
            col = tk.expect("ident")
        tk.expect("op", ")")
        return SelectItem(col, t[1])
    if t[0] == "ident":
        return SelectItem(t[1])
    raise ValueError(f"bad select item: {t}")


def _expr(tk: _Tokens) -> Expr:
    return _or(tk)


def _or(tk: _Tokens) -> Expr:
    left = _and(tk)
    while tk.accept("kw", "or"):
        left = BinOp("or", left, _and(tk))
    return left


def _and(tk: _Tokens) -> Expr:
    left = _unary(tk)
    while tk.accept("kw", "and"):
        left = BinOp("and", left, _unary(tk))
    return left


def _unary(tk: _Tokens) -> Expr:
    if tk.accept("kw", "not"):
        return Not(_unary(tk))
    return _cmp(tk)


def _cmp(tk: _Tokens) -> Expr:
    left = _add(tk)
    t = tk.peek()
    if t and t[0] == "kw" and t[1] == "is":
        tk.next()
        negate = tk.accept("kw", "not")
        tk.expect("kw", "null")
        return IsNull(left, negate=negate)
    if t and t[0] == "op" and t[1] in ("=", "==", "!=", "<>", "<", "<=", ">", ">="):
        tk.next()
        return BinOp(t[1], left, _add(tk))
    return left


def _add(tk: _Tokens) -> Expr:
    left = _mul(tk)
    while True:
        t = tk.peek()
        if t and t[0] == "op" and t[1] in ("+", "-"):
            tk.next()
            left = BinOp(t[1], left, _mul(tk))
        else:
            return left


def _mul(tk: _Tokens) -> Expr:
    left = _atom(tk)
    while True:
        t = tk.peek()
        if t and t[0] == "op" and t[1] in ("*", "/", "%"):
            tk.next()
            left = BinOp(t[1], left, _atom(tk))
        else:
            return left


def _atom(tk: _Tokens) -> Expr:
    t = tk.next()
    if t[0] == "op" and t[1] == "-":          # unary minus
        return BinOp("-", Lit(0), _atom(tk))
    if t[0] == "num":
        text = t[1]
        return Lit(float(text) if ("." in text or "e" in text.lower())
                   else int(text))
    if t[0] == "str":
        return Lit(t[1][1:-1].replace("''", "'"))
    if t[0] == "ident":
        return Col(t[1])
    if t[0] == "op" and t[1] == "(":
        e = _expr(tk)
        tk.expect("op", ")")
        return e
    raise ValueError(f"bad expression atom: {t}")
