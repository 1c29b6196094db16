# Copy of src/repro/engine/expressions.py, kept numpy-only; change both copies together.
"""Vectorized expression AST evaluated batch-at-a-time over RecordBatches.

Supports column refs, literals, arithmetic, comparisons, boolean logic, and
NULL-aware three-valued semantics where it matters for filters (a NULL
comparison never passes a WHERE clause, like SQL).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from ..core.recordbatch import RecordBatch


class Expr:
    def evaluate(self, batch: RecordBatch) -> tuple[np.ndarray, np.ndarray]:
        """Returns (values, valid_mask)."""
        raise NotImplementedError

    def columns(self) -> set[str]:
        raise NotImplementedError


@dataclasses.dataclass
class Col(Expr):
    name: str

    def evaluate(self, batch: RecordBatch):
        col = batch.column(self.name)
        if col.field.varlen:
            # materialize strings as object array for comparisons
            vals = np.array(
                [v if v is not None else "" for v in col.to_pylist()], dtype=object)
        else:
            vals = col.values
        return vals, col.valid_mask()

    def columns(self) -> set[str]:
        return {self.name}


@dataclasses.dataclass
class Lit(Expr):
    value: Any

    def evaluate(self, batch: RecordBatch):
        n = batch.num_rows
        if isinstance(self.value, str):
            vals = np.array([self.value] * n, dtype=object)
        else:
            vals = np.full(n, self.value)
        return vals, np.ones(n, dtype=np.bool_)

    def columns(self) -> set[str]:
        return set()


_ARITH = {
    "+": np.add, "-": np.subtract, "*": np.multiply, "/": np.divide,
    "%": np.mod,
}
_CMP = {
    "=": np.equal, "==": np.equal, "!=": np.not_equal, "<>": np.not_equal,
    "<": np.less, "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal,
}


@dataclasses.dataclass
class BinOp(Expr):
    op: str
    left: Expr
    right: Expr

    def evaluate(self, batch: RecordBatch):
        lv, lm = self.left.evaluate(batch)
        rv, rm = self.right.evaluate(batch)
        valid = lm & rm
        if self.op in _ARITH:
            with np.errstate(divide="ignore", invalid="ignore"):
                return _ARITH[self.op](lv, rv), valid
        if self.op in _CMP:
            return _CMP[self.op](lv, rv), valid
        if self.op == "and":
            return (lv.astype(bool) & rv.astype(bool)), valid
        if self.op == "or":
            # SQL OR: true OR null -> true
            out = lv.astype(bool) | rv.astype(bool)
            valid = valid | (lm & lv.astype(bool)) | (rm & rv.astype(bool))
            return out, valid
        raise ValueError(f"unknown op {self.op!r}")

    def columns(self) -> set[str]:
        return self.left.columns() | self.right.columns()


@dataclasses.dataclass
class Not(Expr):
    inner: Expr

    def evaluate(self, batch: RecordBatch):
        v, m = self.inner.evaluate(batch)
        return ~v.astype(bool), m

    def columns(self) -> set[str]:
        return self.inner.columns()


@dataclasses.dataclass
class IsNull(Expr):
    inner: Expr
    negate: bool = False

    def evaluate(self, batch: RecordBatch):
        _, m = self.inner.evaluate(batch)
        out = m if self.negate else ~m
        return out, np.ones(len(m), dtype=np.bool_)

    def columns(self) -> set[str]:
        return self.inner.columns()


def filter_mask(expr: Expr, batch: RecordBatch) -> np.ndarray:
    """SQL WHERE semantics: row passes iff predicate is TRUE and not NULL."""
    vals, valid = expr.evaluate(batch)
    return vals.astype(bool) & valid
