# Copy of src/repro/engine/executor.py, kept numpy-only; change both copies together.
"""Vectorized batch-at-a-time executor + streaming reader.

``Engine.execute(sql, dataset)`` returns a :class:`QueryReader` implementing
the ``RecordBatchReader`` protocol the Thallus server iterates — the same
streaming-cursor shape the paper builds over DuckDB's chunked results, with
the DuckDB→Arrow conversion replaced by engine-native Arrow batches (our
"C Data Interface" handoff is numpy views — zero-copy by construction).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from ..core.recordbatch import (Column, RecordBatch, batch_from_arrays,
                                pack_validity)
from ..core.schema import Field, Schema
from .expressions import filter_mask
from .sql import Query, SelectItem, parse
from .table import Catalog, Table


class QueryReader:
    """Streaming cursor over query results (RecordBatchReader protocol)."""

    def __init__(self, schema: Schema, batches: Iterator[RecordBatch]):
        self.schema = schema
        self._it = batches
        self.batches_read = 0

    def read_next(self) -> RecordBatch | None:
        try:
            b = next(self._it)
        except StopIteration:
            return None
        self.batches_read += 1
        return b

    def read_all(self) -> list[RecordBatch]:
        out = []
        while (b := self.read_next()) is not None:
            out.append(b)
        return out


class Engine:
    """The DuckDB stand-in: parse → plan → stream batches."""

    def __init__(self, catalog: Catalog | None = None):
        self.catalog = catalog or Catalog()

    def register(self, path: str, table: Table) -> None:
        self.catalog.register(path, table)

    # -- QueryEngine protocol ------------------------------------------------
    def execute(self, sql: str, dataset: str) -> QueryReader:
        query = parse(sql)
        table = self.catalog.get(dataset)
        if query.is_aggregate:
            return self._execute_aggregate(query, table)
        return self._execute_scan(query, table)

    def estimate_batches(self, sql: str, dataset: str) -> int | None:
        """Planner statistics: the exact result-batch count when it is known
        without evaluation (projection-only scans, aggregates), else None —
        the caller must fall back to draining a planning reader. Filters and
        limits can drop batches, so those shapes are not estimable."""
        query = parse(sql)
        table = self.catalog.get(dataset)
        if query.is_aggregate:
            return 1
        if query.where is None and query.limit is None:
            return len(table.batches)
        return None

    # -- plain scans: project + filter + limit, streamed ---------------------
    def _execute_scan(self, query: Query, table: Table) -> QueryReader:
        names = (list(table.schema.names) if query.select is None
                 else [s.column for s in query.select])
        out_schema = table.schema.select(names)

        def gen() -> Iterator[RecordBatch]:
            remaining = query.limit
            for batch in table.scan():
                if query.where is not None:
                    mask = filter_mask(query.where, batch)
                    if not mask.any():
                        continue
                    if mask.all():
                        out = batch.select(names)       # zero-copy projection
                    else:
                        out = batch.take(np.flatnonzero(mask)).select(names)
                else:
                    out = batch.select(names)           # zero-copy projection
                if remaining is not None:
                    if remaining <= 0:
                        return
                    if out.num_rows > remaining:
                        out = out.slice(0, remaining)
                    remaining -= out.num_rows
                yield out

        return QueryReader(out_schema, gen())

    # -- aggregates: single output batch --------------------------------------
    def _execute_aggregate(self, query: Query, table: Table) -> QueryReader:
        accs = [_Accumulator(item) for item in query.select]
        for batch in table.scan():
            if query.where is not None:
                mask = filter_mask(query.where, batch)
            else:
                mask = None
            for acc in accs:
                acc.update(batch, mask)
        fields, arrays = [], []
        for acc in accs:
            v = acc.result()
            dt = "int64" if isinstance(v, (int, np.integer)) else "float64"
            fields.append(Field(acc.item.output_name, dt, nullable=False))
            arrays.append(np.array([v], dtype=dt))
        sch = Schema(tuple(fields))
        out = batch_from_arrays(sch, arrays)
        return QueryReader(sch, iter([out]))


@dataclasses.dataclass
class _Accumulator:
    item: SelectItem
    count: int = 0
    total: float = 0.0
    lo: float = float("inf")
    hi: float = float("-inf")

    def update(self, batch: RecordBatch, mask: np.ndarray | None) -> None:
        if self.item.column is None:        # count(*)
            self.count += int(mask.sum()) if mask is not None else batch.num_rows
            return
        col = batch.column(self.item.column)
        valid = col.valid_mask()
        if mask is not None:
            valid = valid & mask
        if not valid.any():
            return
        vals = col.values[valid]
        self.count += int(valid.sum())
        if self.item.agg in ("sum", "avg"):
            self.total += float(vals.sum())
        if self.item.agg == "min":
            self.lo = min(self.lo, float(vals.min()))
        if self.item.agg == "max":
            self.hi = max(self.hi, float(vals.max()))

    def result(self):
        agg = self.item.agg
        if agg == "count":
            return self.count
        if agg == "sum":
            return self.total
        if agg == "avg":
            return self.total / self.count if self.count else float("nan")
        if agg == "min":
            return self.lo
        if agg == "max":
            return self.hi
        raise ValueError(agg)
