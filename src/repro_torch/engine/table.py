# Copy of src/repro/engine/table.py, kept numpy-only; change both copies together.
"""In-memory columnar tables + a dataset catalog (the DuckDB stand-in's
storage layer). A :class:`Table` is a list of same-schema record batches; a
:class:`Catalog` maps "dataset paths" to tables, mirroring the paper's
``init_scan(sql, dataset_path)`` signature.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np

from ..core.recordbatch import RecordBatch, batch_from_arrays, concat_batches
from ..core.schema import Schema, schema as make_schema


@dataclasses.dataclass
class Table:
    name: str
    schema: Schema
    batches: list[RecordBatch] = dataclasses.field(default_factory=list)

    @property
    def num_rows(self) -> int:
        return sum(b.num_rows for b in self.batches)

    @property
    def nbytes(self) -> int:
        return sum(b.nbytes for b in self.batches)

    def append(self, batch: RecordBatch) -> None:
        if batch.schema != self.schema:
            raise ValueError(f"schema mismatch appending to {self.name!r}")
        self.batches.append(batch)

    def scan(self) -> Iterator[RecordBatch]:
        yield from self.batches

    def to_batch(self) -> RecordBatch:
        return concat_batches(self.batches)


class Catalog:
    """dataset path -> table. One per server process."""

    def __init__(self) -> None:
        self._tables: dict[str, Table] = {}

    def register(self, path: str, table: Table) -> None:
        self._tables[path] = table

    def get(self, path: str) -> Table:
        if path not in self._tables:
            raise KeyError(f"no dataset registered at {path!r}")
        return self._tables[path]

    def __contains__(self, path: str) -> bool:
        return path in self._tables

    def paths(self) -> list[str]:
        return sorted(self._tables)


# ---------------------------------------------------------------------------
# synthetic datasets for benchmarks (paper: column-selectivity experiments)
# ---------------------------------------------------------------------------


def make_numeric_table(name: str, num_rows: int, num_cols: int,
                       batch_rows: int = 1 << 16, seed: int = 0,
                       dtype: str = "float64") -> Table:
    """A wide numeric table, the shape used for column-selectivity sweeps:
    ``SELECT c0, ..., ck FROM t`` with k swept to change result-set size."""
    rng = np.random.default_rng(seed)
    sch = make_schema(*[(f"c{i}", dtype) for i in range(num_cols)])
    table = Table(name, sch)
    left = num_rows
    while left > 0:
        n = min(batch_rows, left)
        arrays = [rng.standard_normal(n).astype(dtype) for _ in range(num_cols)]
        table.append(batch_from_arrays(sch, arrays))
        left -= n
    return table


def make_mixed_table(name: str, num_rows: int, batch_rows: int = 1 << 14,
                     seed: int = 0) -> Table:
    """id/int + floats + strings + nulls — exercises all three buffer kinds."""
    from ..core.recordbatch import batch_from_pydict

    rng = np.random.default_rng(seed)
    sch = make_schema(("id", "int64"), ("val", "float64"),
                      ("flag", "bool"), ("tag", "utf8"))
    table = Table(name, sch)
    tags = ["alpha", "beta", "gamma", "delta", None]
    row = 0
    while row < num_rows:
        n = min(batch_rows, num_rows - row)
        data = {
            "id": list(range(row, row + n)),
            "val": [float(v) if i % 17 else None
                    for i, v in enumerate(rng.standard_normal(n))],
            "flag": [bool(v) for v in rng.integers(0, 2, n)],
            "tag": [tags[i % len(tags)] for i in range(n)],
        }
        table.append(batch_from_pydict(sch, data))
        row += n
    return table
