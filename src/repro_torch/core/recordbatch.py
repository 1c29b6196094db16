# Copy of src/repro/core/recordbatch.py, kept numpy-only; change both copies together.
"""Arrow-like columnar record batches.

The memory layout mirrors Apache Arrow:

* every column owns up to three buffers — **values**, **offsets** (int32,
  var-length types only) and **validity** (LSB-packed bitmap, 1 bit/row,
  ``None`` when the column has no nulls);
* a :class:`RecordBatch` is a schema + a tuple of columns sharing a row count.

Buffers are plain ``np.ndarray``\\ s so that "zero-copy" is a checkable
property: functions in this package either return *views* (``arr.base is not
None``) or fresh copies, and the tests assert which one.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np

from .schema import Field, Schema, is_varlen, numpy_dtype

# ---------------------------------------------------------------------------
# validity bitmaps (Arrow LSB bit order)
# ---------------------------------------------------------------------------


def pack_validity(mask: np.ndarray) -> np.ndarray:
    """bool[n] -> LSB-packed uint8[ceil(n/8)] (Arrow bit order)."""
    mask = np.asarray(mask, dtype=np.bool_)
    return np.packbits(mask, bitorder="little")


def unpack_validity(bitmap: np.ndarray, num_rows: int) -> np.ndarray:
    """LSB-packed uint8 -> bool[num_rows]."""
    bits = np.unpackbits(np.asarray(bitmap, dtype=np.uint8), bitorder="little")
    return bits[:num_rows].astype(np.bool_)


# ---------------------------------------------------------------------------
# columns
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Column:
    """One Arrow-layout column.

    values:   fixed-width -> dtype[num_rows]; varlen -> uint8[total_bytes]
    offsets:  varlen only -> int32[num_rows + 1], offsets[0] == 0
    validity: uint8[ceil(num_rows/8)] LSB bitmap, or None (all valid)
    """

    field: Field
    values: np.ndarray
    offsets: np.ndarray | None = None
    validity: np.ndarray | None = None

    def __post_init__(self) -> None:
        if self.field.varlen:
            if self.offsets is None:
                raise ValueError(f"varlen column {self.field.name!r} needs offsets")
            if self.offsets.dtype != np.int32:
                self.offsets = self.offsets.astype(np.int32)
        elif self.offsets is not None:
            raise ValueError(f"fixed column {self.field.name!r} must not have offsets")

    @property
    def num_rows(self) -> int:
        if self.field.varlen:
            return int(len(self.offsets) - 1)
        return int(len(self.values))

    @property
    def nbytes(self) -> int:
        n = self.values.nbytes
        if self.offsets is not None:
            n += self.offsets.nbytes
        if self.validity is not None:
            n += self.validity.nbytes
        return n

    def valid_mask(self) -> np.ndarray:
        if self.validity is None:
            return np.ones(self.num_rows, dtype=np.bool_)
        return unpack_validity(self.validity, self.num_rows)

    def null_count(self) -> int:
        return int(self.num_rows - self.valid_mask().sum())

    # -- python-value access (slow path; engine uses buffers directly) ----
    def to_pylist(self) -> list:
        mask = self.valid_mask()
        out: list = []
        if self.field.varlen:
            raw = self.values.tobytes()
            for i in range(self.num_rows):
                if not mask[i]:
                    out.append(None)
                    continue
                lo, hi = int(self.offsets[i]), int(self.offsets[i + 1])
                b = raw[lo:hi]
                out.append(b.decode("utf-8") if self.field.type == "utf8" else b)
        else:
            for i in range(self.num_rows):
                out.append(self.values[i].item() if mask[i] else None)
        return out

    def take(self, indices: np.ndarray) -> "Column":
        """Gather rows by index (copies — this is the kernel hot spot)."""
        indices = np.asarray(indices, dtype=np.int64)
        mask = self.valid_mask()[indices]
        validity = pack_validity(mask) if not mask.all() else None
        if not self.field.varlen:
            return Column(self.field, self.values[indices], validity=validity)
        lens = (self.offsets[1:] - self.offsets[:-1])[indices]
        new_off = np.zeros(len(indices) + 1, dtype=np.int32)
        np.cumsum(lens, out=new_off[1:])
        new_vals = np.empty(int(new_off[-1]), dtype=np.uint8)
        for j, i in enumerate(indices):
            lo, hi = int(self.offsets[i]), int(self.offsets[i + 1])
            new_vals[new_off[j] : new_off[j + 1]] = self.values[lo:hi]
        return Column(self.field, new_vals, offsets=new_off, validity=validity)


def column_from_pylist(field: Field, data: Sequence) -> Column:
    """Build a column from python values (None -> null)."""
    mask = np.array([v is not None for v in data], dtype=np.bool_)
    validity = None if mask.all() else pack_validity(mask)
    if field.varlen:
        chunks: list[bytes] = []
        offsets = np.zeros(len(data) + 1, dtype=np.int32)
        total = 0
        for i, v in enumerate(data):
            b = b"" if v is None else (v.encode("utf-8") if isinstance(v, str) else bytes(v))
            chunks.append(b)
            total += len(b)
            offsets[i + 1] = total
        values = np.frombuffer(b"".join(chunks), dtype=np.uint8).copy() if total else np.zeros(0, np.uint8)
        return Column(field, values, offsets=offsets, validity=validity)
    dtype = numpy_dtype(field.type)
    values = np.array([dtype.type(0) if v is None else v for v in data], dtype=dtype)
    return Column(field, values, validity=validity)


# ---------------------------------------------------------------------------
# record batches
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RecordBatch:
    schema: Schema
    columns: tuple[Column, ...]

    def __post_init__(self) -> None:
        if len(self.schema) != len(self.columns):
            raise ValueError("schema/columns arity mismatch")
        rows = {c.num_rows for c in self.columns}
        if len(rows) > 1:
            raise ValueError(f"ragged columns: row counts {sorted(rows)}")

    @property
    def num_rows(self) -> int:
        return self.columns[0].num_rows if self.columns else 0

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.columns)

    def column(self, key: int | str) -> Column:
        if isinstance(key, str):
            key = self.schema.index(key)
        return self.columns[key]

    def select(self, names: Sequence[str]) -> "RecordBatch":
        """Column projection — zero-copy (shares buffers)."""
        idx = [self.schema.index(n) for n in names]
        return RecordBatch(self.schema.select(names), tuple(self.columns[i] for i in idx))

    def take(self, indices: np.ndarray) -> "RecordBatch":
        return RecordBatch(self.schema, tuple(c.take(indices) for c in self.columns))

    def slice(self, start: int, length: int) -> "RecordBatch":
        """Row slice. Fixed-width columns are zero-copy views; varlen values
        stay shared with re-based offsets."""
        stop = start + length
        cols = []
        for c in self.columns:
            mask = c.valid_mask()[start:stop]
            validity = None if mask.all() else pack_validity(mask)
            if c.field.varlen:
                off = c.offsets[start : stop + 1]
                cols.append(Column(c.field, c.values[int(off[0]) : int(off[-1])],
                                   offsets=(off - off[0]).astype(np.int32), validity=validity))
            else:
                cols.append(Column(c.field, c.values[start:stop], validity=validity))
        return RecordBatch(self.schema, tuple(cols))

    def to_pydict(self) -> dict[str, list]:
        return {f.name: c.to_pylist() for f, c in zip(self.schema, self.columns)}

    def __iter__(self) -> Iterator[Column]:
        return iter(self.columns)


def batch_from_pydict(sch: Schema, data: dict[str, Sequence]) -> RecordBatch:
    cols = tuple(column_from_pylist(f, data[f.name]) for f in sch)
    return RecordBatch(sch, cols)


def batch_from_arrays(sch: Schema, arrays: Sequence[np.ndarray]) -> RecordBatch:
    """Zero-copy wrap of numpy arrays as fixed-width columns."""
    cols = []
    for f, a in zip(sch, arrays):
        if f.varlen:
            raise ValueError("batch_from_arrays is for fixed-width columns")
        cols.append(Column(f, np.ascontiguousarray(a)))
    return RecordBatch(sch, tuple(cols))


def concat_batches(batches: Sequence[RecordBatch]) -> RecordBatch:
    """Concatenate batches row-wise (copies; used by eager collectors)."""
    if not batches:
        raise ValueError("no batches")
    sch = batches[0].schema
    cols = []
    for ci, f in enumerate(sch):
        parts = [b.columns[ci] for b in batches]
        masks = np.concatenate([c.valid_mask() for c in parts])
        validity = None if masks.all() else pack_validity(masks)
        if f.varlen:
            vals = np.concatenate([c.values for c in parts]) if parts else np.zeros(0, np.uint8)
            offs = [np.zeros(1, np.int32)]
            base = 0
            for c in parts:
                offs.append((c.offsets[1:] + base).astype(np.int32))
                base += int(c.offsets[-1])
            cols.append(Column(f, vals, offsets=np.concatenate(offs), validity=validity))
        else:
            cols.append(Column(f, np.concatenate([c.values for c in parts]), validity=validity))
    return RecordBatch(sch, tuple(cols))
