# Copy of src/repro/core/bulk.py, kept numpy-only; change both copies together.
"""Bulk handles: the scatter-gather descriptor core of Thallus.

In the paper, the server allocates ``3 * ncols`` *segments* — for the i-th
column its data, offset and null buffers map to segments ``3i``, ``3i+1``,
``3i+2`` — and *exposes* them as a read-only Thallium bulk. The bulk handle
is a small serializable descriptor for an RDMA-ready pinned region list; the
actual bytes never touch the RPC path.

Here a :class:`BulkHandle` holds the descriptor table (shapes/dtypes/sizes —
pure metadata) plus, on the *owning* side, references to the live numpy
buffers. ``expose()`` performs **no copies** — that is the whole point — and
the tests assert the exposed segments alias the batch's buffers.
"""
from __future__ import annotations

import dataclasses
import itertools
import uuid as _uuid
from typing import Sequence

import numpy as np

from .recordbatch import Column, RecordBatch
from .schema import Schema

_EMPTY_U8 = np.zeros(0, dtype=np.uint8)


@dataclasses.dataclass(frozen=True)
class SegmentDesc:
    """Metadata for one exposed memory segment (control-plane safe)."""

    nbytes: int
    dtype: str            # numpy dtype string of the underlying buffer
    kind: str             # "values" | "offsets" | "validity"
    column_index: int

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "SegmentDesc":
        return SegmentDesc(**d)


@dataclasses.dataclass
class BulkHandle:
    """Descriptor for an exposed scatter-gather region list.

    ``segments`` (the live buffers) is only populated on the side that owns
    the memory; what crosses the control plane is ``descs`` + ``handle_id``
    (see :meth:`remote_view`). This mirrors Thallium's bulk semantics where
    the handle is serializable but dereferencing it requires an RDMA op.
    """

    handle_id: str
    descs: tuple[SegmentDesc, ...]
    mode: str  # "read_only" | "write_only" | "read_write"
    segments: tuple[np.ndarray, ...] | None = None
    registered: bool = False  # segments live in a pre-registered (pinned) pool

    @property
    def total_bytes(self) -> int:
        return sum(d.nbytes for d in self.descs)

    @property
    def num_segments(self) -> int:
        return len(self.descs)

    def remote_view(self) -> "BulkHandle":
        """The metadata-only form that is legal to ship over RPC."""
        return BulkHandle(self.handle_id, self.descs, self.mode, segments=None)

    def is_local(self) -> bool:
        return self.segments is not None


# kind layout order per column: 3i -> values, 3i+1 -> offsets, 3i+2 -> validity
_KINDS = ("values", "offsets", "validity")


def expose_batch(batch: RecordBatch, mode: str = "read_only") -> BulkHandle:
    """Expose a record batch's buffers as a bulk — ZERO copies.

    Missing buffers (no offsets on fixed-width columns, no validity bitmap)
    are exposed as 0-byte segments so the ``3*ncols`` indexing from the paper
    stays intact and the client can allocate one-to-one.
    """
    segs: list[np.ndarray] = []
    descs: list[SegmentDesc] = []
    for ci, col in enumerate(batch.columns):
        bufs = (col.values,
                col.offsets if col.offsets is not None else _EMPTY_U8,
                col.validity if col.validity is not None else _EMPTY_U8)
        for k, buf in zip(_KINDS, bufs):
            segs.append(buf)
            descs.append(SegmentDesc(int(buf.nbytes), str(buf.dtype), k, ci))
    return BulkHandle(str(_uuid.uuid4()), tuple(descs), mode, segments=tuple(segs))


def size_vectors(batch: RecordBatch) -> tuple[list[int], list[int], list[int]]:
    """The paper's three size vectors (data/offset/null bytes per column)."""
    data, offs, nulls = [], [], []
    for col in batch.columns:
        data.append(int(col.values.nbytes))
        offs.append(int(col.offsets.nbytes) if col.offsets is not None else 0)
        nulls.append(int(col.validity.nbytes) if col.validity is not None else 0)
    return data, offs, nulls


def allocate_like(descs: Sequence[SegmentDesc], pin: bool = False) -> BulkHandle:
    """Client side: allocate a write-only local bulk with the same layout as
    a remote handle ("allocate a similar layout of buffers as on the server").

    ``pin=True`` faults the pages in at allocation time (zero-fill), the way
    RDMA registration must before the NIC can target the buffer — the honest
    per-batch cost a registered buffer pool amortizes away."""
    alloc = np.zeros if pin else np.empty
    segs = tuple(alloc(d.nbytes // np.dtype(d.dtype).itemsize, dtype=d.dtype)
                 for d in descs)
    return BulkHandle(str(_uuid.uuid4()), tuple(descs), "write_only", segments=segs)


def assemble_batch(schema: Schema, num_rows: int,
                   segments: Sequence[np.ndarray]) -> RecordBatch:
    """Receiver-side zero-copy assembly: buffers + sizes + dtypes -> columns
    -> batch. No data movement — just view wiring (Arrow deserialization)."""
    cols = []
    it = iter(segments)
    for field in schema:
        values, offsets, validity = next(it), next(it), next(it)
        if not field.varlen:
            values = values.view(field.value_dtype)
            offsets = None
        else:
            offsets = offsets.view(np.int32)
        validity = validity if validity.nbytes else None
        cols.append(Column(field, values, offsets=offsets, validity=validity))
    leftover = list(itertools.islice(it, 1))
    if leftover:
        raise ValueError("segment count does not match schema")
    return RecordBatch(schema, tuple(cols))
