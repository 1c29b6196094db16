# Copy of src/repro/core/serialize.py, kept numpy-only; change both copies together.
"""Baseline serialization: the cost Thallus deletes.

TCP/IP-based transports need **one contiguous buffer**, so the baseline path
must copy every column buffer into a staging area ("numerous memory copies")
— the paper measures this at ~30 % of the whole RPC duration. Deserialization
on the receiver is ~free because Arrow reconstructs columns as *views* into
the received buffer.

Wire format (little-endian):

    [u64 header_len][header json utf-8][padding to 8][buffer 0][pad8][buffer 1]...

The header carries schema, num_rows, and per-buffer (dtype, nbytes) — i.e.
exactly the metadata a :class:`~repro.core.bulk.BulkHandle` would carry, but
here it is *in-band* with the data.
"""
from __future__ import annotations

import json

import numpy as np

from .bulk import _KINDS  # noqa: F401  (shared buffer-order convention)
from .recordbatch import Column, RecordBatch
from .schema import Schema

_ALIGN = 8
_EMPTY_U8 = np.zeros(0, dtype=np.uint8)


def _pad(n: int) -> int:
    return (-n) % _ALIGN


def _batch_buffers(batch: RecordBatch) -> list[np.ndarray]:
    bufs: list[np.ndarray] = []
    for col in batch.columns:
        bufs.append(col.values)
        bufs.append(col.offsets if col.offsets is not None else _EMPTY_U8)
        bufs.append(col.validity if col.validity is not None else _EMPTY_U8)
    return bufs


def serialized_size(batch: RecordBatch) -> int:
    header = _header_bytes(batch)
    n = 8 + len(header) + _pad(len(header))
    for buf in _batch_buffers(batch):
        n += buf.nbytes + _pad(buf.nbytes)
    return n


def _header_bytes(batch: RecordBatch) -> bytes:
    bufs = _batch_buffers(batch)
    header = {
        "schema": batch.schema.to_dict(),
        "num_rows": batch.num_rows,
        "buffers": [{"dtype": str(b.dtype), "nbytes": int(b.nbytes)} for b in bufs],
    }
    return json.dumps(header).encode("utf-8")


def pack(batch: RecordBatch) -> np.ndarray:
    """Serialize into ONE contiguous uint8 buffer. This performs a full copy
    of every column buffer — the serialization overhead under study."""
    header = _header_bytes(batch)
    bufs = _batch_buffers(batch)
    out = np.empty(serialized_size(batch), dtype=np.uint8)
    pos = 0
    out[pos : pos + 8] = np.frombuffer(np.uint64(len(header)).tobytes(), np.uint8)
    pos += 8
    out[pos : pos + len(header)] = np.frombuffer(header, np.uint8)
    pos += len(header) + _pad(len(header))
    for buf in bufs:
        raw = buf.view(np.uint8).reshape(-1) if buf.nbytes else _EMPTY_U8
        out[pos : pos + raw.nbytes] = raw      # <-- the memcpy being deleted
        pos += raw.nbytes + _pad(raw.nbytes)
    return out


def unpack(wire: np.ndarray, zero_copy: bool = True) -> RecordBatch:
    """Deserialize. With ``zero_copy=True`` (Arrow semantics) every column is
    a *view* into ``wire`` — this is the ~0.0004 %-of-duration operation the
    paper measures."""
    wire = wire.view(np.uint8)
    hlen = int(np.frombuffer(wire[:8].tobytes(), np.uint64)[0])
    pos = 8
    header = json.loads(wire[pos : pos + hlen].tobytes().decode("utf-8"))
    pos += hlen + _pad(hlen)
    schema = Schema.from_dict(header["schema"])
    segments: list[np.ndarray] = []
    for meta in header["buffers"]:
        nbytes = meta["nbytes"]
        raw = wire[pos : pos + nbytes]
        if not zero_copy:
            raw = raw.copy()
        segments.append(raw.view(np.dtype(meta["dtype"])))
        pos += nbytes + _pad(nbytes)
    cols = []
    it = iter(segments)
    for field in schema:
        values, offsets, validity = next(it), next(it), next(it)
        cols.append(Column(
            field,
            values,
            offsets=offsets if field.varlen else None,
            validity=validity if validity.nbytes else None,
        ))
    return RecordBatch(schema, tuple(cols))
