"""Device-side Thallus: landing record batches in device memory as torch
tensors. The port of :mod:`repro.core.device_transport`.

* **thallus path** (`batch_to_device`): every column buffer goes host→device
  *individually*, one copy straight from its numpy buffer; no staging buffer
  ever exists. The batch on the device is a dict of per-column tensors
  (logical assembly, like Arrow's zero-copy deserialize).
* **rpc path** (`batch_to_device_packed`): serialize into ONE contiguous
  host buffer (full copy), ship that single buffer, then take each column
  out *on the device* as a ``narrow(...).view(dtype)`` of it. This is the
  baseline whose cost the protocol deletes.

Both land identical column tensors, bit for bit. Beyond the JAX version, a
nullable column also lands its validity bitmap (``DeviceBatch.validity``),
so its null mask can be expanded on the device. One card has no mesh: the
JAX version's ``mesh``/``specs`` arguments and ``training_batch_specs`` come
with the sharding work.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..device import resolve
from . import serialize
from .recordbatch import RecordBatch


@dataclasses.dataclass
class DeviceBatch:
    """A record batch on the device: column name → tensor, plus the validity
    bitmap (uint8, LSB-first) of each column that has one."""

    columns: dict[str, torch.Tensor]
    num_rows: int
    validity: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.columns[name]


def _col_array(col) -> np.ndarray:
    if col.field.varlen:
        raise ValueError(
            f"column {col.field.name!r} is variable-length; device transport "
            "carries fixed-width (tokenized/numeric) columns")
    return col.values


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def batch_to_device(batch: RecordBatch,
                    device: torch.device | str | None = None) -> DeviceBatch:
    """Zero-staging path: one host→device copy per column buffer."""
    dev = resolve(device)
    cols: dict[str, torch.Tensor] = {}
    validity: dict[str, torch.Tensor] = {}
    for field, col in zip(batch.schema, batch.columns):
        cols[field.name] = torch.from_numpy(_col_array(col)).to(dev)
        if col.validity is not None:
            validity[field.name] = torch.from_numpy(col.validity).to(dev)
    return DeviceBatch(cols, batch.num_rows, validity)


def batch_to_device_packed(batch: RecordBatch,
                           device: torch.device | str | None = None) -> DeviceBatch:
    """Baseline path: pack → single transfer → on-device slice-out."""
    for col in batch.columns:
        _col_array(col)
    wire = serialize.pack(batch)  # host staging copy (the overhead)
    dev_wire = torch.from_numpy(wire).to(resolve(device))

    # Recover per-buffer extents on host from the header (metadata only).
    hlen = int(np.frombuffer(wire[:8].tobytes(), np.uint64)[0])
    header = json.loads(wire[8 : 8 + hlen].tobytes().decode("utf-8"))
    pos = 8 + hlen + (-hlen) % 8

    cols: dict[str, torch.Tensor] = {}
    validity: dict[str, torch.Tensor] = {}
    bufs = header["buffers"]
    bi = 0
    for field in batch.schema:
        # values / offsets / validity: 3 buffers per column, each padded to 8
        starts = []
        for meta in bufs[bi : bi + 3]:
            starts.append(pos)
            pos += meta["nbytes"] + (-meta["nbytes"]) % 8
        values, _, valid = bufs[bi : bi + 3]
        cols[field.name] = dev_wire.narrow(0, starts[0], values["nbytes"]).view(
            _torch_dtype(np.dtype(values["dtype"])))
        if valid["nbytes"]:
            validity[field.name] = dev_wire.narrow(0, starts[2], valid["nbytes"])
        bi += 3
    return DeviceBatch(cols, batch.num_rows, validity)
