"""Selection-vector row gather and validity-bitmap expand: wrappers of the
CUDA kernels in ``csrc/take.cu``, which replace the Pallas TPU kernels
``take_rows`` and ``bitmap_expand`` of ``src/repro/kernels/take/take.py``.

Each wrapper checks its arguments, then takes the plain PyTorch version for
tensors on the CPU and launches the kernel for tensors on a CUDA device, on
the current stream. ``<wrapper>.launches`` counts the launches; the one
gather kernel's are counted on ``take_rows.launches``, whichever of
:func:`take_table` and :func:`take_rows` launched it.
"""
from __future__ import annotations

import ctypes
import struct
from collections.abc import Sequence

import torch

from .. import _build
from .ref import bitmap_expand_ref, take_ref

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
MAX_COLUMNS = 16  # columns per launch: kMaxCols in csrc/take.cu
_FIELDS = 5  # per column: source, output, rows, row bytes, vector bytes
_TABLE_ARGS = [ctypes.c_char_p, _I32, _P, _I64]


def vector_bytes(row_bytes: int, *ptrs: int) -> int:
    """The widest vector (16, 8, 4, 2 or 1 bytes) that divides the row and
    every base address: the lowest set bit of their bitwise or."""
    bits = row_bytes
    for p in ptrs:
        bits |= p
    return min(bits & -bits, 16) if bits else 16


def take_table(columns: Sequence[torch.Tensor],
               indices: torch.Tensor) -> list[torch.Tensor]:
    """out_c[i] = c[idx(indices[i])] for every column c: a row gather of
    contiguous 1-D or 2-D columns of any dtype on one device, under one
    (n_out,) int32 index vector and the index rule of :mod:`.ref` (wrap
    negatives once, then clamp, against each column's own rows). Each output
    has its column's dtype and trailing shape and its own storage. On the
    card, one launch gathers up to ``MAX_COLUMNS`` columns."""
    if indices.dtype != torch.int32 or indices.dim() != 1 or not indices.is_contiguous():
        raise ValueError(f"take_rows: want contiguous 1-D int32 indices, got "
                         f"{indices.dtype} {tuple(indices.shape)}")
    device, n_out = indices.device, indices.shape[0]
    for c in columns:
        if c.dim() not in (1, 2) or not c.is_contiguous() or c.device != device:
            raise ValueError(f"take_rows: want contiguous 1-D or 2-D columns on "
                             f"{device}, got {c.dtype} {tuple(c.shape)} on {c.device}")
        if c.shape[0] == 0 and n_out:
            raise IndexError("take_rows: indices into a column of 0 rows")
    if not _build.on_cuda(indices):
        return [take_ref(c, indices) for c in columns]
    outs = [c.new_empty((n_out,) if c.dim() == 1 else (n_out, c.shape[1])) for c in columns]
    _gather(columns, outs, indices)
    return outs


def _gather(columns, outs, indices) -> None:
    """Launch the gather kernel, once per ``MAX_COLUMNS`` columns, into
    ``outs``: checked columns and, for each, a contiguous output of
    ``len(indices)`` rows of its row bytes on the card, at any address. Each
    column's vector is the widest that divides its row and both its base
    addresses."""
    n_out, table = indices.shape[0], []
    for c, out in zip(columns, outs):
        row_bytes = (c.shape[1] if c.dim() == 2 else 1) * c.element_size()
        if row_bytes >= 1 << 31:
            raise ValueError(f"take_rows: rows of {row_bytes} bytes; the kernel "
                             f"takes rows below 2^31 bytes")
        if n_out and row_bytes:
            src, dst = c.data_ptr(), out.data_ptr()
            table += (src, dst, c.shape[0], row_bytes, vector_bytes(row_bytes, src, dst))
    step = _FIELDS * MAX_COLUMNS
    for k in range(0, len(table), step):
        chunk = table[k:k + step]
        _build.launch("take", "take_columns", _TABLE_ARGS, indices.device,
                      struct.pack(f"{len(chunk)}q", *chunk), len(chunk) // _FIELDS,
                      indices.data_ptr(), n_out)
        take_rows.launches += 1


def take_rows(values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """out[i] = values[idx(indices[i])]: a row gather on (n_rows, width)
    values of any dtype with (n_out,) int32 indices, under the index rule of
    :mod:`.ref` (wrap negatives once, then clamp); :func:`take_table` of one
    column."""
    if values.dim() != 2:
        raise ValueError(f"take_rows: want contiguous 2-D values, got "
                         f"{tuple(values.shape)}")
    return take_table([values], indices)[0]


def bitmap_expand(bitmap: torch.Tensor) -> torch.Tensor:
    """LSB-packed bits -> bool. bitmap: (n_bytes,) uint8 -> (8 * n_bytes,)
    bool."""
    if bitmap.dtype != torch.uint8 or bitmap.dim() != 1 or not bitmap.is_contiguous():
        raise ValueError(f"bitmap_expand: want a contiguous 1-D uint8 tensor, "
                         f"got {bitmap.dtype} {tuple(bitmap.shape)}")
    n_bytes = bitmap.shape[0]
    if not _build.on_cuda(bitmap):
        return bitmap_expand_ref(bitmap, 8 * n_bytes)
    out = torch.empty(8 * n_bytes, dtype=torch.bool, device=bitmap.device)
    if n_bytes:
        _build.launch("take", "bitmap_expand", [_P, _P, _I64], bitmap.device,
                      bitmap.data_ptr(), out.data_ptr(), n_bytes)
        bitmap_expand.launches += 1
    return out


take_rows.launches = 0
bitmap_expand.launches = 0
