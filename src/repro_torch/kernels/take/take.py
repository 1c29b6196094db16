"""Selection-vector row gather and validity-bitmap expand: wrappers of the
CUDA kernels in ``csrc/take.cu``, which replace the Pallas TPU kernels
``take_rows`` and ``bitmap_expand`` of ``src/repro/kernels/take/take.py``.

Each wrapper checks its arguments, then takes the plain PyTorch version for
tensors on the CPU and launches the kernel for tensors on a CUDA device, on
the current stream. ``<wrapper>.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import bitmap_expand_ref, take_ref

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
_VECTORS = (16, 8, 4, 2, 1)  # bytes a thread moves per load and store


def vector_bytes(row_bytes: int, *ptrs: int) -> int:
    """The widest vector that divides the row and every base address."""
    return next(v for v in _VECTORS
                if row_bytes % v == 0 and all(p % v == 0 for p in ptrs))


def take_rows(values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """out[i] = values[idx(indices[i])]: a row gather on (n_rows, width)
    values of any dtype with (n_out,) int32 indices, under the index rule of
    :mod:`.ref` (wrap negatives once, then clamp)."""
    if values.dim() != 2 or not values.is_contiguous():
        raise ValueError(f"take_rows: want contiguous 2-D values, got "
                         f"{tuple(values.shape)}")
    if indices.dtype != torch.int32 or indices.dim() != 1 or \
            not indices.is_contiguous() or indices.device != values.device:
        raise ValueError(f"take_rows: want contiguous 1-D int32 indices on "
                         f"{values.device}, got {indices.dtype} "
                         f"{tuple(indices.shape)} on {indices.device}")
    n, n_out = values.shape[0], indices.shape[0]
    if n == 0 and n_out:
        raise IndexError("take_rows: indices into a column of 0 rows")
    if not _build.on_cuda(values):
        return take_ref(values, indices)
    out = torch.empty((n_out, values.shape[1]), dtype=values.dtype,
                      device=values.device)
    row_bytes = values.shape[1] * values.element_size()
    if n_out and row_bytes:
        vec = vector_bytes(row_bytes, values.data_ptr(), out.data_ptr())
        _build.launch("take", "take_rows", [_P, _P, _P, _I64, _I64, _I64, _I32],
                      values.device, values.data_ptr(), indices.data_ptr(),
                      out.data_ptr(), n, n_out, row_bytes, vec)
        take_rows.launches += 1
    return out


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
