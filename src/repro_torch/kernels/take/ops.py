"""Shape management around the take and bitmap-expand kernels.

Unlike the JAX wrappers, nothing is padded: the TPU's 128-lane width padding
and 1024-byte bitmap blocks are tiling of that chip, and the CUDA kernels
take any width and any bitmap length.
"""
from __future__ import annotations

from collections.abc import Mapping, Sequence

import numpy as np
import torch

from ...device import as_tensor
from .ref import bitmap_expand_ref, take_ref  # noqa: F401 (re-export the plain versions)
from .take import bitmap_expand, take_table

Column = torch.Tensor | np.ndarray


def take_column(values: Column, indices: Column) -> torch.Tensor:
    """Row-gather a 1-D or 2-D fixed-width column by a selection vector,
    on ``values``' device (a numpy column goes to the card). Indices are
    cast to int32, as the JAX wrapper does. On the card: one launch of the
    gather kernel with a table of this one column."""
    values = as_tensor(values).contiguous()
    indices = as_tensor(indices, values.device).to(torch.int32).contiguous()
    return take_table([values], indices)[0]


def take_columns(columns: Sequence[Column] | Mapping[str, Column],
                 indices: Column) -> list[torch.Tensor] | dict[str, torch.Tensor]:
    """Row-gather every projected column of a batch by one selection vector:
    a list of 1-D or 2-D fixed-width columns gives a list, a ``{name:
    column}`` dict a dict, each column bit for bit what :func:`take_column`
    gives it. Indices are cast to int32 once. On the card: one launch of the
    gather kernel for up to ``take.MAX_COLUMNS`` columns."""
    named = isinstance(columns, Mapping)
    cols = [as_tensor(c).contiguous() for c in (columns.values() if named else columns)]
    if not cols:
        return {} if named else []
    indices = as_tensor(indices, cols[0].device).to(torch.int32).contiguous()
    outs = take_table(cols, indices)
    return dict(zip(columns, outs)) if named else outs


def expand_validity(bitmap: torch.Tensor | np.ndarray, num_rows: int) -> torch.Tensor:
    """Arrow validity bitmap -> bool mask of length num_rows, on the
    bitmap's device."""
    bitmap = as_tensor(bitmap).to(torch.uint8).contiguous()
    if num_rows > 8 * bitmap.shape[0]:
        raise ValueError(f"expand_validity: {bitmap.shape[0]} bitmap bytes hold "
                         f"fewer than {num_rows} rows")
    return bitmap_expand(bitmap)[:num_rows]
