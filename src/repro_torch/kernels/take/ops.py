"""Shape management around the take and bitmap-expand kernels.

Unlike the JAX wrappers, nothing is padded: the TPU's 128-lane width padding
and 1024-byte bitmap blocks are tiling of that chip, and the CUDA kernels
take any width and any bitmap length.
"""
from __future__ import annotations

import numpy as np
import torch

from ...device import as_tensor
from .ref import bitmap_expand_ref, take_ref  # noqa: F401 (re-export the plain versions)
from .take import bitmap_expand, take_rows


def take_column(values: torch.Tensor | np.ndarray,
                indices: torch.Tensor | np.ndarray) -> torch.Tensor:
    """Row-gather a 1-D or 2-D fixed-width column by a selection vector,
    on ``values``' device (a numpy column goes to the card). Indices are
    cast to int32, as the JAX wrapper does."""
    values = as_tensor(values).contiguous()
    indices = as_tensor(indices, values.device).to(torch.int32).contiguous()
    squeeze = values.dim() == 1
    out = take_rows(values[:, None] if squeeze else values, indices)
    return out[:, 0] if squeeze else out


def expand_validity(bitmap: torch.Tensor | np.ndarray, num_rows: int) -> torch.Tensor:
    """Arrow validity bitmap -> bool mask of length num_rows, on the
    bitmap's device."""
    bitmap = as_tensor(bitmap).to(torch.uint8).contiguous()
    if num_rows > 8 * bitmap.shape[0]:
        raise ValueError(f"expand_validity: {bitmap.shape[0]} bitmap bytes hold "
                         f"fewer than {num_rows} rows")
    return bitmap_expand(bitmap)[:num_rows]
