"""Plain PyTorch versions of the selection-vector kernels.

The index rule is pinned to the JAX reference (``values[indices]`` in jnp,
:func:`repro.kernels.take.ref.take_ref`, and its interpret-mode kernel): a
negative index wraps once (``i + n``), then the index is clamped to
``[0, n - 1]``. So ``-1 -> n-1``, ``n+2 -> n-1`` and ``-(n+2) -> 0``.
"""
from __future__ import annotations

import torch


def wrap_clamp(indices: torch.Tensor, n: int) -> torch.Tensor:
    """The row each index selects from ``n`` rows, as int64."""
    idx = indices.long()
    return torch.where(idx < 0, idx + n, idx).clamp_(0, n - 1)


def take_ref(values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """out[i, ...] = values[indices[i], ...] under the index rule above."""
    return values[wrap_clamp(indices, values.shape[0])]


def bitmap_expand_ref(bitmap: torch.Tensor, num_rows: int) -> torch.Tensor:
    """LSB-packed uint8[ceil(n/8)] -> bool[num_rows] (Arrow validity)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bitmap.device)
    bits = (bitmap[:, None] >> shifts) & 1
    return bits.reshape(-1)[:num_rows].bool()
