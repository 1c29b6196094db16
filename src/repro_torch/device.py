"""Where the port puts its data.

Entry points take ``device=None`` and then use :func:`default_device`, the
CUDA card. There is no check that drops to the CPU: without a card torch
raises at the first allocation. Tests pass ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch


def default_device() -> torch.device:
    return torch.device("cuda")


def resolve(device: torch.device | str | None) -> torch.device:
    return default_device() if device is None else torch.device(device)


def as_tensor(x: torch.Tensor | np.ndarray,
              device: torch.device | str | None = None) -> torch.Tensor:
    """A tensor stays where it lies unless ``device`` is given; a numpy array
    goes to ``device``, else to the card."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(resolve(device))
