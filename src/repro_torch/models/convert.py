"""Parameter trees between the two packages, through numpy.

The JAX package's tree (``repro.models.init_params``), with every leaf made
a numpy array (``jax.tree.map(np.asarray, params)``), becomes the port's
tree by :func:`params_from_numpy`: the same keys and shapes, each leaf a
tensor on ``device``. :func:`params_to_numpy` goes back.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..device import resolve


def params_from_numpy(tree: Any, device=None) -> Any:
    device = resolve(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def params_to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
