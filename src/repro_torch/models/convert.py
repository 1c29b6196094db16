"""Parameter trees and train states between the two packages, through
numpy.

The JAX package's tree (``repro.models.init_params``, or a whole train
state from ``repro.training.init_train_state``: ``params``, ``opt.m``,
``opt.v``, ``opt.master`` and the 0-d int32 ``step``), with every leaf made
a numpy array (``jax.tree.map(np.asarray, tree)``), becomes the port's
tree by :func:`params_from_numpy`: the same keys, shapes and dtypes, each
leaf a tensor on ``device``. :func:`params_to_numpy` goes back.
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
