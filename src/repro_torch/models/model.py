"""Unified model API for the dense family: the port of
:mod:`repro.models.model`'s ``init_params``, ``param_shapes``, ``forward``,
``loss_fn``, ``prefill``, ``decode`` and ``init_cache``.

Other families raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ArchConfig
from . import transformer
from .layers import softmax_cross_entropy

Params = dict[str, Any]

_TODO = {
    "moe": "the moe family is not ported yet (ROADMAP item 8, models/moe.py)",
    "vlm": "the vlm family is not ported yet (ROADMAP item 8, extra_embeds)",
    "ssm": "the ssm family is not ported yet (ROADMAP item 8, models/mamba2.py)",
    "hybrid": "the hybrid family is not ported yet (ROADMAP item 8, models/hybrid.py)",
    "audio": "the audio family is not ported yet (ROADMAP item 8, models/encdec.py)",
}


def _dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(_TODO.get(cfg.family, cfg.family))


def init_params(cfg: ArchConfig, generator: torch.Generator | None,
                dtype=torch.float32, device=None) -> Params:
    _dense(cfg)
    return transformer.init_transformer_params(cfg, generator, dtype, device)


def param_shapes(cfg: ArchConfig, dtype=torch.bfloat16) -> Params:
    """The parameter tree on the meta device: names, shapes and dtypes,
    nothing allocated."""
    return init_params(cfg, None, dtype, device="meta")


def forward(cfg: ArchConfig, params: Params, batch: dict, *,
            remat: str = "full") -> torch.Tensor:
    """``batch["tokens"]`` (B, S) -> logits (B, S, V)."""
    _dense(cfg)
    return transformer.transformer_forward(cfg, params, batch["tokens"], remat=remat)


def loss_fn(cfg: ArchConfig, params: Params, batch: dict, *,
            remat: str = "full") -> torch.Tensor:
    """Token-mean cross-entropy over the positions whose ``labels`` are
    >= 0 (``shift_labels`` marks the last position -1)."""
    logits = forward(cfg, params, batch, remat=remat)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    return softmax_cross_entropy(logits, torch.clamp(labels, min=0), mask)


def prefill(cfg: ArchConfig, params: Params, batch: dict):
    """``batch["tokens"]`` (B, S) -> (logits (B, S, V), cache of (L, B, S,
    KV, hd) ``k`` and ``v``). Nothing is recomputed: serving takes no
    gradient."""
    _dense(cfg)
    return transformer.transformer_forward(cfg, params, batch["tokens"],
                                           remat="none", collect_cache=True)


def decode(cfg: ArchConfig, params: Params, cache: Params, tokens: torch.Tensor,
           position: int):
    _dense(cfg)
    return transformer.transformer_decode(cfg, params, cache, tokens, position)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> Params:
    _dense(cfg)
    return transformer.init_cache(cfg, batch, max_len, dtype, device)
