"""Unified model API, the serving half, for the dense family: the port of
:mod:`repro.models.model`'s ``init_params``, ``prefill``, ``decode`` and
``init_cache``.

Other families raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ArchConfig
from . import transformer

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


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.float32, device=None) -> Params:
    _dense(cfg)
    return transformer.init_transformer_params(cfg, generator, dtype, device)


def prefill(cfg: ArchConfig, params: Params, batch: dict):
    """``batch["tokens"]`` (B, S) -> (logits (B, S, V), cache of (L, B, S,
    KV, hd) ``k`` and ``v``)."""
    _dense(cfg)
    return transformer.transformer_forward(cfg, params, batch["tokens"],
                                           collect_cache=True)


def decode(cfg: ArchConfig, params: Params, cache: Params, tokens: torch.Tensor,
           position: int):
    _dense(cfg)
    return transformer.transformer_decode(cfg, params, cache, tokens, position)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> Params:
    _dense(cfg)
    return transformer.init_cache(cfg, batch, max_len, dtype, device)
