"""Unified model API for the dense, MoE, VLM, SSM, hybrid and audio
families: the port of :mod:`repro.models.model`'s ``init_params``,
``param_shapes``, ``forward``, ``loss_fn``, ``prefill``, ``decode`` and
``init_cache``.

Batch dicts are the JAX package's:
  dense/moe/ssm/hybrid train: {"tokens": (B,S) i32, "labels": (B,S) i32}
  vlm train:  + {"patch_embeds": (B, P, D)}, in front of the text, so that
              its logits cover P + S positions and its loss the text only
  audio train: {"frames": (B,T,D), "tokens": (B,S), "labels": (B,S)}
  decode: tokens (B,1) + scalar position against a cache
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ArchConfig
from . import encdec, hybrid, mamba2, transformer
from .layers import softmax_cross_entropy

Params = dict[str, Any]

FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")


def _known(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)


def _extra_embeds(cfg: ArchConfig, batch: dict):
    return batch["patch_embeds"] if cfg.family == "vlm" else None


def init_params(cfg: ArchConfig, generator: torch.Generator | None,
                dtype=torch.float32, device=None) -> Params:
    _known(cfg)
    if cfg.family == "ssm":
        return mamba2.init_mamba_params(cfg, generator, dtype, device)
    if cfg.family == "hybrid":
        return hybrid.init_hybrid_params(cfg, generator, dtype, device)
    if cfg.family == "audio":
        return encdec.init_encdec_params(cfg, generator, dtype, device)
    return transformer.init_transformer_params(cfg, generator, dtype, device)


def param_shapes(cfg: ArchConfig, dtype=torch.bfloat16) -> Params:
    """The parameter tree on the meta device: names, shapes and dtypes,
    nothing allocated."""
    return init_params(cfg, None, dtype, device="meta")


def forward(cfg: ArchConfig, params: Params, batch: dict, *,
            remat: str = "full") -> torch.Tensor:
    """``batch["tokens"]`` (B, S) -> logits (B, S, V); (B, P + S, V) for
    ``vlm``; ``audio`` also reads ``batch["frames"]`` (B, T, D)."""
    _known(cfg)
    if cfg.family == "ssm":
        return mamba2.mamba_forward(cfg, params, batch["tokens"], remat=remat)
    if cfg.family == "hybrid":
        return hybrid.hybrid_forward(cfg, params, batch["tokens"], remat=remat)
    if cfg.family == "audio":
        return encdec.encdec_forward(cfg, params, batch["frames"], batch["tokens"],
                                     remat=remat)
    return transformer.transformer_forward(cfg, params, batch["tokens"],
                                           extra_embeds=_extra_embeds(cfg, batch),
                                           remat=remat)


def loss_fn(cfg: ArchConfig, params: Params, batch: dict, *,
            remat: str = "full") -> torch.Tensor:
    """Token-mean cross-entropy over the positions whose ``labels`` are
    >= 0 (``shift_labels`` marks the last position -1); for ``vlm``, over
    the text positions only."""
    logits = forward(cfg, params, batch, remat=remat)
    labels = batch["labels"]
    if cfg.family == "vlm":                      # text positions only
        logits = logits[:, cfg.vlm.num_patches:, :]
    mask = (labels >= 0).float()
    return softmax_cross_entropy(logits, torch.clamp(labels, min=0), mask)


def prefill(cfg: ArchConfig, params: Params, batch: dict):
    """``batch["tokens"]`` (B, S) -> (logits, cache). The cache holds (L, B,
    S, KV, hd) ``k`` and ``v`` for the attention families (``P + S``
    positions for ``vlm``), the (L, B, H, P, N) ``state`` and (L, B, W - 1,
    C) ``conv`` for ``ssm``, and both for ``hybrid``, whose ``k`` and ``v``
    have one row per shared-block call; for ``audio`` (which also reads
    ``batch["frames"]``) ``self_k``, ``self_v`` (L, B, S, KV, hd) and
    ``cross_k``, ``cross_v`` (L, B, T, KV, hd). Nothing is recomputed:
    serving takes no gradient."""
    _known(cfg)
    if cfg.family == "ssm":
        return mamba2.mamba_prefill(cfg, params, batch["tokens"])
    if cfg.family == "hybrid":
        return hybrid.hybrid_forward(cfg, params, batch["tokens"], remat="none",
                                     collect_cache=True)
    if cfg.family == "audio":
        return encdec.encdec_prefill(cfg, params, batch["frames"], batch["tokens"])
    return transformer.transformer_forward(cfg, params, batch["tokens"],
                                           extra_embeds=_extra_embeds(cfg, batch),
                                           remat="none", collect_cache=True)


def decode(cfg: ArchConfig, params: Params, cache: Params, tokens: torch.Tensor,
           position: int):
    _known(cfg)
    if cfg.family == "ssm":
        return mamba2.mamba_decode(cfg, params, cache, tokens, position)
    if cfg.family == "hybrid":
        return hybrid.hybrid_decode(cfg, params, cache, tokens, position)
    if cfg.family == "audio":
        return encdec.encdec_decode(cfg, params, cache, tokens, position)
    return transformer.transformer_decode(cfg, params, cache, tokens, position)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> Params:
    """Zeros of the decode cache; an SSM state is float32 whatever
    ``dtype``."""
    _known(cfg)
    if cfg.family == "ssm":
        return mamba2.init_mamba_cache(cfg, batch, dtype, device)
    if cfg.family == "hybrid":
        return hybrid.init_hybrid_cache(cfg, batch, max_len, dtype, device)
    if cfg.family == "audio":
        return encdec.init_encdec_cache(cfg, batch, max_len, dtype, device)
    return transformer.init_cache(cfg, batch, max_len, dtype, device)
