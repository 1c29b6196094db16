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

:func:`param_specs`, :func:`cache_pspecs` and :func:`batch_pspecs` give
each leaf's spec (one mesh axis, tuple of axes or ``None`` per dim, see
:mod:`.sharding`), as the JAX package's give a ``PartitionSpec``;
:func:`shard_params` places a tree by them as DTensors.
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ArchConfig
from . import encdec, hybrid, mamba2, transformer
from .layers import softmax_cross_entropy
from .sharding import make_rules, mesh_shape, placements, spec_of

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


def cache_spec(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16) -> dict:
    """Leaf name -> (shape, dtype) of the decode cache, nothing allocated."""
    _known(cfg)
    if cfg.family == "ssm":
        return mamba2.mamba_cache_spec(cfg, batch, dtype)
    if cfg.family == "hybrid":
        return hybrid.hybrid_cache_spec(cfg, batch, max_len, dtype)
    if cfg.family == "audio":
        return encdec.encdec_cache_spec(cfg, batch, max_len, dtype)
    kv = ((cfg.num_layers, batch, max_len, cfg.eff_kv, cfg.resolved_head_dim), dtype)
    return {"k": kv, "v": kv}


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


# ---------------------------------------------------------------------------
# sharding specs
# ---------------------------------------------------------------------------

# trailing-dims logical axes by leaf name (left-padded with None for layer /
# group stacking); MoE experts override below.
_LEAF_RULES: dict[str, tuple] = {
    "embed": ("vocab", "fsdp"),
    "lm_head": ("fsdp", "vocab"),
    "enc_pos": (None, "fsdp"),
    "dec_pos": (None, "fsdp"),
    "wq": ("fsdp", "heads", "head_dim"),
    "wk": ("fsdp", "kv", "head_dim"),
    "wv": ("fsdp", "kv", "head_dim"),
    "wo": ("heads", "head_dim", "fsdp"),
    "wi": ("fsdp", "model_ffn"),
    "wg": ("fsdp", "model_ffn"),
    "wu": ("fsdp", "model_ffn"),
    "wd": ("model_ffn", "fsdp"),
    "router": ("fsdp", None),
    "in_proj": ("fsdp", "d_inner"),
    "out_proj": ("d_inner", "fsdp"),
    "conv_w": (None, None),
    "conv_b": (None,),
    "A_log": ("ssm_heads",),
    "D": ("ssm_heads",),
    "dt_bias": ("ssm_heads",),
    "down": ("fsdp", None),
}
_MOE_OVERRIDES: dict[str, tuple] = {
    "wg": ("experts", "fsdp", "model_ffe"),
    "wu": ("experts", "fsdp", "model_ffe"),
    "wd": ("experts", "model_ffe", "fsdp"),
}


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _shape(leaf) -> tuple:
    """A tensor's shape, or the shape of a ``(shape, dtype)`` pair."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf[0])


def param_specs(cfg: ArchConfig, shapes: Params, mesh, options: dict | None = None) -> Params:
    """The spec tree matching the parameter tree ``shapes`` (tensors, meta
    tensors from :func:`param_shapes`, or anything with ``.shape``)."""
    rules = make_rules(cfg, mesh, options)

    def leaf_spec(names, leaf):
        name = names[-1]
        table = _LEAF_RULES
        if "moe" in names and "shared" not in names and name in _MOE_OVERRIDES:
            table = _MOE_OVERRIDES
        logical = table.get(name)
        shape = _shape(leaf)
        if logical is None:
            return ()                                 # norms, scalars: replicate
        pad = len(shape) - len(logical)
        if pad < 0:
            logical = logical[-len(shape):]
            pad = 0
        logical = (None,) * pad + tuple(logical)
        return spec_of(logical, rules, shape=shape, mesh=mesh)

    return _map_with_path(leaf_spec, shapes)


def cache_pspecs(cfg: ArchConfig, shapes: Params, mesh, options: dict | None = None) -> Params:
    """KV/state cache sharding cascade: kv heads when divisible; else
    head_dim; else the sequence dim rides the model axis. ``shapes`` is a
    cache tree or :func:`cache_spec`'s."""
    rules = make_rules(cfg, mesh, options)
    model = rules.get("model")
    msize = mesh_shape(mesh)["model"] if model is not None else 1

    def leaf_spec(names, leaf):
        name = names[-1]
        shape = _shape(leaf)
        if name in ("k", "v", "self_k", "self_v", "cross_k", "cross_v"):
            # (L_or_G, B, S, KV, hd)
            spec = list(spec_of((None, "batch", None, "kv", None), rules,
                                shape=shape, mesh=mesh))
            if model is not None and spec[3] is None:
                if shape[4] % msize == 0:
                    spec[4] = model                      # head_dim shards
                elif shape[2] % msize == 0:
                    spec[2] = model                      # seq shards
            return tuple(spec)
        if name == "state":               # (L, B, H, P, N)
            return spec_of((None, "batch", "ssm_heads", None, None), rules,
                           shape=shape, mesh=mesh)
        if name == "conv":                # (L, B, W-1, conv_ch)
            return spec_of((None, "batch", None, None), rules, shape=shape, mesh=mesh)
        return (None,) * len(shape)

    return _map_with_path(leaf_spec, shapes)


def batch_pspecs(cfg: ArchConfig, batch_shapes: dict, mesh, options: dict | None = None) -> dict:
    """Batch-leading specs for a batch dict (tensors or ``(shape, dtype)``
    pairs); ``position`` and 0-d leaves replicate."""
    rules = make_rules(cfg, mesh, options)
    out = {}
    for k, v in batch_shapes.items():
        shape = _shape(v)
        if k == "position" or not shape:
            out[k] = ()
        else:
            out[k] = spec_of(("batch",) + (None,) * (len(shape) - 1), rules,
                             shape=shape, mesh=mesh)
    return out


def shard_params(params: Params, specs: Params, mesh) -> Params:
    """Each leaf of ``params`` as a DTensor on ``mesh`` placed by its spec
    (``distribute_tensor``: every rank passes the whole tensor and keeps its
    own shard). The port's ``jax.device_put(NamedSharding)``."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(params, dict):
        return {k: shard_params(v, specs[k], mesh) for k, v in params.items()}
    return distribute_tensor(params, mesh, placements(specs, mesh))
