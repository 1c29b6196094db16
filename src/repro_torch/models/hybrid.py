"""Zamba2-style hybrid, a Mamba2 backbone with a shared attention block: the
port of :mod:`repro.models.hybrid`.

The backbone is ``L`` mamba2 layers; after every ``shared_every`` of them a
*shared* transformer block runs on ``concat(hidden, original_embedding)``
(width 2·D) and projects back to D. The block's weights are shared across
its calls, each call keeps its own K/V cache. As in the JAX package, the
layers fall into ``G = L // every`` groups of ``every`` mamba layers, each
followed by one shared-block call, and ``L % every`` trailing mamba layers;
the JAX package's ``_mamba_stack`` is :func:`.mamba2.mamba_stack`.

Prefill attention runs the flash kernel where the JAX package runs
``chunked_attention``, through the module attribute
``transformer.flash_gqa`` (so that swapping that one name for
``flash_gqa_ref`` swaps the attention of every family). Decode attention is
the plain :func:`.layers.decode_attention`; decode writes the new token's
k and v, and each mamba layer's state and conv window, into the cache in
place.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from ..configs.base import ArchConfig
from ..device import resolve
from . import transformer
from .layers import apply_rope, decode_attention, gated_mlp, rms_norm
from .mamba2 import (init_mamba_layer_params, mamba_cache_spec, mamba_decode_layer,
                     mamba_stack)

Params = dict[str, Any]


def hybrid_structure(cfg: ArchConfig) -> tuple[int, int, int]:
    """(groups, mamba layers a group, trailing mamba layers)."""
    every = cfg.hybrid.shared_every
    return cfg.num_layers // every, every, cfg.num_layers % every


def init_hybrid_params(cfg: ArchConfig, generator: torch.Generator | None,
                       dtype=torch.float32, device=None) -> Params:
    """The JAX package's tree, shapes and scales, drawn from ``generator``
    (on ``device``; ``None`` on the meta device); zero norm weights."""
    device = resolve(device)
    D, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV, F, V = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, cfg.padded_vocab
    s2d = 1.0 / math.sqrt(2 * D)

    def normal(shape, scale=1.0):
        x = torch.randn(shape, generator=generator, dtype=dtype, device=device)
        return x.mul_(scale) if scale != 1.0 else x

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    shared = {
        "attn": {
            "wq": normal((2 * D, H, hd), s2d),
            "wk": normal((2 * D, KV, hd), s2d),
            "wv": normal((2 * D, KV, hd), s2d),
            "wo": normal((H, hd, 2 * D), 1.0 / math.sqrt(H * hd)),
        },
        "mlp": {
            "wg": normal((2 * D, F), s2d),
            "wu": normal((2 * D, F), s2d),
            "wd": normal((F, 2 * D), 1.0 / math.sqrt(F)),
        },
        "ln1": zeros((2 * D,)),
        "ln2": zeros((2 * D,)),
        "down": normal((2 * D, D), s2d),
    }
    params: Params = {
        "embed": normal((V, D)),
        "mamba_layers": init_mamba_layer_params(cfg, generator, cfg.num_layers, dtype, device),
        "shared": shared,
        "final_norm": zeros((D,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, V), 1.0 / math.sqrt(D))
    return params


def _shared_qkv(cfg: ArchConfig, p: Params, h2: torch.Tensor, positions: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", h2, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", h2, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", h2, p["wv"])
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _shared_tail(cfg: ArchConfig, p: Params, h2: torch.Tensor, attn: torch.Tensor):
    """The block after its attention: ``wo``, the residual, norm, gated MLP,
    the residual and the projection back to D."""
    h2 = h2 + torch.einsum("bshk,hkd->bsd", attn, p["attn"]["wo"])
    h = rms_norm(h2, p["ln2"], cfg.norm_eps)
    h2 = h2 + gated_mlp(h, p["mlp"]["wg"], p["mlp"]["wu"], p["mlp"]["wd"], cfg.activation)
    return torch.einsum("bsd,de->bse", h2, p["down"])


def shared_block(cfg: ArchConfig, p: Params, x: torch.Tensor, x0: torch.Tensor,
                 positions: torch.Tensor, collect_cache: bool = False):
    """x, x0: (B, S, D). Returns delta (B, S, D) (and its ``(k, v)`` when
    ``collect_cache``). Positions are ``arange(S)`` in every row, so the
    kernel's causal mask on indices is the JAX package's mask on positions."""
    h2 = torch.cat([x, x0], dim=-1)                        # (B,S,2D)
    h = rms_norm(h2, p["ln1"], cfg.norm_eps)
    q, k, v = _shared_qkv(cfg, p["attn"], h, positions)
    delta = _shared_tail(cfg, p, h2, transformer.flash_gqa(q, k, v, causal=True))
    return (delta, (k, v)) if collect_cache else delta


def _split_groups(cfg: ArchConfig, layers: list[Params]):
    """Per-layer trees -> (``groups`` lists of ``every`` trees, the trailing
    trees)."""
    groups, every, _ = hybrid_structure(cfg)
    head = [layers[g * every:(g + 1) * every] for g in range(groups)]
    return head, layers[groups * every:]


def hybrid_forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor, *,
                   remat: str = "full", collect_cache: bool = False):
    """Full-sequence forward. Returns logits, and with ``collect_cache``
    (prefill; nothing is recomputed then) the cache ``{"state": (L, B, H,
    P, N) float32, "conv": (L, B, W - 1, conv_ch), "k", "v": (G, B, S, KV,
    hd)}``. ``remat`` applies to the mamba layers, as in the JAX package."""
    x0 = transformer.embed_tokens(cfg, params, tokens)
    B, S, _ = x0.shape
    positions = torch.arange(S, dtype=torch.int32, device=x0.device)[None].expand(B, S)
    head, tail = _split_groups(cfg, transformer.unbind_layers(params["mamba_layers"]))
    caches = {"state": [], "conv": [], "k": [], "v": []} if collect_cache else None
    x = x0
    for group in head:
        x = mamba_stack(cfg, group, x, remat, caches)
        if collect_cache:
            delta, (k, v) = shared_block(cfg, params["shared"], x, x0, positions, True)
            caches["k"].append(k)
            caches["v"].append(v)
        else:
            delta = shared_block(cfg, params["shared"], x, x0, positions)
        x = x + delta
    x = mamba_stack(cfg, tail, x, remat, caches)
    logits = transformer.logits_fn(cfg, params, x)
    if not collect_cache:
        return logits
    return logits, {k: torch.stack(v) for k, v in caches.items()}


def hybrid_cache_spec(cfg: ArchConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16) -> dict:
    """Leaf name -> (shape, dtype)."""
    groups, _, _ = hybrid_structure(cfg)
    kv = ((groups, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim), dtype)
    return {**mamba_cache_spec(cfg, batch, dtype), "k": kv, "v": kv}


def init_hybrid_cache(cfg: ArchConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device=None) -> Params:
    device = resolve(device)
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in hybrid_cache_spec(cfg, batch, max_len, dtype).items()}


def hybrid_decode(cfg: ArchConfig, params: Params, cache: Params, tokens: torch.Tensor,
                  position: int):
    """One decode step. tokens (B, 1); ``position``: index of the new token
    (batch-uniform). Returns (logits (B, 1, V), the same cache, written in
    place)."""
    x0 = transformer.embed_tokens(cfg, params, tokens)
    B = x0.shape[0]
    kc, vc = cache["k"], cache["v"]
    S_max = kc.shape[2]
    position = int(position)
    pos2d = torch.full((B, 1), position, dtype=torch.int32, device=x0.device)
    pos_b = torch.full((B,), position, dtype=torch.int32, device=x0.device)
    k_positions = torch.arange(S_max, dtype=torch.int32, device=x0.device)[None].expand(B, S_max)
    groups, every, tail = hybrid_structure(cfg)
    layers, p = params["mamba_layers"], params["shared"]
    x, li = x0, 0
    for g in range(groups):
        for _ in range(every):
            x = mamba_decode_layer(cfg, transformer.layer_params(layers, li), cache, li, x)
            li += 1
        h2 = torch.cat([x, x0], dim=-1)
        h = rms_norm(h2, p["ln1"], cfg.norm_eps)
        q, k_new, v_new = _shared_qkv(cfg, p["attn"], h, pos2d)
        kc[g, :, position] = k_new[:, 0].to(kc.dtype)
        vc[g, :, position] = v_new[:, 0].to(vc.dtype)
        attn = decode_attention(q, kc[g], vc[g], position=pos_b, k_positions=k_positions)
        x = x + _shared_tail(cfg, p, h2, attn)
    for _ in range(tail):
        x = mamba_decode_layer(cfg, transformer.layer_params(layers, li), cache, li, x)
        li += 1
    return transformer.logits_fn(cfg, params, x), cache
