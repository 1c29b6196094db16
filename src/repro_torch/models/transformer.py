"""Decoder-only transformer (dense / MoE / VLM families): the port of
:mod:`repro.models.transformer`.

Parameters are the JAX package's tree, as a dict of tensors with the layers
stacked along a leading ``L`` axis; ``lax.scan`` over that axis becomes a
Python loop over per-layer views of the same stacked tensors. Prefill
attention runs the flash kernel (:func:`flash_gqa`) where the JAX package
runs ``chunked_attention``. ``remat`` maps the JAX package's policies to
``torch.utils.checkpoint`` around each decoder layer. The other matrix
products are ``torch.einsum``, as the JAX package leaves them to XLA; the
entry points keep ``torch.backends.cuda.matmul.allow_tf32`` False so that
they run in full float32.

Activations pass through :func:`.sharding.constrain` with the JAX package's
logical names at the JAX package's sites: a no-op on plain tensors, a
redistribution of DTensors under a mesh context (the parameters placed by
:func:`.model.param_specs`), so the same code runs on one card and sharded.
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ArchConfig
from ..device import resolve
from ..kernels.attention import flash_gqa
from ..utils.cost import FUSED_ATTENTION, fused
from .layers import _rounded, apply_rope, decode_attention, gated_mlp, rms_norm
from .moe import init_moe_params, moe_ffn
from .sharding import constrain, local_einsum, replicated, sharded_attention

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_transformer_params(cfg: ArchConfig, generator: torch.Generator | None,
                            dtype=torch.float32, device=None) -> Params:
    """The JAX package's tree, shapes and scales, drawn from ``generator``
    (which must live on ``device``; ``None`` on the meta device): normal
    weights, zero norm weights; ``layers["moe"]`` in place of
    ``layers["mlp"]`` when ``cfg.moe`` is set."""
    device = resolve(device)
    D, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV, L, F, V = (cfg.eff_heads, cfg.eff_kv, cfg.num_layers,
                      cfg.d_ff, cfg.padded_vocab)
    s_d = 1.0 / math.sqrt(D)

    def normal(shape, scale=1.0):
        x = torch.randn(shape, generator=generator, dtype=dtype, device=device)
        return x.mul_(scale) if scale != 1.0 else x

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    attn = {
        "wq": normal((L, D, H, hd), s_d),
        "wk": normal((L, D, KV, hd), s_d),
        "wv": normal((L, D, KV, hd), s_d),
        "wo": normal((L, H, hd, D), 1.0 / math.sqrt(H * hd)),
    }
    if cfg.qk_norm:
        attn["q_norm"] = zeros((L, hd))
        attn["k_norm"] = zeros((L, hd))
    layers: Params = {
        "attn": attn,
        "ln1": zeros((L, D)),
        "ln2": zeros((L, D)),
    }
    if cfg.moe is not None:
        layers["moe"] = init_moe_params(generator, D, cfg.moe, dtype, device, L)
    else:
        layers["mlp"] = {
            "wg": normal((L, D, F), s_d),
            "wu": normal((L, D, F), s_d),
            "wd": normal((L, F, D), 1.0 / math.sqrt(F)),
        }
    params: Params = {
        "embed": normal((V, D)),
        "layers": layers,
        "final_norm": zeros((D,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, V), s_d)
    return params


def layer_params(layers: Params, li: int) -> Params:
    """Layer ``li`` of the stacked layer tree (views, no copy)."""
    return {k: layer_params(v, li) if isinstance(v, dict) else v[li]
            for k, v in layers.items()}


def unbind_layers(layers: Params) -> list[Params]:
    """Every layer's tree, from one ``torch.unbind`` per stacked leaf (views,
    no copy). Under autograd the backward of each leaf's unbind is one
    ``stack``; indexing the leaf once per layer (:func:`layer_params`) would
    instead add a zero-filled leaf-sized gradient into it for every layer."""
    per_key = {k: unbind_layers(v) if isinstance(v, dict) else v.unbind(0)
               for k, v in layers.items()}
    depth = len(next(iter(per_key.values())))
    return [{k: v[li] for k, v in per_key.items()} for li in range(depth)]


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def project_heads(x: torch.Tensor, w: torch.Tensor, heads: str = "heads") -> torch.Tensor:
    """x (B, S, D) by w (D, H, hd) -> (B, S, H, hd); ``heads`` is the
    logical name of w's head axis (``kv`` for K and V). Under a mesh each
    rank projects its batch rows onto its heads (w gathered over its fsdp
    shards), :func:`.sharding.local_einsum`."""
    return local_einsum("bsd,dhk->bshk", x, w, ("batch", None, None),
                        (None, heads, "head_dim"))


def merge_heads(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """out (B, S, H, hd) by wo (H, hd, D) -> (B, S, D); under a mesh,
    partial over ``model`` where the heads or head dims are sharded."""
    return local_einsum("bshk,hkd->bsd", out, wo, ("batch", None, "heads", "head_dim"),
                        ("heads", "head_dim", None))


def _qkv(cfg: ArchConfig, p: Params, x: torch.Tensor, positions: torch.Tensor):
    q = project_heads(x, p["wq"])
    k = project_heads(x, p["wk"], "kv")
    v = project_heads(x, p["wv"], "kv")
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = constrain(q, ("batch", None, "heads", "head_dim"))
    k = constrain(k, ("batch", None, "kv", "head_dim"))
    v = constrain(v, ("batch", None, "kv", "head_dim"))
    return q, k, v


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool) -> torch.Tensor:
    """Prefill attention of every family: this module's ``flash_gqa``, read
    when called (so that swapping that one name for ``flash_gqa_ref`` swaps
    the attention of every family), on each rank's own heads under a mesh
    (:func:`.sharding.sharded_attention`); the cost counter's fused region,
    as JAX's ``chunked_attention`` marks it."""
    return fused(FUSED_ATTENTION, sharded_attention, flash_gqa, q, k, v, causal=causal)


def _attention_block(cfg: ArchConfig, p: Params, x: torch.Tensor,
                     positions: torch.Tensor) -> tuple[torch.Tensor, tuple]:
    """Prefill attention. Positions are ``arange(S)`` in every row (see
    :func:`transformer_forward`), so the kernel's causal mask on indices is
    the JAX package's mask on positions."""
    if cfg.logit_softcap is not None:
        raise NotImplementedError("the flash kernel has no logit soft-cap; "
                                  "no ported config sets one")
    q, k, v = _qkv(cfg, p, x, positions)
    out = constrain(attend(q, k, v, causal=True),
                    ("batch", None, "heads", "head_dim"))
    return merge_heads(out, p["wo"]), (k, v)


def _ffn_block(cfg: ArchConfig, layer_p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.moe is not None:
        return moe_ffn(x, layer_p["moe"], cfg.moe, cfg.activation)
    m = layer_p["mlp"]
    return gated_mlp(x, m["wg"], m["wu"], m["wd"], cfg.activation)


def _decoder_layer(cfg: ArchConfig, layer_p: Params, x: torch.Tensor,
                   positions: torch.Tensor) -> tuple[torch.Tensor, tuple]:
    # Megatron-SP schedule, as in the JAX package: norm on the sharded
    # residual, gather the norm output for the block, and pin the block
    # outputs back to the residual sharding
    h = rms_norm(x, layer_p["ln1"], cfg.norm_eps, cfg.zero_centered_norm)
    h = constrain(h, ("batch", None, None))
    attn_out, kv = _attention_block(cfg, layer_p["attn"], h, positions)
    x = x + constrain(attn_out, ("batch", None, "residual"))
    h = rms_norm(x, layer_p["ln2"], cfg.norm_eps, cfg.zero_centered_norm)
    h = constrain(h, ("batch", None, None))
    ffn = constrain(_ffn_block(cfg, layer_p, h), ("batch", None, "residual"))
    return constrain(x + ffn, ("batch", None, "residual")), kv


def _save_dots(ctx, func, *args, **kwargs) -> CheckpointPolicy:
    """``remat="dots"``: keep the outputs of matrix products without batch
    dimensions (``checkpoint_dots_with_no_batch_dims``); ``torch.einsum``
    runs those as ``bmm`` with a batch of 1."""
    if func is torch.ops.aten.mm.default or (
            func is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


REMAT = ("none", "full", "dots")


def _maybe_remat(fn, remat: str):
    """``fn`` itself (``none``), or ``fn`` recomputed in the backward: all of
    it (``full``), or all but its saved products (``dots``)."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"unknown remat {remat!r}, want one of {REMAT}")


# ---------------------------------------------------------------------------
# embed / logits
# ---------------------------------------------------------------------------


def embed_tokens(cfg: ArchConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    x = torch.nn.functional.embedding(tokens.long(), replicated(params["embed"]))
    if cfg.embed_scale:
        x = x * _rounded(math.sqrt(cfg.d_model), x.dtype)
    return constrain(x, ("batch", None, "residual"))


def mask_padded_vocab(cfg: ArchConfig, logits: torch.Tensor) -> torch.Tensor:
    """The padded rows of the embedding table must never win: -inf them."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    valid = torch.arange(logits.shape[-1], device=logits.device) < cfg.vocab_size
    return torch.where(valid, logits, torch.tensor(-1e30, dtype=logits.dtype,
                                                   device=logits.device))


def logits_fn(cfg: ArchConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.zero_centered_norm)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"])
    else:
        logits = torch.einsum("bsd,dv->bsv", x, params["lm_head"])
    return constrain(mask_padded_vocab(cfg, logits), ("batch", None, "vocab"))


# ---------------------------------------------------------------------------
# forward (train / prefill) and decode
# ---------------------------------------------------------------------------


def transformer_forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor, *,
                        extra_embeds: torch.Tensor | None = None,
                        remat: str = "full", collect_cache: bool = False):
    """Full-sequence forward. Returns logits, and the per-layer (k, v) cache
    stacked (L, B, S, KV, hd) when ``collect_cache`` (prefill).

    ``extra_embeds`` (B, P, D) (the VLM's visual tokens) go in front of the
    scaled token embeddings, so the logits and the cache cover ``P + S``
    positions.

    ``remat`` (``none | full | dots``) decides what the backward recomputes
    of each decoder layer; the values are the same in all three. Every row's
    positions are ``arange(S)``, as in the JAX package: a left-padded row
    attends to its pad tokens, which are not masked."""
    x = embed_tokens(cfg, params, tokens)
    if extra_embeds is not None:       # VLM: prepend visual tokens
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    layer = _maybe_remat(functools.partial(_decoder_layer, cfg), remat)
    cache = None
    if collect_cache:
        shape = (cfg.num_layers, B, S, cfg.eff_kv, cfg.resolved_head_dim)
        cache = {"k": x.new_empty(shape), "v": x.new_empty(shape)}
    for li, layer_p in enumerate(unbind_layers(params["layers"])):
        x, (k, v) = layer(layer_p, x, positions)
        if collect_cache:
            cache["k"][li] = k
            cache["v"][li] = v
    logits = logits_fn(cfg, params, x)
    return (logits, cache) if collect_cache else logits


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Params:
    hd = cfg.resolved_head_dim
    shape = (cfg.num_layers, batch, max_len, cfg.eff_kv, hd)
    device = resolve(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def transformer_decode(cfg: ArchConfig, params: Params, cache: Params,
                       tokens: torch.Tensor, position: int):
    """One decode step. tokens (B, 1); ``position``: index of the new token
    (batch-uniform). Returns (logits (B, 1, V), cache).

    Unlike the JAX package, which returns a new cache, this writes the new
    token's k and v into ``cache`` in place (one slot per layer) and returns
    the same dict: the cache is never copied."""
    x = embed_tokens(cfg, params, tokens)
    B = x.shape[0]
    kc, vc = cache["k"], cache["v"]
    S_max = kc.shape[2]
    position = int(position)
    pos2d = torch.full((B, 1), position, dtype=torch.int32, device=x.device)
    k_positions = torch.arange(S_max, dtype=torch.int32, device=x.device)[None].expand(B, S_max)
    pos_b = torch.full((B,), position, dtype=torch.int32, device=x.device)
    layers = params["layers"]
    for li in range(cfg.num_layers):
        layer_p = layer_params(layers, li)
        h = rms_norm(x, layer_p["ln1"], cfg.norm_eps, cfg.zero_centered_norm)
        q, k_new, v_new = _qkv(cfg, layer_p["attn"], h, pos2d)
        kc[li, :, position] = k_new[:, 0].to(kc.dtype)
        vc[li, :, position] = v_new[:, 0].to(vc.dtype)
        out = decode_attention(q, kc[li], vc[li], position=pos_b,
                               k_positions=k_positions,
                               logit_softcap=cfg.logit_softcap)
        x = x + merge_heads(out, layer_p["attn"]["wo"])
        h = rms_norm(x, layer_p["ln2"], cfg.norm_eps, cfg.zero_centered_norm)
        x = x + _ffn_block(cfg, layer_p, h)
    return logits_fn(cfg, params, x), cache
