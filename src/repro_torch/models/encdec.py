"""Whisper-style encoder-decoder (audio family): the port of
:mod:`repro.models.encdec`.

The conv front end is a stub, as in the JAX package: ``frames`` are the
precomputed frame embeddings (B, T_enc, D) that Whisper's two conv1d + GELU
layers would make of the log-mel spectrogram. The encoder is bidirectional,
the decoder causal with cross-attention on the encoder's output; norms are
LayerNorm (:func:`.layers.layer_norm` at its default eps, as the JAX package
calls it), positions are learned tables, the embedding is tied and read
without ``embed_scale``.

Prefill attention runs the flash kernel where the JAX package runs
``chunked_attention``: the encoder's self-attention and the decoder's
cross-attention (``Sq != Sk``) non-causal, the decoder's self-attention
causal, each through the module attribute ``transformer.flash_gqa`` (so that
swapping that one name for ``flash_gqa_ref`` swaps the attention of every
family). Decode attention is the plain :func:`.layers.decode_attention`;
decode writes the new token's self k and v into the cache in place.

Products promote their operands as jnp does: float32 frames under bf16
weights run the encoder, and the cross k and v, in float32.
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch

from ..configs.base import ArchConfig
from ..device import resolve
from . import transformer
from .layers import decode_attention, layer_norm, plain_mlp
from .sharding import constrain, replicated

Params = dict[str, Any]

DEC_POS_MAX = 32768  # covers decode_32k; long_500k skipped (full attention)


def init_encdec_params(cfg: ArchConfig, generator: torch.Generator | None,
                       dtype=torch.float32, device=None) -> Params:
    """The JAX package's tree, shapes and scales, drawn from ``generator``
    (on ``device``; ``None`` on the meta device); layer norms at ``w = 1``,
    ``b = 0``."""
    device = resolve(device)
    D, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV, F = cfg.eff_heads, cfg.eff_kv, cfg.d_ff
    Le, Ld = cfg.encdec.num_encoder_layers, cfg.num_layers
    s_d = 1.0 / math.sqrt(D)

    def normal(shape, scale=1.0):
        x = torch.randn(shape, generator=generator, dtype=dtype, device=device)
        return x.mul_(scale) if scale != 1.0 else x

    def attn(L):
        return {
            "wq": normal((L, D, H, hd), s_d),
            "wk": normal((L, D, KV, hd), s_d),
            "wv": normal((L, D, KV, hd), s_d),
            "wo": normal((L, H, hd, D), 1.0 / math.sqrt(H * hd)),
        }

    def lnp(*shape):
        return {"w": torch.ones(shape, dtype=dtype, device=device),
                "b": torch.zeros(shape, dtype=dtype, device=device)}

    def mlp(L):
        return {"wi": normal((L, D, F), s_d), "wd": normal((L, F, D), 1.0 / math.sqrt(F))}

    return {
        "embed": normal((cfg.padded_vocab, D)),
        "enc_pos": normal((cfg.encdec.encoder_seq, D), 0.01),
        "dec_pos": normal((DEC_POS_MAX, D), 0.01),
        "encoder": {"attn": attn(Le), "mlp": mlp(Le), "ln1": lnp(Le, D), "ln2": lnp(Le, D)},
        "enc_final_ln": lnp(D),
        "decoder": {"self_attn": attn(Ld), "cross_attn": attn(Ld), "mlp": mlp(Ld),
                    "ln1": lnp(Ld, D), "ln2": lnp(Ld, D), "ln3": lnp(Ld, D)},
        "dec_final_ln": lnp(D),
    }


def layer_norm_nodes(params: Params) -> list[Params]:
    """The tree's layer norms, each a ``{"w", "b"}`` node: the encoder's
    ``ln1``, ``ln2``, the decoder's ``ln1``-``ln3``, both final norms."""
    enc, dec = params["encoder"], params["decoder"]
    return ([enc["ln1"], enc["ln2"], dec["ln1"], dec["ln2"], dec["ln3"]]
            + [params["enc_final_ln"], params["dec_final_ln"]])


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _promoted(*ts: torch.Tensor) -> list[torch.Tensor]:
    """``ts`` in their common dtype, as jnp promotes the operands of a
    product (a tensor already in it is not copied)."""
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in ts))
    return [t.to(dtype) for t in ts]


def _proj(x: torch.Tensor, w: torch.Tensor, heads: str = "heads") -> torch.Tensor:
    return transformer.project_heads(*_promoted(x, w), heads)


def _norm(x: torch.Tensor, p: Params) -> torch.Tensor:
    return layer_norm(x, p["w"], p["b"])


def _mlp(x: torch.Tensor, p: Params) -> torch.Tensor:
    return plain_mlp(*_promoted(x, p["wi"], p["wd"]), "gelu")


def _mha(cfg: ArchConfig, p: Params, xq: torch.Tensor, xkv: torch.Tensor,
         causal: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention of ``xq`` (B, Sq, D) over ``xkv`` (B, Sk, D) through the
    flash kernel, top-left causal or not. Returns the projected output
    (B, Sq, D) and the block's k and v (B, Sk, KV, hd)."""
    q, k, v = _proj(xq, p["wq"]), _proj(xkv, p["wk"], "kv"), _proj(xkv, p["wv"], "kv")
    q = constrain(q, ("batch", None, "heads", "head_dim"))
    out = transformer.attend(*_promoted(q, k, v), causal=causal).to(q.dtype)
    return transformer.merge_heads(*_promoted(out, p["wo"])), k, v


def _encoder_layer(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    h = _norm(x, p["ln1"])
    x = x + _mha(cfg, p["attn"], h, h, causal=False)[0]
    return constrain(x + _mlp(_norm(x, p["ln2"]), p["mlp"]), ("batch", None, "residual"))


def _decoder_layer(cfg: ArchConfig, p: Params, x: torch.Tensor,
                   enc_out: torch.Tensor) -> tuple[torch.Tensor, tuple]:
    """Causal self-attention, cross-attention on ``enc_out``, MLP. Returns
    x and the layer's (self k, self v, cross k, cross v)."""
    h = _norm(x, p["ln1"])
    attn, k, v = _mha(cfg, p["self_attn"], h, h, causal=True)
    x = x + attn
    attn, ck, cv = _mha(cfg, p["cross_attn"], _norm(x, p["ln2"]), enc_out, causal=False)
    x = x + attn
    x = constrain(x + _mlp(_norm(x, p["ln3"]), p["mlp"]), ("batch", None, "residual"))
    return x, (k, v, ck, cv)


def _embed(params: Params, tokens: torch.Tensor, start: int) -> torch.Tensor:
    """``embed[tokens]`` (no ``embed_scale``, as the JAX package reads it
    here) plus the learned positions ``start .. start + S``."""
    x = torch.nn.functional.embedding(tokens.long(), replicated(params["embed"]))
    return x + params["dec_pos"][None, start:start + tokens.shape[1]].to(x.dtype)


def _logits(cfg: ArchConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = _norm(x, params["dec_final_ln"])
    logits = transformer.mask_padded_vocab(
        cfg, torch.einsum("bsd,vd->bsv", *_promoted(x, params["embed"])))
    return constrain(logits, ("batch", None, "vocab"))


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------


def encode(cfg: ArchConfig, params: Params, frames: torch.Tensor, *,
           remat: str = "full") -> torch.Tensor:
    """frames: (B, T_enc, D) precomputed (the conv stub's output), plus
    ``enc_pos[:T]`` in the frames' dtype; the encoder layers run
    non-causal. -> (B, T_enc, D)."""
    x = frames + params["enc_pos"][None, :frames.shape[1]].to(frames.dtype)
    x = constrain(x, ("batch", None, "residual"))
    layer = transformer._maybe_remat(functools.partial(_encoder_layer, cfg), remat)
    for layer_p in transformer.unbind_layers(params["encoder"]):
        x = layer(layer_p, x)
    return _norm(x, params["enc_final_ln"])


def _decode_all(cfg: ArchConfig, params: Params, enc_out: torch.Tensor,
                tokens: torch.Tensor, remat: str, collect_cache: bool):
    x = constrain(_embed(params, tokens, 0), ("batch", None, "residual"))
    layer = transformer._maybe_remat(functools.partial(_decoder_layer, cfg), remat)
    kvs = []
    for layer_p in transformer.unbind_layers(params["decoder"]):
        x, kv = layer(layer_p, x, enc_out)
        if collect_cache:
            kvs.append(kv)
    logits = _logits(cfg, params, x)
    if not collect_cache:
        return logits
    names = ("self_k", "self_v", "cross_k", "cross_v")
    return logits, {name: torch.stack(leaf) for name, leaf in zip(names, zip(*kvs))}


def decode_train(cfg: ArchConfig, params: Params, enc_out: torch.Tensor,
                 tokens: torch.Tensor, *, remat: str = "full") -> torch.Tensor:
    """Teacher-forced decoder forward -> logits (B, S, V)."""
    return _decode_all(cfg, params, enc_out, tokens, remat, collect_cache=False)


def encdec_forward(cfg: ArchConfig, params: Params, frames: torch.Tensor,
                   tokens: torch.Tensor, *, remat: str = "full") -> torch.Tensor:
    enc_out = encode(cfg, params, frames, remat=remat)
    return decode_train(cfg, params, enc_out, tokens, remat=remat)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def encdec_cache_spec(cfg: ArchConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16) -> dict:
    """Leaf name -> (shape, dtype)."""
    hd, KV, Ld = cfg.resolved_head_dim, cfg.eff_kv, cfg.num_layers
    self_kv = ((Ld, batch, max_len, KV, hd), dtype)
    cross_kv = ((Ld, batch, cfg.encdec.encoder_seq, KV, hd), dtype)
    return {"self_k": self_kv, "self_v": self_kv, "cross_k": cross_kv, "cross_v": cross_kv}


def init_encdec_cache(cfg: ArchConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device=None) -> Params:
    device = resolve(device)
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in encdec_cache_spec(cfg, batch, max_len, dtype).items()}


def encdec_prefill(cfg: ArchConfig, params: Params, frames: torch.Tensor,
                   tokens: torch.Tensor):
    """Encode the audio, then a teacher-forced pass over the prompt. Returns
    (logits (B, S, V), {"self_k", "self_v": (L, B, S, KV, hd), "cross_k",
    "cross_v": (L, B, T_enc, KV, hd)}), each leaf in its product's dtype
    (the parameters', or the frames' for the cross leaves when wider).
    Nothing is recomputed: serving takes no gradient."""
    enc_out = encode(cfg, params, frames, remat="none")
    return _decode_all(cfg, params, enc_out, tokens, "none", collect_cache=True)


def encdec_decode(cfg: ArchConfig, params: Params, cache: Params,
                  tokens: torch.Tensor, position: int):
    """One decoder step against the self and cross caches. tokens (B, 1);
    ``position``: index of the new token (batch-uniform). Returns (logits
    (B, 1, V), the same cache, its self k and v written in place at
    ``position``). Cross-attention reads every encoder position: its query
    position is ``T + 1``, past every key, as in the JAX package."""
    position = int(position)
    x = _embed(params, tokens, position)
    B, dev = x.shape[0], x.device
    sk, sv, ck, cv = (cache[k] for k in ("self_k", "self_v", "cross_k", "cross_v"))
    S_max, T = sk.shape[2], ck.shape[2]
    pos_b = torch.full((B,), position, dtype=torch.int32, device=dev)
    far = torch.full((B,), T + 1, dtype=torch.int32, device=dev)
    k_positions = torch.arange(S_max, dtype=torch.int32, device=dev)[None].expand(B, S_max)
    c_positions = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T)
    for li in range(cfg.num_layers):
        p = transformer.layer_params(params["decoder"], li)
        sp, cp = p["self_attn"], p["cross_attn"]
        h = _norm(x, p["ln1"])
        q = _proj(h, sp["wq"])
        sk[li, :, position] = _proj(h, sp["wk"], "kv")[:, 0].to(sk.dtype)
        sv[li, :, position] = _proj(h, sp["wv"], "kv")[:, 0].to(sv.dtype)
        attn = decode_attention(q, sk[li], sv[li], position=pos_b, k_positions=k_positions)
        x = x + transformer.merge_heads(*_promoted(attn, sp["wo"]))
        cq = _proj(_norm(x, p["ln2"]), cp["wq"])
        attn = decode_attention(cq, ck[li], cv[li], position=far, k_positions=c_positions)
        x = x + transformer.merge_heads(*_promoted(attn, cp["wo"]))
        x = x + _mlp(_norm(x, p["ln3"]), p["mlp"])
    return _logits(cfg, params, x), cache
