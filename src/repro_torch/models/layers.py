"""Shared neural building blocks: the port of :mod:`repro.models.layers`.

Norms (RMSNorm and LayerNorm), rotary embeddings, gated MLPs, attention and the loss, in plain
PyTorch on the tensors' own device. Prefill attention in the model goes
through the flash kernel (:func:`repro_torch.kernels.attention.flash_gqa`)
where the JAX package runs :func:`chunked_attention`; the chunked form is
kept here as that function's plain counterpart. Decode attention is plain
PyTorch, as it is plain jnp in the JAX package.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = False) -> torch.Tensor:
    """RMSNorm in fp32 (gemma-style ``(1+w)`` when zero_centered)."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    x32 = x32 * torch.rsqrt(var + eps)
    w = weight.float()
    out = x32 * (1.0 + w) if zero_centered else x32 * w
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in fp32 with the population variance (``jnp.var``'s, not
    ``torch.var``'s unbiased default), cast back to x's dtype."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device | str | None = None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq).
    The two halves of head_dim rotate together (not interleaved pairs)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)        # (hd/2,)
    angles = positions[..., None].float() * freqs                  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]                          # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# gated MLP
# ---------------------------------------------------------------------------


def _activate(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind in ("geglu", "gelu"):
        return F.gelu(x, approximate="tanh")
    if kind in ("swiglu", "silu"):
        return F.silu(x)
    if kind == "relu":
        return F.relu(x)
    raise ValueError(f"unknown activation {kind!r}")


def gated_mlp(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
              wd: torch.Tensor, activation: str) -> torch.Tensor:
    """(B,S,D) -> (B,S,D) with gate/up (D,F) and down (F,D)."""
    gate = _activate(torch.einsum("bsd,df->bsf", x, wg), activation)
    up = torch.einsum("bsd,df->bsf", x, wu)
    return torch.einsum("bsf,fd->bsd", gate * up, wd)


def plain_mlp(x: torch.Tensor, wi: torch.Tensor, wd: torch.Tensor,
              activation: str = "gelu") -> torch.Tensor:
    h = _activate(torch.einsum("bsd,df->bsf", x, wi), activation)
    return torch.einsum("bsf,fd->bsd", h, wd)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _kv_chunks(seq: int, target: int) -> int:
    """Largest divisor of ``seq`` that is <= target."""
    target = min(seq, target)
    for c in range(target, 0, -1):
        if seq % c == 0:
            return c
    return seq


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool,
                      q_positions: torch.Tensor,
                      k_positions: torch.Tensor,
                      scale: float | None = None,
                      kv_chunk: int = 1024,
                      logit_softcap: float | None = None) -> torch.Tensor:
    """GQA attention with an online softmax over KV chunks.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) with H % KV == 0;
    positions: (B, Sq) / (B, Sk) absolute positions (mask = qpos >= kpos).
    Returns (B, Sq, H, hd).
    """
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, KV, G, hd) * scale

    chunk = _kv_chunks(Sk, kv_chunk)
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32, device=q.device)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)
    for c0 in range(0, Sk, chunk):
        k_blk, v_blk = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        p_blk = k_positions[:, c0:c0 + chunk]
        s = torch.einsum("bqkgh,bckh->bkgqc", qg, k_blk).float()  # (B,KV,G,Sq,c)
        if logit_softcap is not None:
            s = torch.tanh(s / logit_softcap) * logit_softcap
        if causal:
            mask = (q_positions[:, None, None, :, None]
                    >= p_blk[:, None, None, None, :])
        else:
            mask = p_blk[:, None, None, None, :] >= 0
        s = torch.where(mask, s, neg)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqc,bckh->bkgqh", p,
                                                   v_blk.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-37)
    out = out.permute(0, 3, 1, 2, 4)                            # (B,Sq,KV,G,hd)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as jnp rounds a Python scalar to the
    type of the array it multiplies."""
    return float(torch.tensor(value, dtype=dtype))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, position: torch.Tensor,
                     k_positions: torch.Tensor, scale: float | None = None,
                     logit_softcap: float | None = None) -> torch.Tensor:
    """Single-step decode: q (B, 1, H, hd) vs cache (B, S, KV, hd); positions
    beyond ``position`` (per batch, (B,)) are masked out. Both products run
    in float32 whatever the dtypes of q and the cache (bf16 by default), as
    the JAX version's promotion and ``preferred_element_type`` give."""
    B, _, H, hd = q.shape
    _, S, KV, _ = k_cache.shape
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, KV, G, hd) * _rounded(scale, q.dtype)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), k_cache.float())
    if logit_softcap is not None:
        s = torch.tanh(s / logit_softcap) * logit_softcap
    mask = k_positions[:, None, None, :] <= position[:, None, None, None]
    s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=torch.float32,
                                          device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token-mean CE. logits (B,S,V) fp32-reduced; labels (B,S) int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
