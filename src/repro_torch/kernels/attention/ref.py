"""Plain PyTorch version of the flash-attention kernel: materialized
attention, the port of :func:`repro.kernels.attention.ref.attention_ref`.

The causal mask is top-left aligned, ``q_pos >= k_pos`` with both counted
from 0, also when ``Sq != Sk``; masked scores are ``NEG_INF`` and the
softmax is taken in float32.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def expand_kv(k: torch.Tensor, bh: int) -> torch.Tensor:
    """(B*KV, S, hd) -> (B*H, S, hd): query row ``i`` reads KV row
    ``i // (H // KV)``, as ``jnp.repeat`` over the head axis gives."""
    if k.shape[0] == bh:
        return k
    return k.repeat_interleave(bh // k.shape[0], dim=0)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q: (BH, Sq, hd); k/v: (BH, Sk, hd), or (BH / G, Sk, hd) for G query
    heads per KV head (see :func:`expand_kv`) -> (BH, Sq, hd)."""
    p = attention_probs(q, k, causal=causal)
    return torch.bmm(p, expand_kv(v, q.shape[0]).float()).to(q.dtype)


def attention_probs(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True) -> torch.Tensor:
    """The (BH, Sq, Sk) float32 softmax probabilities of :func:`attention_ref`."""
    k = expand_kv(k, q.shape[0])
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqh,bkh->bqk", q.float(), k.float()) * scale
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask[None], s, torch.tensor(NEG_INF, device=q.device))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return p / p.sum(-1, keepdim=True)
