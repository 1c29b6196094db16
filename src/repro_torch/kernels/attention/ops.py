"""GQA wrapper of the flash kernel: the port of
:func:`repro.kernels.attention.ops.flash_gqa`.

``(B, S, H, hd)`` in and out, ``(B*H, S, hd)`` for the kernel. The JAX
wrapper repeats each K/V head ``G = H // KV`` times before the kernel;
here the kernel reads K/V row ``(b*H + h) // G = b*KV + h // G`` itself, which
is the same function without the repeated copy in device memory.
"""
from __future__ import annotations

import torch

from .attention import flash_attention
from .ref import attention_ref


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    B, S, H, hd = x.shape
    return x.transpose(1, 2).reshape(B * H, S, hd).contiguous()


def _gqa(attend, q, k, v, causal):
    B, Sq, H, hd = q.shape
    if k.shape[0] != B or H % k.shape[2]:
        raise ValueError(f"flash_gqa: q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)}")
    out = attend(_heads_first(q), _heads_first(k), _heads_first(v), causal=causal)
    return out.reshape(B, H, Sq, hd).transpose(1, 2)


def flash_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd) with H % KV == 0.
    Returns (B, Sq, H, hd), through :func:`.attention.flash_attention`."""
    return _gqa(flash_attention, q, k, v, causal)


def flash_gqa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """:func:`flash_gqa` through the plain :func:`.ref.attention_ref` on any
    device: the yardstick a kernel run is held to."""
    return _gqa(attention_ref, q, k, v, causal)
