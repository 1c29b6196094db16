"""Flash attention, forward: the wrapper of the CUDA kernel in
``csrc/attention.cu``, which replaces the Pallas TPU kernel
``flash_attention`` of ``src/repro/kernels/attention/attention.py``.

The wrapper checks its arguments, then takes the plain PyTorch version
(:func:`.ref.attention_ref`) for tensors on the CPU and launches the kernel
for tensors on a CUDA device, on the current stream.
``flash_attention.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from .ref import attention_ref

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
HEAD_DIMS = (16, 32, 64, 128, 256)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd), causal mask) v, in float32.

    q: (BH, Sq, hd); k, v: (BH / G, Sk, hd), where query row ``i`` reads K/V
    row ``i // G`` (G = 1 when the heads are pre-expanded, as the JAX kernel
    takes them). Any Sq, Sk >= 1; hd in :data:`HEAD_DIMS`. The causal mask is
    top-left aligned (``q_pos >= k_pos``, both from 0). -> (BH, Sq, hd).
    """
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"flash_attention: want q (BH, Sq, hd) and k, v of one "
                         f"shape (BH/G, Sk, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, sq, hd = q.shape
    bkv, sk = k.shape[0], k.shape[1]
    if k.shape[2] != hd or bkv == 0 or bh % bkv or sk == 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k, v {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be contiguous float32 "
                             f"on {q.device}, got {t.dtype} on {t.device}")
    if not _build.on_cuda(q):
        return attention_ref(q, k, v, causal=causal)
    out = torch.empty_like(q)
    if out.numel():
        _build.launch("attention", "flash_attention_f32",
                      [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I32, _I32, ctypes.c_float],
                      q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), bh, sq, sk, bh // bkv, hd, int(causal),
                      1.0 / math.sqrt(hd))
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
