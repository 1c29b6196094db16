"""Flash attention, forward: the wrapper of the CUDA kernel in
``csrc/attention.cu``, which replaces the Pallas TPU kernel
``flash_attention`` of ``src/repro/kernels/attention/attention.py``.

The wrapper checks its arguments, then takes the plain PyTorch version
(:func:`.ref.attention_ref`) for tensors on the CPU and launches the kernel
for tensors on a CUDA device, on the current stream.
``flash_attention.launches`` counts the launches.

Both devices go through one ``torch.autograd.Function``. Its backward
recomputes the plain version under autograd and returns its gradients: the
TPU kernel has no backward kernel either (the JAX package differentiates
through its checkpointed ``chunked_attention``). The recompute holds the
(BH, Sq, Sk) probabilities for the length of the backward; the forward
saves only q, k and v.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from .ref import attention_ref

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it if its data does not start on 16 bytes (the
    kernel reads rows as float4)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernel_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool) -> torch.Tensor:
    """The kernel on the card. bfloat16 inputs are widened to float32 and
    the output narrowed back, the plain version's function on bf16."""
    dtype = q.dtype
    q, k, v = (_aligned(t.float()) for t in (q, k, v))
    bh, sq, hd = q.shape
    bkv, sk = k.shape[0], k.shape[1]
    out = torch.empty_like(q)
    if out.numel():
        # a profiler range of its own: a launch from ctypes has no op around
        # it, and the profiler would give the kernel to an earlier op
        with torch.profiler.record_function("flash_attention"):
            _build.launch("attention", "flash_attention_f32",
                          [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I32, _I32, ctypes.c_float],
                          q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), bh, sq, sk, bh // bkv, hd, int(causal),
                          1.0 / math.sqrt(hd))
        flash_attention.launches += 1
    return out.to(dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        if _build.on_cuda(q):
            return _kernel_forward(q, k, v, causal)
        return attention_ref(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = attention_ref(*inputs, causal=ctx.causal)
        return (*torch.autograd.grad(out, inputs, grad_out), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd), causal mask) v, computed in float32.

    q: (BH, Sq, hd); k, v: (BH / G, Sk, hd), where query row ``i`` reads K/V
    row ``i // G`` (G = 1 when the heads are pre-expanded, as the JAX kernel
    takes them). Any Sq, Sk >= 1; hd in :data:`HEAD_DIMS`; all three float32
    or all three bfloat16, contiguous, on one device. The causal mask is
    top-left aligned (``q_pos >= k_pos``, both from 0). -> (BH, Sq, hd) in
    the inputs' dtype, differentiable in q, k and v.
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
        if (t.dtype not in DTYPES or t.dtype != q.dtype or not t.is_contiguous()
                or t.device != q.device):
            raise ValueError(f"flash_attention: {name} must be contiguous float32 "
                             f"or bfloat16 like q ({q.dtype}) on {q.device}, got "
                             f"{t.dtype} on {t.device}")
    _build.on_cuda(q)  # raises for a device that has neither path
    return _FlashAttention.apply(q, k, v, causal)


flash_attention.launches = 0
