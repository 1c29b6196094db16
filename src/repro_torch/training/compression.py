"""int8 gradient compression with error feedback: the port of
:mod:`repro.training.compression`.

Per-tensor symmetric int8 quantization of (gradient + error feedback), with
the quantization residual kept for the next step. The float32 operations are
the JAX package's, in its order: target = g + ef; amax = max |target|;
scale = max(amax, 1e-12) / 127; q = clip(round(target / scale), ±127) as
int8; deq = q · scale; new ef = target − deq. ``torch.round`` rounds half
to even, as ``jnp.round`` does, so the results are equal bit for bit.

At full width the train step runs this over leaves of up to 2.7 GB on a card
that already holds the rest of the train state, so
:func:`compress_decompress_` works in place, leaf by leaf, with at most one
leaf-sized float32 temporary beside the int8 ``q``. The cross-pod reduce
(``compressed_psum_pod``) needs a ``pod`` mesh axis, which the port does not
have yet (ROADMAP item 9).
"""
from __future__ import annotations

from typing import Any

import torch

from .tree import tree_leaves, tree_map

Pytree = Any


def _amax(x32: torch.Tensor) -> torch.Tensor:
    """max |x| without a leaf-sized temporary (max is exact in any order)."""
    lo, hi = torch.aminmax(x32)
    return torch.maximum(hi, -lo)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization. Returns (q, scale), ``scale``
    a 0-d float32 tensor on ``x``'s device."""
    x32 = x.to(torch.float32)
    scale = _amax(x32).clamp_min(1e-12) / 127.0
    q = torch.div(x32, scale).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32).mul_(scale)


def compress_decompress(x: torch.Tensor, ef: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize (x + error_feedback); return (dequantized, new_ef)."""
    new_ef = ef.clone()
    return compress_decompress_(x.to(torch.float32, copy=True), new_ef), new_ef


def compress_decompress_(g: torch.Tensor, ef: torch.Tensor) -> torch.Tensor:
    """:func:`compress_decompress` in place: ``ef`` becomes the new error
    feedback and the dequantized gradient is returned, in ``g``'s own
    storage when ``g`` is float32 (a new float32 tensor otherwise)."""
    target = g.add_(ef) if g.dtype == torch.float32 else g.to(torch.float32) + ef
    q, scale = quantize_int8(target)
    deq = dequantize_int8(q, scale)
    del q
    torch.sub(target, deq, out=ef)
    return target.copy_(deq)


def compressed_psum_pod(grads: Pytree, ef: Pytree, axis_name: str = "pod"):
    raise NotImplementedError(
        "compressed_psum_pod: the cross-pod int8 reduce needs a 'pod' mesh axis; "
        "mesh and collectives are not ported yet (ROADMAP item 9)")


def init_error_feedback(params: Pytree) -> Pytree:
    """float32 zeros like each leaf, on the leaf's device."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def compression_wire_bytes(params: Pytree) -> tuple[int, int]:
    """(fp32 bytes, int8 bytes) the cross-pod reduce would move per step."""
    leaves = tree_leaves(params)
    n = sum(int(x.numel()) for x in leaves)
    return 4 * n, n + 4 * len(leaves)
