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
leaf-sized float32 temporary beside the int8 ``q``.

:func:`compressed_psum_pod` is the cross-pod reduce: explicit collectives
over the ``pod`` dim of a ``DeviceMesh``, where the JAX package runs them
inside ``shard_map`` over the ``pod`` axis.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from .tree import tree_leaves, tree_map, tree_unflatten

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


def pod_reduce_leaf(g: torch.Tensor, e: torch.Tensor, group, npods: int):
    """One leaf of :func:`compressed_psum_pod`: ``g`` and ``e`` this rank's
    plain tensors. Returns (pod-mean gradient, new error feedback, the
    all-reduced int32 payload)."""
    target = g.to(torch.float32) + e
    q, scale = quantize_int8(target)
    deq_local = dequantize_int8(q, scale)
    new_e = target - deq_local
    # wire: int8 payload (accumulated in int32) + per-tensor scale
    acc = q.to(torch.int32)
    dist.all_reduce(acc, group=group)
    scales = scale.new_empty((npods,))
    dist.all_gather_into_tensor(scales, scale.reshape(1), group=group)
    # scales differ per pod: the wire carries q_i and the mean scale, and
    # each pod folds its own q_i * (s_i - s_mean) into its error feedback
    s_mean = torch.mean(scales)
    mean_g = acc.to(torch.float32) * s_mean / npods
    return mean_g, new_e + (deq_local - q.to(torch.float32) * s_mean), acc


def compressed_psum_pod(grads: Pytree, ef: Pytree, mesh, axis_name: str = "pod"):
    """int8-compress each rank's contribution (with error feedback),
    all-reduce the int8 payload as int32 over the ``axis_name`` dim of
    ``mesh`` (wire bytes 1/4 of float32), share the scales by an all-gather
    and dequantize with their mean: the JAX package's formula, op for op.

    ``grads`` and ``ef`` are trees of this rank's tensors (a DTensor leaf
    is taken by its local shard and the result placed like it). Returns
    (pod-mean gradients float32, new error-feedback state)."""
    from torch.distributed.tensor import DTensor
    group = mesh.get_group(axis_name)
    npods = dist.get_world_size(group)

    def one(g, e):
        if isinstance(g, DTensor):
            m, ne, _ = pod_reduce_leaf(g.to_local(), e.to_local(), group, npods)
            return (DTensor.from_local(m, g.device_mesh, g.placements),
                    DTensor.from_local(ne, e.device_mesh, e.placements))
        return pod_reduce_leaf(g, e, group, npods)[:2]

    outs = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(ef))]
    return (tree_unflatten(grads, [o[0] for o in outs]),
            tree_unflatten(grads, [o[1] for o in outs]))


def init_error_feedback(params: Pytree) -> Pytree:
    """float32 zeros like each leaf, on the leaf's device (placed like it,
    for a DTensor)."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def compression_wire_bytes(params: Pytree) -> tuple[int, int]:
    """(fp32 bytes, int8 bytes) the cross-pod reduce would move per step."""
    leaves = tree_leaves(params)
    n = sum(int(x.numel()) for x in leaves)
    return 4 * n, n + 4 * len(leaves)
