"""Mixture-of-Experts FFN with sort-based, capacity-bounded dispatch: the
port of :mod:`repro.models.moe`.

Tokens are routed top-k on float32 router probabilities, the (token, k)
pairs are sorted by expert id, each expert takes at most ``capacity``
tokens (the overflow is dropped), the expert FFNs run as three grouped
einsums over the experts axis, and the outputs are added back to their
tokens weighted by the renormalised gate weights.

The operations are the JAX package's, in its order. Two of them need a
particular torch call to keep its result:

- ``jax.lax.top_k`` breaks ties toward the lower expert index;
  ``torch.topk`` promises no order among ties, so the top-k is a stable
  descending ``torch.sort`` cut to ``k``;
- ``jnp.argsort`` is stable, so the pairs are sorted with
  ``torch.argsort(stable=True)``: the order inside an expert decides which
  pairs its capacity drops.

The dispatch is plain torch, as it is plain jnp in the JAX package: no
kernel of its own. Its groups, and how they run on a mesh, are
:func:`moe_ffn`'s.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ..configs.base import MoEConfig
from ..device import resolve
from .layers import _activate
from .sharding import (constrain, dispatch_groups, is_dtensor, local_apply,
                       placements_for, replicate_all)


def init_moe_params(generator: torch.Generator | None, d_model: int, m: MoEConfig,
                    dtype, device, layers: int) -> dict:
    """The JAX package's MoE tree, shapes and scales, for ``layers`` layers
    stacked along a leading axis, as ``jax.vmap`` over per-layer keys stacks
    them in the JAX transformer; drawn from ``generator`` (on ``device``;
    ``None`` on the meta device). The router is float32 whatever ``dtype``
    is."""
    device = resolve(device)
    scale = 1.0 / math.sqrt(d_model)

    def normal(shape, scale, dt=dtype):
        x = torch.randn((layers,) + shape, generator=generator, dtype=dt, device=device)
        return x.mul_(scale)

    E, D, F = m.num_experts, d_model, m.d_ff_expert
    p = {
        "router": normal((D, E), scale, torch.float32),
        "wg": normal((E, D, F), scale),
        "wu": normal((E, D, F), scale),
        "wd": normal((E, F, D), 1.0 / math.sqrt(F)),
    }
    if m.shared_expert_ff:
        Fs = m.shared_expert_ff
        p["shared"] = {
            "wg": normal((D, Fs), scale),
            "wu": normal((D, Fs), scale),
            "wd": normal((Fs, D), 1.0 / math.sqrt(Fs)),
        }
    return p


def capacity_for(num_tokens: int, m: MoEConfig) -> int:
    raw = num_tokens * m.top_k / m.num_experts * m.capacity_factor
    return max(1, int(math.ceil(raw / 8.0)) * 8)   # 8-aligned for TPU tiles


@dataclasses.dataclass
class Routing:
    """One token group's routing, pairs in expert order.

    ``gate_w``, ``gate_ids``: (Tg, K) renormalised gate weights and expert
    ids, best first; ``sort_idx``, ``token_of``, ``w_sorted``, ``slot``,
    ``keep``: (Tg*K,) per (token, k) pair sorted by expert, its index in
    ``gate_ids.reshape(-1)``, its token, its gate weight, its row in the
    (E*C + 1, D) dispatch buffer (``E*C``, the sentinel row, when dropped)
    and whether its expert's capacity kept it."""
    gate_w: torch.Tensor
    gate_ids: torch.Tensor
    sort_idx: torch.Tensor
    token_of: torch.Tensor
    w_sorted: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values, best
    first, equal values in the order of their index."""
    values, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], ids[..., :k]


def route(xt: torch.Tensor, router: torch.Tensor, m: MoEConfig, C: int) -> Routing:
    """Route the tokens ``xt`` (Tg, D) over ``m.num_experts`` experts of
    capacity ``C``, as the JAX package's ``_dispatch_one_group`` does."""
    Tg = xt.shape[0]
    E, K = m.num_experts, m.top_k

    # -- routing (fp32 for numerics) --------------------------------------
    logits = torch.einsum("td,de->te", xt.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_ids = top_k(probs, K)                  # (Tg, K)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)

    # -- sort (token, k) pairs by expert ----------------------------------
    flat_ids = gate_ids.reshape(-1)                     # (Tg*K,)
    sort_idx = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[sort_idx]
    token_of = sort_idx // K
    w_sorted = gate_w.reshape(-1)[sort_idx]

    counts = torch.bincount(flat_ids, minlength=E)      # (E,)
    group_start = torch.cumsum(counts, 0) - counts
    pos_in_expert = torch.arange(Tg * K, device=xt.device) - group_start[sorted_ids]
    keep = pos_in_expert < C
    slot = sorted_ids * C + pos_in_expert.clamp(0, C - 1)
    slot = torch.where(keep, slot, E * C)               # sentinel row
    return Routing(gate_w, gate_ids, sort_idx, token_of, w_sorted, slot, keep)


def _dispatch_one_group(xt: torch.Tensor, router: torch.Tensor, m: MoEConfig,
                        activation: str, wg, wu, wd, C: int) -> torch.Tensor:
    """Sort-based capacity-bounded dispatch for ONE token group.
    xt: (Tg, D) -> (Tg, D)."""
    Tg, D = xt.shape
    E = m.num_experts
    r = route(xt, router, m, C)

    # -- dispatch: (E, C, D) expert inputs (out of place, so autograd sees
    # it); every pair a capacity drops lands on the sentinel row ----------
    disp = xt.new_zeros((E * C + 1, D)).index_put((r.slot,), xt[r.token_of])
    expert_in = disp[: E * C].reshape(E, C, D)

    # -- grouped FFN -------------------------------------------------------
    h = _activate(torch.einsum("ecd,edf->ecf", expert_in, wg), activation)
    h = h * torch.einsum("ecd,edf->ecf", expert_in, wu)
    out_e = torch.einsum("ecf,efd->ecd", h, wd)

    # -- combine: weighted scatter-add back to token positions -------------
    flat_out = torch.cat([out_e.reshape(E * C, D), out_e.new_zeros((1, D))], 0)
    gathered = flat_out[r.slot] * r.w_sorted[:, None].to(out_e.dtype)
    return out_e.new_zeros((Tg, D)).index_add(0, r.token_of, gathered)


def _dispatch_groups(xg: torch.Tensor, router, wg, wu, wd, *, m: MoEConfig,
                     activation: str, C: int) -> torch.Tensor:
    """:func:`_dispatch_one_group` over each group of ``xg`` (G, Tg, D), as
    ``jax.vmap`` runs it in the JAX package."""
    return torch.stack([_dispatch_one_group(xt, router, m, activation, wg, wu, wd, C)
                        for xt in xg.unbind(0)])


def moe_ffn(x: torch.Tensor, p: dict, m: MoEConfig, activation: str) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).

    Dispatch runs per token group, ``G = gcd(dispatch_groups(), B*S)``
    groups of ``Tg = B*S / G`` consecutive tokens, each of capacity
    ``capacity_for(Tg)``, as in the JAX package: ``dispatch_groups()`` is
    the number of batch shards under a mesh context and 1 without one. Each
    group routes, sorts and drops on its own, so the drop pattern depends on
    G, as JAX's does.

    On DTensors the groups are laid out over the batch shards and the
    dispatch (sort, ``bincount``, ``index_put``, ``index_add``, for which
    DTensor has no sharding rule) runs on each rank's own groups through
    ``local_map``. The router and the expert weights are gathered whole on
    every rank for it (an all-gather of the expert axis, where the JAX
    package lets XLA choose), and their gradients summed over the batch
    shards."""
    B, S, D = x.shape
    T = B * S
    G = math.gcd(dispatch_groups(), T)
    Tg = T // G
    C = capacity_for(Tg, m)
    # one group has nothing to lay out over the batch shards
    glogical = ("batch", None, None) if G > 1 else (None, None, None)
    xg = constrain(x.reshape(G, Tg, D), glogical)
    args = (xg, p["router"], p["wg"], p["wu"], p["wd"])
    fn = functools.partial(_dispatch_groups, m=m, activation=activation, C=C)
    if is_dtensor(xg):
        gp = placements_for(xg, glogical)
        whole = replicate_all(xg.device_mesh)
        out = local_apply(fn, args, (gp,) + (whole,) * 4, gp)
    else:
        out = fn(*args)
    out = constrain(out, glogical).reshape(T, D)
    xt = x.reshape(T, D)
    if m.shared_expert_ff:
        sh = p["shared"]
        g = _activate(torch.einsum("td,df->tf", xt, sh["wg"]), activation)
        out = out + torch.einsum("tf,fd->td", g * torch.einsum(
            "td,df->tf", xt, sh["wu"]), sh["wd"])
    return out.reshape(B, S, D)


def aux_load_balance_loss(x: torch.Tensor, router: torch.Tensor,
                          m: MoEConfig) -> torch.Tensor:
    """Switch-style load-balance auxiliary (mean prob x mean assignment).
    The JAX package defines it and no loss calls it; so here."""
    logits = torch.einsum("bsd,de->bse", x.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    _, ids = top_k(probs, m.top_k)
    assign = torch.nn.functional.one_hot(ids, m.num_experts).float().sum(-2)
    frac_tokens = assign.mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    return m.num_experts * torch.sum(frac_tokens * frac_probs)
