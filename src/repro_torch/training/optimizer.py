"""AdamW with a warmup-cosine schedule and a global-norm clip: the port of
:mod:`repro.training.optimizer`.

The state is the JAX package's, ``{"m", "v", "master"}``, with ``master``
a float32 copy of the parameters kept even when they are float32 (the
checkpoint's tree depends on it). Unlike the JAX package, which returns new
trees, :func:`adamw_update` updates ``m``, ``v``, ``master`` and the
parameters in place, and consumes the gradients as scratch: at full width
a leaf is up to 2.7 GB, and each temporary of the JAX expression would be
another. The arithmetic is that expression's, step by step, in float32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from .tree import tree_leaves, tree_map

Pytree = Any


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    master_fp32: bool = True        # keep fp32 master when params are low-prec


def lr_at(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio, as a float32 tensor on
    ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.learning_rate * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.learning_rate * cos)


def global_norm(tree: Pytree) -> torch.Tensor:
    sums = [torch.sum(x.float().square()) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def init_opt_state(cfg: OptimizerConfig, params: Pytree) -> Pytree:
    def zeros32(p):                       # placed like p, for a DTensor
        return torch.zeros_like(p, dtype=torch.float32)

    state = {"m": tree_map(zeros32, params), "v": tree_map(zeros32, params)}
    if cfg.master_fp32:
        state["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, grads: Pytree, opt_state: Pytree,
                 params: Pytree, step) -> tuple[Pytree, Pytree, dict]:
    """One AdamW step at ``step`` (the step count before it). Returns
    (params, opt_state, metrics): the same trees, updated in place; the
    gradients are overwritten. One leaf-sized temporary lives at a time."""
    with torch.profiler.record_function("adamw_update"):  # names its kernels in a trace
        gnorm = global_norm(grads)
        clip = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)
        lr = lr_at(cfg, step)
        t = torch.as_tensor(step).to(torch.float32) + 1.0
        bc1 = 1.0 - cfg.beta1 ** t
        bc2 = 1.0 - cfg.beta2 ** t

        masters = opt_state.get("master", params)
        for g, m, v, master, p in zip(*(tree_leaves(x) for x in (
                grads, opt_state["m"], opt_state["v"], masters, params))):
            g32 = g if g.dtype == torch.float32 else g.float()
            g32.mul_(clip)                                          # g = g * clip
            m.mul_(cfg.beta1).add_(g32, alpha=1 - cfg.beta1)        # b1 m + (1 - b1) g
            v.mul_(cfg.beta2).addcmul_(g32, g32, value=1 - cfg.beta2)  # b2 v + (1 - b2) g g
            w = master if master.dtype == torch.float32 else master.float()
            denom = torch.div(v, bc2).sqrt_().add_(cfg.eps)         # sqrt(vhat) + eps
            torch.div(m, bc1, out=g32).div_(denom)                  # mhat / denom
            del denom
            g32.add_(w, alpha=cfg.weight_decay)                     # + wd master
            w.sub_(g32.mul_(lr))                                    # master - lr delta
            if w is not master:
                master.copy_(w)
            if p is not master:
                p.copy_(w)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
