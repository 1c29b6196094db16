"""Train step factory: loss → gradients (accumulated over microbatches) →
optional int8 error-feedback compression → AdamW. The port of
:mod:`repro.training.train_step`.

The train state is the JAX package's tree, ``{"params", "opt": {"m", "v",
"master"}, "ef"?, "step"}``, with ``step`` a 0-d int32 tensor and ``ef``
(float32, like the params) present when ``compress_dp_grads`` is set. The
step updates the state's tensors in place and returns the same dict (the JAX
step returns a new tree): at full width the state is 5 x 10.1 GB of float32,
6 x with ``ef``. Mesh and sharding are dropped, as everywhere in the port
(ROADMAP item 9).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..configs.base import ArchConfig
from ..device import resolve
from ..models import init_params, loss_fn
from .compression import compress_decompress_, init_error_feedback
from .optimizer import OptimizerConfig, adamw_update, init_opt_state
from .tree import tree_leaves, tree_map, tree_unflatten

Pytree = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = OptimizerConfig()
    remat: str = "full"                 # none | dots | full
    microbatches: int = 1               # gradient accumulation
    compress_dp_grads: bool = False     # int8 EF compression across pods
    param_dtype: str = "float32"        # float32 (smoke) / bfloat16 (scale)


def init_train_state(cfg: ArchConfig, tcfg: TrainConfig,
                     generator: torch.Generator | None, device=None) -> Pytree:
    """Parameters drawn from ``generator`` (on ``device``; ``None`` on the
    meta device), zero moments, a float32 master copy, step 0, and zero
    error feedback when ``compress_dp_grads`` is set."""
    device = resolve(device)
    params = init_params(cfg, generator, getattr(torch, tcfg.param_dtype), device)
    state = {"params": params,
             "opt": init_opt_state(tcfg.optimizer, params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if tcfg.compress_dp_grads:
        state["ef"] = init_error_feedback(params)
    return state


def train_state_shapes(cfg: ArchConfig, tcfg: TrainConfig) -> Pytree:
    """The train state on the meta device: nothing allocated."""
    return init_train_state(cfg, tcfg, None, "meta")


def _split_microbatches(batch: dict, k: int) -> list[dict]:
    for key, v in batch.items():
        if v.shape[0] % k:
            raise ValueError(f"batch {v.shape[0]} not divisible by microbatches {k}")
    parts = {key: v.chunk(k) for key, v in batch.items()}
    return [{key: p[i] for key, p in parts.items()} for i in range(k)]


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig):
    """Returns train_step(state, batch) -> (state, metrics), with metrics
    ``loss``, ``grad_norm``, ``lr`` and ``tokens`` as 0-d float32 tensors on
    the state's device (reading one waits for the step). With
    ``compress_dp_grads`` and an ``ef`` in the state, the gradients pass
    through the local int8 quantize/error-feedback pass, leaf by leaf and in
    place, before AdamW; ``state["ef"]`` is updated in place."""

    def compute_grads(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss = loss_fn(cfg, tree_unflatten(params, leaves), batch, remat=tcfg.remat)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten(params, list(grads))

    def train_step(state: Pytree, batch: dict) -> tuple[Pytree, dict]:
        params = state["params"]
        if tcfg.microbatches > 1:
            loss_sum = 0.0
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            for mb in _split_microbatches(batch, tcfg.microbatches):
                loss, g = compute_grads(params, mb)
                tree_map(lambda a, b: a.add_(b), grads, g)
                loss_sum = loss_sum + loss
                del g
            loss = loss_sum / tcfg.microbatches
            tree_map(lambda a: a.div_(tcfg.microbatches), grads)
        else:
            loss, grads = compute_grads(params, batch)
        if tcfg.compress_dp_grads and "ef" in state:
            with torch.profiler.record_function("compress_decompress"):  # names its kernels
                grads = tree_unflatten(grads, [
                    compress_decompress_(g, e)
                    for g, e in zip(tree_leaves(grads), tree_leaves(state["ef"]))])
        _, _, opt_metrics = adamw_update(tcfg.optimizer, grads, state["opt"],
                                         params, state["step"])
        del grads
        state["step"] = state["step"] + 1
        metrics = {"loss": loss, **opt_metrics,
                   "tokens": torch.tensor(float(batch["tokens"].numel()),
                                          device=loss.device)}
        return state, metrics

    return train_step
