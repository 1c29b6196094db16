"""Training launcher: the port of :mod:`repro.launch.train`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --steps 200 --reduced --batch-seqs 8 --seq-len 128 [--device cpu]

Data flows: columnar token shards (engine) → Thallus zero-copy transport
(protocol) → ``ThallusLoader`` numpy batches → the device → the train step
(prefill attention in the flash kernel) → columnar checkpoints
(``training.checkpoint``). ``--transport rpc`` switches the input pipeline
to the serialize-based baseline. The flags are the JAX launcher's, plus
``--device`` (default ``cuda``). Weights are drawn from seed 0, so the norm
weights are zero, as in the JAX launcher (ROADMAP.md, faults of the
reference).

Sharded, one process per card:

    PYTHONPATH=src torchrun --nproc-per-node N -m repro_torch.launch.train \
        --arch granite-3-2b --reduced --steps 200

With a process group (torchrun's environment, or a caller's
``init_process_group``) the launcher builds ``make_host_mesh()``, enters
``mesh_context(mesh, make_rules(cfg, mesh))``, places the parameters and
the optimizer state as DTensors by ``param_specs``, each batch by
``training_batch_specs`` and a restored checkpoint into the same
placements, as the JAX launcher does. Every rank reads the same batches
and keeps its own rows; rank 0 prints and writes the checkpoints. Without
a group it runs on the one card with plain tensors, as before.

Fault tolerance, as in the JAX launcher: the run resumes from the latest
checkpoint (params, optimizer, step and the loader's cursor); ``--kill-at``
simulates a crash. The cursor counts the record batches the loader has
pulled, so a run killed inside a record batch resumes at the next one.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, get_config
from ..configs.base import ArchConfig
from ..core import Fabric, ThallusServer
from ..core.device_transport import training_batch_specs
from ..data import ThallusLoader, make_token_table
from ..engine import Engine
from ..models import param_specs, shard_params
from ..models.sharding import from_full, make_rules, mesh_context, mesh_device, whole
from ..training import (CheckpointManager, OptimizerConfig, TrainConfig,
                        init_train_state, make_train_step, train_state_shapes)
from .mesh import process_group_mesh


def make_loader(cfg: ArchConfig, *, num_seqs: int, seq_len: int, batch_seqs: int,
                replicas: int, transport: str) -> ThallusLoader:
    """``replicas`` Thallus servers over one seeded token table (straggler
    backups), read by a ``ThallusLoader``."""
    servers = []
    for _ in range(replicas):
        eng = Engine()
        eng.register("/data/tokens", make_token_table(
            "tokens", num_seqs, seq_len, cfg.vocab_size,
            seqs_per_batch=max(batch_seqs * 4, 32)))
        servers.append(ThallusServer(eng, Fabric()))
    return ThallusLoader(servers, "SELECT tokens FROM tokens", "/data/tokens",
                         seq_len=seq_len, batch_seqs=batch_seqs, transport=transport)


def batch_to_device(batch: dict[str, np.ndarray], device, mesh=None) -> dict[str, torch.Tensor]:
    """The loader's numpy batch on ``device``; with a ``mesh``, as DTensors
    placed by ``training_batch_specs`` (each rank copies its own rows)."""
    if mesh is None:
        return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    spec = training_batch_specs(mesh)
    return {k: from_full(torch.from_numpy(v), mesh, spec, mesh_device(mesh))
            for k, v in batch.items()}


def state_specs(cfg: ArchConfig, state, mesh) -> dict:
    """The train state's specs: the parameters', for the parameters and for
    each optimizer tree; ``None`` (a plain tensor) for the step."""
    pspecs = param_specs(cfg, state["params"], mesh)
    out = {"params": pspecs, "opt": {k: pspecs for k in state["opt"]}, "step": None}
    if "ef" in state:
        out["ef"] = pspecs
    return out


def place_state(state, specs, mesh):
    return {k: v if specs[k] is None else shard_params(v, specs[k], mesh)
            for k, v in state.items()}


def main(argv: list[str] | None = None) -> list[dict]:
    """Run the launcher; returns each step's metrics as floats (``step``,
    ``loss``, ``grad_norm``, ``lr``, ``tokens``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch-seqs", type=int, default=8)
    ap.add_argument("--num-seqs", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=("none", "dots", "full"))
    ap.add_argument("--transport", default="thallus", choices=("thallus", "rpc"))
    ap.add_argument("--replicas", type=int, default=2,
                    help="data-server replicas (straggler backup)")
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--kill-at", type=int, default=0,
                    help="simulate a crash after N steps (restart test)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainConfig(
        optimizer=OptimizerConfig(learning_rate=args.lr, warmup_steps=20,
                                  decay_steps=max(args.steps, 100)),
        remat=args.remat, microbatches=args.microbatches)
    # float32 products in full float32, as the JAX package computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(args.device)
    mesh = process_group_mesh(device)
    lead = mesh is None or dist.get_rank() == 0
    if mesh is not None:
        device = mesh_device(mesh)
    rules = make_rules(cfg, mesh) if mesh is not None else None

    def scope():
        return mesh_context(mesh, rules) if mesh is not None else contextlib.nullcontext()

    loader = make_loader(cfg, num_seqs=args.num_seqs, seq_len=args.seq_len,
                         batch_seqs=args.batch_seqs, replicas=args.replicas,
                         transport=args.transport)

    # -- state: init or resume (restored into the bare shapes, so that a
    # full-width state is never held twice)
    mgr = CheckpointManager(f"{args.ckpt_dir}/{cfg.name}", keep_last=2)
    latest = mgr.latest_step()
    if latest is not None:
        if lead:
            print(f"[resume] restoring step {latest}")
        like = train_state_shapes(cfg, tcfg)
        specs = state_specs(cfg, like, mesh) if mesh is not None else None
        state, man = mgr.restore(latest, like=like, device=device, mesh=mesh, specs=specs)
        loader.load_state_dict(man.cursors)
    else:
        state = init_train_state(cfg, tcfg, torch.Generator(device).manual_seed(0),
                                 device)
        if mesh is not None:
            state = place_state(state, state_specs(cfg, state, mesh), mesh)

    step_fn = make_train_step(cfg, tcfg)
    history: list[dict] = []
    t0 = time.time()
    tokens_seen = 0
    step = int(state["step"])
    data_iter = iter(loader)
    while step < args.steps:
        try:
            host_batch = next(data_iter)
        except StopIteration:
            loader.load_state_dict({"batch_offset": 0})
            data_iter = iter(loader)
            continue
        with scope():
            state, metrics = step_fn(state, batch_to_device(host_batch, device, mesh))
            h = {k: float(whole(v)) for k, v in metrics.items()}
        step = int(state["step"])
        h = {"step": step, **h}
        history.append(h)
        tokens_seen += int(h["tokens"])
        if lead and step % args.log_every == 0:
            dt = time.time() - t0
            print(f"step {step:5d} loss {h['loss']:.4f} "
                  f"gnorm {h['grad_norm']:.3f} "
                  f"lr {h['lr']:.2e} "
                  f"tok/s {tokens_seen/max(dt,1e-9):,.0f} "
                  f"transport {loader.stats.transport_s*1e3:.1f}ms "
                  f"(backups={loader.stats.backup_requests})", flush=True)
        if args.ckpt_every and step % args.ckpt_every == 0:
            path = mgr.save(step, state, cursors=loader.state_dict())
            if lead:
                print(f"[ckpt] step {step} -> {path}")
        if args.kill_at and step >= args.kill_at:
            if lead:
                print(f"[crash] simulated failure at step {step} — relaunch "
                      "to resume from the latest checkpoint")
            return history
    mgr.save(step, state, cursors=loader.state_dict())
    final = f", final loss {history[-1]['loss']:.4f}" if history else ""
    if lead:
        print(f"done: {step} steps, {tokens_seen:,} tokens{final}")
    return history


if __name__ == "__main__":
    main()
