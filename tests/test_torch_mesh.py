"""The port under a mesh, on 4 CPU ranks, against the JAX package on 4 host
devices on the same meshes: (2, 2) ``data x model`` and (2, 1, 2) ``pod x
data x model``.

*The port's side* is one 4-rank gloo job started by
``torch.multiprocessing.spawn`` from a ``FileStore`` in ``tmp_path``: both
meshes, one after the other, on one process group, every case on each. Its
worker (:func:`_port_worker`) imports
only torch, numpy and ``repro_torch``: it places the parameters by
``param_specs`` (``shard_params``), the batch by ``batch_pspecs`` and the
caches by ``cache_pspecs``, and runs the model under ``mesh_context``.
*JAX's side* is one subprocess of this file (:func:`_jax_main`) under
``XLA_FLAGS=--xla_force_host_platform_device_count=4``: the JAX package,
unchanged, under its ``mesh_context`` and ``jax.jit`` with ``param_specs``
shardings. Both read one pickle of numpy inputs made here from seeds (JAX's
init, norms ``1 + 0.1 N(0, 1)`` as ``test_torch_families.py`` sets them,
carried to the port by ``models/convert.py``) and write their outputs as
numpy.

Cases: one reduced config of every family (granite-3-2b, gemma-2b with its
one K/V head, olmoe-1b-7b, internvl2-76b, mamba2-780m, zamba2-1.2b,
whisper-small); granite with 3 query and 3 K/V heads, which do not divide
``model``, under both ``attn_fallback`` options; granite under
``layout="fsdp"``. Each: forward and loss, prefill then one decode step on
the cache grown by ``EXTRA`` slots, one AdamW train step. Besides: one
olmoe MoE layer at capacity factor 0.5, where G = 2 token groups route and
drop on their own; ``compressed_psum_pod`` at 2 pods; a checkpoint saved
from DTensors and restored onto the mesh; a record batch landed by
``training_batch_specs``.

Tolerances, the families tests' (``test_torch_families.py``): logits and
cache leaves ``rtol = atol = 1e-4`` (``MODEL_TOL``); loss ``rel 1e-5``;
the train step's gradient norm ``rel 1e-4``, moments ``1e-3`` of each
leaf's largest value and parameters within twice the learning rate
(``assert_states_close``); the MoE layer's output ``3e-5``
(``test_torch_moe.py``). Bit for bit: the MoE's routing and drops
(``gate_ids``, ``slot``, ``keep`` of each group), the int32 payload of
``compressed_psum_pod``, the checkpoint round trip and the landed batch.
``compressed_psum_pod``'s pod-mean gradients and new error feedback (the
same float32 operations in the same order, which XLA may contract into one
rounding) within 4 float32 ulps of the leaf's largest pod-mean gradient,
the magnitude of the values rounded. The SSM families' JAX side runs ``ssd_chunked`` with its
mask before the ``exp``, as ``test_torch_families.py`` does (JAX's own
gradient is NaN there; the values are the same).

Each job runs under its own timeout, so that a hung rank fails the tests
instead of the run. The port's job writes its progress after every case:
it fails when ``STALL_TIMEOUT`` passes with no progress, or ``PORT_TIMEOUT``
in all; the JAX job within ``JAX_TIMEOUT``. On an idle 8-core host the
(2, 2) mesh's cases took 40 s and the (2, 1, 2) mesh's 109 s (DTensor's
sharding propagation of each new op costs more on three mesh dims); beside
five other test workers the (2, 1, 2) mesh alone took longer than 240 s.
"""
import dataclasses
import logging
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
HEADS3 = {"num_heads": 3, "num_kv_heads": 3}
CASES = {   # name -> (arch, config overrides, sharding options)
    "granite": ("granite-3-2b", {}, {}),
    "gemma": ("gemma-2b", {}, {}),
    "olmoe": ("olmoe-1b-7b", {}, {}),
    "internvl2": ("internvl2-76b", {}, {}),
    "mamba2": ("mamba2-780m", {}, {}),
    "zamba2": ("zamba2-1.2b", {}, {}),
    "whisper": ("whisper-small", {}, {}),
    "heads3-replicate": ("granite-3-2b", HEADS3, {"attn_fallback": "replicate"}),
    "heads3-head_dim": ("granite-3-2b", HEADS3, {"attn_fallback": "head_dim"}),
    "granite-fsdp": ("granite-3-2b", {}, {"layout": "fsdp", "global_batch": 4}),
}
# JAX's cache_pspecs under layout="fsdp" shards the batch over ``model`` and
# then the cache's head dim over it again, a spec JAX refuses (ROADMAP.md,
# faults of the reference): that case runs forward, loss and the train step
NO_CACHE = {"granite-fsdp"}
B, S, EXTRA = 4, 12, 4
ONE_STEP = dict(learning_rate=1e-3, warmup_steps=0, decay_steps=10)
MOE_CAPACITY = 0.5
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
LAYER_TOL = dict(rtol=3e-5, atol=3e-5)
# compressed_psum_pod's float32 results: XLA may contract a product and a
# sum into one rounding (measured: 1 ulp of the targets' magnitude, which
# the largest pod-mean gradient gives)
EPS32, PSUM_ULPS = float(np.finfo(np.float32).eps), 4
KV_KEYS = ("k", "v", "self_k", "self_v")
SERVE_REQUESTS, SERVE_NEW = 8, 6
TRAIN_ARGS = ["--arch", "granite-3-2b", "--reduced", "--device", "cpu", "--steps", "3",
              "--batch-seqs", "4", "--seq-len", "32", "--num-seqs", "64", "--lr", "1e-2",
              "--log-every", "100", "--ckpt-every", "0"]
STALL_TIMEOUT = 240    # seconds with no case finished: a hung rank
PORT_TIMEOUT = 900     # the port's whole job, both meshes
JAX_TIMEOUT = 300
WORLD = 4


def _prefix(cfg):
    return cfg.vlm.num_patches if cfg.family == "vlm" else 0


def _torch_cfg(case):
    from repro_torch.configs import get_config
    arch, over, _ = CASES[case]
    return dataclasses.replace(get_config(arch).reduced(), **over)


# ---------------------------------------------------------------- the port's side

def _np(x):
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tree_np(tree):
    return {k: _tree_np(v) for k, v in tree.items()} if isinstance(tree, dict) else _np(tree)


def _port_case(case, inp, mesh):
    from repro_torch import models as M
    from repro_torch.models import sharding as sh
    from repro_torch.training import OptimizerConfig, TrainConfig, make_train_step

    cfg, (_, _, opts) = _torch_cfg(case), CASES[case]
    rules = sh.make_rules(cfg, mesh, opts)
    cpu = torch.device("cpu")

    def place(tree, specs):
        return M.shard_params(M.params_from_numpy(tree, cpu), specs, mesh)

    def place_batch(batch):
        specs = M.batch_pspecs(cfg, batch, mesh, opts)
        return {k: sh.from_full(torch.from_numpy(v), mesh, specs[k], cpu)
                for k, v in batch.items()}

    out = {}
    with sh.mesh_context(mesh, rules):
        pspecs = M.param_specs(cfg, inp["params"], mesh, opts)
        params = place(inp["params"], pspecs)
        batch = place_batch(inp["batch"])
        logits = M.forward(cfg, params, batch, remat="none")
        out["logits"] = _np(logits)
        out["loss"] = _np(M.loss_fn(cfg, params, batch, remat="none"))
        if case not in NO_CACHE:
            head = place_batch({k: v for k, v in inp["batch"].items() if k != "labels"})
            plogits, cache = M.prefill(cfg, params, head)
            out["prefill_logits"] = _np(plogits)
            out["prefill_cache"] = _tree_np(cache)
            grown = {k: np.pad(v, [(0, 0), (0, 0), (0, EXTRA), (0, 0), (0, 0)])
                     if k in KV_KEYS else v for k, v in out["prefill_cache"].items()}
            cache = place(grown, M.cache_pspecs(cfg, grown, mesh, opts))
            tok = place_batch({"tokens": inp["next_token"]})["tokens"]
            dlogits, cache = M.decode(cfg, params, cache, tok, _prefix(cfg) + S)
            out["decode_logits"] = _np(dlogits)
            out["decode_cache"] = _tree_np(cache)

        st = inp["state"]
        state = {"params": place(st["params"], pspecs),
                 "opt": {k: place(v, pspecs) for k, v in st["opt"].items()},
                 "step": torch.from_numpy(np.array(st["step"]))}
        step = make_train_step(cfg, TrainConfig(optimizer=OptimizerConfig(**ONE_STEP),
                                                remat="none"))
        state, metrics = step(state, place_batch(inp["train_batch"]))
        out["train_metrics"] = {k: float(_np(v)) for k, v in metrics.items()}
        out["train_state"] = _tree_np(state)
        out["placements"] = {k: str(v.placements) for k, v in
                             (("embed", params["embed"]), ("logits", logits))}
    return out


def _group_index(mesh, rules) -> int:
    """This rank's token group: its index over the batch's mesh dims."""
    batch = rules["batch"]
    axes = (batch,) if isinstance(batch, str) else batch
    names = list(mesh.mesh_dim_names)
    g = 0
    for a in axes:
        i = names.index(a)
        g = g * mesh.size(i) + mesh.get_coordinate()[i]
    return g


def _port_moe_layer(inp, mesh):
    """One olmoe MoE layer on DTensors at ``MOE_CAPACITY``: its output and
    every group's routing, recorded on the rank that ran the group."""
    from repro_torch.models import moe, sharding as sh
    cfg = _torch_cfg("olmoe")
    m = dataclasses.replace(cfg.moe, capacity_factor=MOE_CAPACITY)
    rules = sh.make_rules(cfg, mesh)
    routes, route = [], moe.route

    def recording(*args):
        r = route(*args)
        routes.append({k: r.__dict__[k].numpy().copy() for k in ("gate_ids", "slot", "keep")})
        return r

    moe.route = recording
    try:
        with sh.mesh_context(mesh, rules):
            x = sh.from_full(torch.from_numpy(inp["moe_x"]), mesh,
                             sh.spec_of(("batch", None, None), rules, inp["moe_x"].shape, mesh),
                             torch.device("cpu"))
            p = {k: sh.from_full(torch.from_numpy(v), mesh, (), torch.device("cpu"))
                 for k, v in inp["moe_p"].items()}
            y = moe.moe_ffn(x, p, m, cfg.activation)
            G = sh.dispatch_groups()
            g = _group_index(mesh, rules)
    finally:
        moe.route = route
    mine = [(g * len(routes) + i, r) for i, r in enumerate(routes)]
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, mine)
    groups = dict(item for rank in everyone for item in rank)
    return {"y": _np(y), "G": G, "routes": [groups[i] for i in range(G)]}


def _port_psum(inp, mesh):
    from repro_torch.training.compression import compressed_psum_pod, pod_reduce_leaf
    pod = mesh.get_coordinate()[list(mesh.mesh_dim_names).index("pod")]
    g = {k: torch.from_numpy(v[pod]) for k, v in inp["psum_g"].items()}
    e = {k: torch.from_numpy(v[pod]) for k, v in inp["psum_e"].items()}
    mean, new_e = compressed_psum_pod(g, e, mesh)
    group = mesh.get_group("pod")
    acc = {k: pod_reduce_leaf(g[k], e[k], group, 2)[2].numpy() for k in g}
    mine = (pod, _tree_np(mean), _tree_np(new_e), acc)
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, mine)
    return {p: (m_, e_, a_) for p, m_, e_, a_ in everyone}


def _port_checkpoint_and_landing(inp, mesh, ckpt_dir):
    """A DTensor train state saved (rank 0 writes full tensors) and
    restored onto the mesh by its specs; a record batch landed by
    ``training_batch_specs`` on both paths."""
    from repro_torch import models as M
    from repro_torch.core import batch_from_arrays, schema
    from repro_torch.core.device_transport import (batch_to_device, batch_to_device_packed,
                                                   training_batch_specs)
    from repro_torch.training import CheckpointManager
    cfg = _torch_cfg("granite")
    pspecs = M.param_specs(cfg, inp["params"], mesh)
    params = M.shard_params(M.params_from_numpy(inp["params"], "cpu"), pspecs, mesh)
    mgr = CheckpointManager(ckpt_dir, keep_last=1)
    mgr.save(3, {"params": params})
    restored, man = mgr.restore(3, like={"params": params}, mesh=mesh,
                                specs={"params": pspecs})
    same = all(tuple(r.placements) == tuple(p.placements)
               and np.array_equal(_np(r), _np(p))
               for r, p in zip(_leaves(restored["params"]), _leaves(params)))
    rows = inp["landing"]
    rb = batch_from_arrays(schema(("tokens", "int32"), ("x", "float64")),
                           [rows["tokens"], rows["x"]])
    spec = training_batch_specs(mesh)
    landed = {}
    for name, fn in (("thallus", batch_to_device), ("rpc", batch_to_device_packed)):
        db = fn(rb, mesh=mesh, specs=spec)
        landed[name] = {k: (_np(v), str(v.placements)) for k, v in db.columns.items()}
    return {"ckpt_same": same, "ckpt_step": man.step, "spec": spec, "landed": landed}


def _leaves(tree):
    from repro_torch.training.tree import tree_leaves
    return tree_leaves(tree)


def _port_launchers(inp, mesh, ckpt_dir):
    """``launch.serve.serve`` on the mesh against the same call on plain
    tensors in this rank; ``launch.train.main`` under the process group
    (its own ``make_host_mesh()``)."""
    from repro_torch.launch.serve import make_requests, serve
    from repro_torch.launch.train import main
    from repro_torch.models import params_from_numpy
    cfg = _torch_cfg("granite")
    reqs = make_requests(cfg, SERVE_REQUESTS, 10, SERVE_NEW)
    plain = serve(cfg, params_from_numpy(inp["params"], "cpu"), reqs, 4, "cpu")
    sharded = serve(cfg, params_from_numpy(inp["params"], "cpu"), reqs, 4, "cpu", mesh=mesh)
    history = main(TRAIN_ARGS + ["--ckpt-dir", ckpt_dir])
    return {"plain": [c.tokens for c in plain.completions],
            "sharded": [c.tokens for c in sharded.completions], "train": history}


def _port_mesh(inp, mesh_key, mesh, ckpt_dir, progress):
    """Every case, the MoE layer, the pods, checkpoint and landing, and the
    launchers on one mesh of the group."""
    from repro_torch.launch.mesh import make_host_mesh
    names = MESHES[mesh_key][1]
    out = {"cases": {}, "host_mesh": None}
    for case in CASES:
        out["cases"][case] = _port_case(case, inp[case], mesh)
        progress(f"{mesh_key} {case}")
    out["moe_layer"] = _port_moe_layer(inp["olmoe"], mesh)
    if "pod" in names:
        out["psum"] = _port_psum(inp, mesh)
    out["io"] = _port_checkpoint_and_landing(inp["granite"], mesh, ckpt_dir)
    progress(f"{mesh_key} io")
    out["launch"] = _port_launchers(inp["granite"], mesh, ckpt_dir + "-launch")
    host = make_host_mesh()
    out["host_mesh"] = (tuple(host.mesh_dim_names), tuple(host.mesh.shape))
    progress(f"{mesh_key} launch")
    return out


def _port_worker(rank, store_path, in_path, out_path, ckpt_dir, progress_path):
    torch.set_num_threads(1)       # four ranks share the host's cores
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    t0 = time.perf_counter()

    def progress(stage):
        if rank == 0:
            with open(progress_path, "a") as f:
                f.write(f"{time.perf_counter() - t0:.1f} {stage}\n")

    try:
        from repro_torch.launch.mesh import make_mesh
        with open(in_path, "rb") as f:
            inp = pickle.load(f)
        out = {}
        for mesh_key, (shape, names) in MESHES.items():
            t = time.perf_counter()
            out[mesh_key] = _port_mesh(inp, mesh_key, make_mesh(shape, names),
                                       f"{ckpt_dir}-{mesh_key}", progress)
            out[mesh_key]["seconds"] = time.perf_counter() - t
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _run_port(tmp, in_path):
    """The port's job on both meshes; raises when no case finishes within
    ``STALL_TIMEOUT`` or the job passes ``PORT_TIMEOUT``, naming the last
    stage done."""
    out_path, progress = tmp / "port.pkl", tmp / "port-progress.txt"
    progress.touch()
    ctx = mp.start_processes(_port_worker, nprocs=WORLD, join=False, start_method="spawn",
                             args=(str(tmp / "store"), str(in_path), str(out_path),
                                   str(tmp / "ckpt"), str(progress)))
    start = time.monotonic()
    try:
        while not ctx.join(timeout=5):
            now = time.monotonic()
            stalled = time.time() - progress.stat().st_mtime > STALL_TIMEOUT
            if stalled or now - start > PORT_TIMEOUT:
                done = progress.read_text().strip().splitlines()
                raise TimeoutError(
                    f"the port's job {'made no progress for' if stalled else 'passed'} "
                    f"{STALL_TIMEOUT if stalled else PORT_TIMEOUT} s, at {now - start:.0f} s; "
                    f"last stage done: {done[-1] if done else 'none'}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    with open(out_path, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------- JAX's side

def _jax_main(in_path, out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

    from repro.configs import get_config
    from repro.models import (batch_pspecs, cache_pspecs, decode, forward, loss_fn,
                              make_rules, mesh_context, param_specs, prefill)
    from repro.models import mamba2 as jmamba2
    from repro.models import moe as jmoe
    from repro.training import OptimizerConfig, TrainConfig, make_train_step
    from repro.training.compression import compressed_psum_pod, quantize_int8
    from test_torch_families import jax_ssd_chunked_masked
    from test_torch_moe import jax_route

    jmamba2.ssd_chunked = jax_ssd_chunked_masked
    assert len(jax.devices()) == WORLD
    with open(in_path, "rb") as f:
        inp = pickle.load(f)
    np_tree = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    result = {}
    for mesh_key, (shape, names) in MESHES.items():
        mesh = jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))

        def put(tree, specs):
            return jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                                tree, specs, is_leaf=lambda x: isinstance(x, P))

        res = {"cases": {}}
        for case, (arch, over, opts) in CASES.items():
            cfg = dataclasses.replace(get_config(arch).reduced(), **over)
            c = inp[case]
            out = {}
            with mesh_context(mesh, make_rules(cfg, mesh, opts)):
                pspecs = param_specs(cfg, c["params"], mesh, opts)
                params = put(c["params"], pspecs)

                def put_batch(b):
                    return put(b, batch_pspecs(cfg, b, mesh, opts))

                batch = put_batch(c["batch"])
                out["logits"] = np.asarray(jax.jit(
                    lambda p, b: forward(cfg, p, b, remat="none"))(params, batch))
                out["loss"] = np.asarray(jax.jit(
                    lambda p, b: loss_fn(cfg, p, b, remat="none"))(params, batch))
                if case not in NO_CACHE:
                    head = put_batch({k: v for k, v in c["batch"].items() if k != "labels"})
                    logits, cache = jax.jit(
                        lambda p, b: prefill(cfg, p, b, remat="none"))(params, head)
                    out["prefill_logits"] = np.asarray(logits)
                    out["prefill_cache"] = np_tree(cache)
                    grown = {k: np.pad(v, [(0, 0), (0, 0), (0, EXTRA), (0, 0), (0, 0)])
                             if k in KV_KEYS else v for k, v in out["prefill_cache"].items()}
                    cache = put(grown, cache_pspecs(cfg, grown, mesh, opts))
                    tok = put_batch({"tokens": c["next_token"]})["tokens"]
                    logits, cache = jax.jit(lambda p, ca, t, i: decode(cfg, p, ca, t, i))(
                        params, cache, tok, jnp.int32(_prefix(cfg) + S))
                    out["decode_logits"] = np.asarray(logits)
                    out["decode_cache"] = np_tree(cache)
                st = c["state"]
                state = put(st, {"params": pspecs, "opt": {k: pspecs for k in st["opt"]},
                                 "step": P()})
                step = jax.jit(make_train_step(cfg, TrainConfig(
                    optimizer=OptimizerConfig(**ONE_STEP), remat="none")))
                state, metrics = step(state, put_batch(c["train_batch"]))
                out["train_metrics"] = {k: float(v) for k, v in metrics.items()}
                out["train_state"] = np_tree(state)
            res["cases"][case] = out

        # one MoE layer, G = 2 groups from the mesh's batch shards
        cfg = get_config("olmoe-1b-7b").reduced()
        m = dataclasses.replace(cfg.moe, capacity_factor=MOE_CAPACITY)
        with mesh_context(mesh, make_rules(cfg, mesh)):
            x = inp["olmoe"]["moe_x"]
            xs = put({"x": x}, batch_pspecs(cfg, {"x": x}, mesh))["x"]
            y = jax.jit(lambda x, p: jmoe.moe_ffn(x, p, m, cfg.activation))(
                xs, jax.tree.map(jnp.asarray, inp["olmoe"]["moe_p"]))
            from repro.models.sharding import dispatch_groups
            G = dispatch_groups()
        T = B * S
        xg = x.reshape(G, T // G, -1)
        C = jmoe.capacity_for(T // G, m)
        routes = [jax_route(jnp.asarray(xg[g]), jnp.asarray(inp["olmoe"]["moe_p"]["router"]),
                            m, C) for g in range(G)]
        res["moe_layer"] = {"y": np.asarray(y), "G": G, "routes": routes}

        if "pod" in names:
            def one_pod(g, e):
                g = {k: v[0] for k, v in g.items()}
                e = {k: v[0] for k, v in e.items()}
                mean, new_e = compressed_psum_pod(g, e, "pod")
                acc = {k: jax.lax.psum(quantize_int8(g[k].astype(jnp.float32) + e[k])[0]
                                       .astype(jnp.int32), "pod") for k in g}
                lead = lambda t: jax.tree.map(lambda a: a[None], t)   # noqa: E731
                return lead(mean), lead(new_e), lead(acc)

            spec = P("pod")
            fn = jax.jit(jax.shard_map(one_pod, mesh=mesh, in_specs=(spec, spec),
                                       out_specs=(spec, spec, spec)))
            mean, new_e, acc = np_tree(fn(inp["psum_g"], inp["psum_e"]))
            res["psum"] = {p: ({k: v[p] for k, v in mean.items()},
                               {k: v[p] for k, v in new_e.items()},
                               {k: v[p] for k, v in acc.items()}) for p in range(2)}
        result[mesh_key] = res
    with open(out_path, "wb") as f:
        pickle.dump(result, f)


# ---------------------------------------------------------------- inputs and the jobs

def _inputs():
    """Every case's numpy inputs: JAX's init with perturbed norms, batches,
    the decode token, the train state; the MoE layer's; the pod leaves."""
    import jax

    from repro.configs import get_config
    from repro.models import init_params
    from repro.models import moe as jmoe
    from repro.training import OptimizerConfig, TrainConfig, init_train_state
    from repro_torch.data import shift_labels
    from test_torch_families import _perturb_norms

    out = {}
    for i, (case, (arch, over, _)) in enumerate(CASES.items()):
        cfg = dataclasses.replace(get_config(arch).reduced(), **over)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(_torch_cfg(case))
        params = jax.tree.map(np.asarray, init_params(cfg, jax.random.PRNGKey(i)))
        _perturb_norms(params, np.random.default_rng(100 + i))
        rng = np.random.default_rng(200 + i)

        def batch():
            toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            b = {"tokens": toks, "labels": shift_labels(toks)}
            if cfg.family == "vlm":
                b["patch_embeds"] = rng.standard_normal(
                    (B, cfg.vlm.num_patches, cfg.d_model)).astype(np.float32)
            if cfg.family == "audio":
                b["frames"] = rng.standard_normal(
                    (B, cfg.encdec.encoder_seq, cfg.d_model)).astype(np.float32)
            return b

        state = jax.tree.map(np.asarray, init_train_state(
            cfg, TrainConfig(optimizer=OptimizerConfig(**ONE_STEP), remat="none"),
            jax.random.PRNGKey(0)))
        state["params"] = jax.tree.map(np.copy, params)
        state["opt"]["master"] = jax.tree.map(np.copy, params)
        c = {"params": params, "batch": batch(), "train_batch": batch(), "state": state,
             "next_token": rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)}
        c["batch"]["labels"][0, :3] = -1
        out[case] = c
    olmoe = get_config("olmoe-1b-7b").reduced()
    rng = np.random.default_rng(300)
    out["olmoe"]["moe_x"] = rng.standard_normal((B, S, olmoe.d_model)).astype(np.float32)
    out["olmoe"]["moe_p"] = jax.tree.map(np.asarray, jmoe.init_moe_params(
        jax.random.PRNGKey(3), olmoe.d_model, olmoe.moe, np.float32))
    shapes = {"w": (33, 17), "b": (40,), "tie": (8,)}
    out["psum_g"] = {k: rng.standard_normal((2,) + s).astype(np.float32) for k, s in shapes.items()}
    out["psum_e"] = {k: (1e-2 * rng.standard_normal((2,) + s)).astype(np.float32)
                     for k, s in shapes.items()}
    out["psum_g"]["tie"][:, :2] = [127 * 2.0 ** -10, 0.5 * 2.0 ** -10]   # exact .5 ties
    out["granite"]["landing"] = {"tokens": np.arange(4 * 24, dtype=np.int32),
                                 "x": rng.standard_normal(4 * 24)}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    in_path, jax_out = tmp / "inputs.pkl", tmp / "jax.pkl"
    with open(in_path, "wb") as f:
        pickle.dump(_inputs(), f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    jax_job = subprocess.Popen([sys.executable, __file__, "jax", str(in_path), str(jax_out)],
                               env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        port = _run_port(tmp, in_path)
        log, _ = jax_job.communicate(timeout=JAX_TIMEOUT)
    finally:
        if jax_job.poll() is None:
            jax_job.kill()
            jax_job.wait()
    assert jax_job.returncode == 0, log.decode()[-4000:]
    with open(jax_out, "rb") as f:
        return port, pickle.load(f)


def _pair(runs, mesh_key, case):
    port, jax_res = runs
    return port[mesh_key]["cases"][case], jax_res[mesh_key]["cases"][case]


def _paths(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    out = {}
    for k in sorted(tree):
        out.update(_paths(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


MESH_CASES = [(m, c) for m in MESHES for c in CASES]
SERVE_CASES = [(m, c) for m, c in MESH_CASES if c not in NO_CACHE]


# ---------------------------------------------------------------- the model, case by case

@pytest.mark.parametrize("mesh_key,case", MESH_CASES)
def test_forward_matches_jax_on_the_mesh(runs, mesh_key, case):
    got, want = _pair(runs, mesh_key, case)
    assert got["logits"].shape == want["logits"].shape
    assert want["logits"][..., :_torch_cfg(case).vocab_size].std() > 0.1
    np.testing.assert_allclose(got["logits"], want["logits"], **MODEL_TOL)


@pytest.mark.parametrize("mesh_key,case", MESH_CASES)
def test_loss_matches_jax_on_the_mesh(runs, mesh_key, case):
    got, want = _pair(runs, mesh_key, case)
    assert float(want["loss"]) > 1.0
    assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-5)


@pytest.mark.parametrize("mesh_key,case", SERVE_CASES)
def test_prefill_matches_jax_on_the_mesh(runs, mesh_key, case):
    got, want = _pair(runs, mesh_key, case)
    np.testing.assert_allclose(got["prefill_logits"], want["prefill_logits"], **MODEL_TOL)
    assert got["prefill_cache"].keys() == want["prefill_cache"].keys()
    for name, w in want["prefill_cache"].items():
        assert np.abs(w).max() > 0.1
        np.testing.assert_allclose(got["prefill_cache"][name], w, **MODEL_TOL, err_msg=name)


@pytest.mark.parametrize("mesh_key,case", SERVE_CASES)
def test_decode_matches_jax_on_the_mesh(runs, mesh_key, case):
    """One step on the cache grown by ``EXTRA`` slots: the logits and every
    cache leaf (the new slot written in place on the port's DTensors)."""
    got, want = _pair(runs, mesh_key, case)
    np.testing.assert_allclose(got["decode_logits"], want["decode_logits"], **MODEL_TOL)
    for name, w in want["decode_cache"].items():
        np.testing.assert_allclose(got["decode_cache"][name], w, **MODEL_TOL, err_msg=name)


@pytest.mark.parametrize("mesh_key,case", MESH_CASES)
def test_train_step_matches_jax_on_the_mesh(runs, mesh_key, case):
    from test_torch_train import assert_states_close
    got, want = _pair(runs, mesh_key, case)
    gm, wm = got["train_metrics"], want["train_metrics"]
    assert gm["loss"] == pytest.approx(wm["loss"], rel=1e-5)
    assert gm["grad_norm"] == pytest.approx(wm["grad_norm"], rel=1e-4)
    assert gm["lr"] == pytest.approx(wm["lr"], rel=1e-6) and wm["lr"] > 0
    assert gm["tokens"] == wm["tokens"] == B * S
    assert_states_close(got["train_state"], want["train_state"], 2 * wm["lr"])


@pytest.mark.parametrize("mesh_key", MESHES)
def test_parameters_and_outputs_are_dtensors_sharded_by_the_rules(runs, mesh_key):
    port, _ = runs
    placed = port[mesh_key]["cases"]["granite"]["placements"]
    # embed: ("vocab", "fsdp") -> model, data; logits: batch rows, vocab on model
    if mesh_key == "2x2":
        assert placed["embed"] == "(Shard(dim=1), Shard(dim=0))"
    else:       # a mesh dim of one rank shards nothing
        assert placed["embed"] == "(Replicate(), Replicate(), Shard(dim=0))"
    assert "Shard(dim=2)" in placed["logits"]


# ---------------------------------------------------------------- MoE groups

@pytest.mark.parametrize("mesh_key", MESHES)
def test_moe_groups_route_and_drop_as_jax(runs, mesh_key):
    """G = 2 on both meshes (2 batch shards): each group routes, sorts and
    drops on the rank that holds it, exactly as JAX's groups do."""
    port, jax_res = runs
    got, want = port[mesh_key]["moe_layer"], jax_res[mesh_key]["moe_layer"]
    assert got["G"] == want["G"] == 2
    dropped = 0
    for g, (r, w) in enumerate(zip(got["routes"], want["routes"])):
        for key in ("gate_ids", "slot", "keep"):
            np.testing.assert_array_equal(r[key], w[key], err_msg=f"group {g} {key}")
        dropped += int((~w["keep"]).sum())
    assert dropped > 0, "the capacity must drop pairs for the drop pattern to count"
    np.testing.assert_allclose(got["y"], want["y"], **LAYER_TOL)


# ---------------------------------------------------------------- pods

def test_compressed_psum_pod_matches_jax_at_two_pods(runs):
    port, jax_res = runs
    got, want = port["2x1x2"]["psum"], jax_res["2x1x2"]["psum"]
    for pod in (0, 1):
        for name, w in want[pod][2].items():
            assert got[pod][2][name].dtype == w.dtype == np.int32
            np.testing.assert_array_equal(got[pod][2][name], w, err_msg=f"pod {pod} payload {name}")
        for i, what in ((0, "mean gradient"), (1, "error feedback")):
            for name, w in want[pod][i].items():
                g = got[pod][i][name]
                scale = np.abs(want[pod][0][name]).max()      # the targets' magnitude
                assert g.dtype == w.dtype == np.float32, (what, name)
                np.testing.assert_allclose(g, w, rtol=0, atol=PSUM_ULPS * EPS32 * scale,
                                           err_msg=f"pod {pod} {what} {name}")
    # the payload is the sum of two pods' int8 values, the same on both
    np.testing.assert_array_equal(got[0][2]["w"], got[1][2]["w"])
    assert np.abs(got[0][2]["w"]).max() > 127


# ---------------------------------------------------------------- checkpoint, landing, meshes

@pytest.mark.parametrize("mesh_key", MESHES)
def test_checkpoint_of_dtensors_restores_onto_the_mesh(runs, mesh_key):
    io = runs[0][mesh_key]["io"]
    assert io["ckpt_same"] and io["ckpt_step"] == 3


@pytest.mark.parametrize("mesh_key", MESHES)
def test_batches_land_by_training_batch_specs(runs, mesh_key):
    port, _ = runs
    io = port[mesh_key]["io"]
    want_spec = ("data",) if mesh_key == "2x2" else (("pod", "data"),)
    assert io["spec"] == want_spec
    for path in ("thallus", "rpc"):
        tokens, placed = io["landed"][path]["tokens"]
        np.testing.assert_array_equal(tokens, np.arange(4 * 24, dtype=np.int32))
        assert "Shard(dim=0)" in placed and "Replicate()" in placed
    np.testing.assert_array_equal(io["landed"]["thallus"]["x"][0], io["landed"]["rpc"]["x"][0])


@pytest.mark.parametrize("mesh_key", MESHES)
def test_serve_launcher_on_the_mesh_gives_the_plain_tokens(runs, mesh_key):
    launch = runs[0][mesh_key]["launch"]
    assert len(launch["sharded"]) == SERVE_REQUESTS
    assert launch["sharded"] == launch["plain"]
    assert len({t for c in launch["plain"] for t in c}) > 1     # real tokens, not one id


@pytest.fixture(scope="module")
def plain_train(tmp_path_factory):
    from repro_torch.launch.train import main
    return main(TRAIN_ARGS + ["--ckpt-dir", str(tmp_path_factory.mktemp("plain-ckpt"))])


@pytest.mark.parametrize("mesh_key", MESHES)
def test_train_launcher_under_the_group_matches_one_process(runs, plain_train, mesh_key):
    """torchrun's path: ``launch.train.main`` on 4 ranks (mesh (1, 4) by
    ``make_host_mesh``), DTensor state, batches by ``training_batch_specs``,
    against the same launcher in one process with no group."""
    got = runs[0][mesh_key]["launch"]["train"]
    assert [h["step"] for h in got] == [h["step"] for h in plain_train] == [1, 2, 3]
    for g, w in zip(got, plain_train):
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-4)
        assert g["tokens"] == w["tokens"]
    assert got[-1]["loss"] != got[0]["loss"]      # the steps move the norms


def test_host_mesh_takes_the_largest_model_dim(runs):
    port, _ = runs
    for key in MESHES:
        assert port[key]["host_mesh"] == (("data", "model"), (1, 4))


if __name__ == "__main__" and sys.argv[1:2] == ["jax"]:
    _jax_main(sys.argv[2], sys.argv[3])


# ---------------------------------------------------------------- one rank, (1, 1)

@pytest.fixture
def one_rank_mesh():
    """A one-rank gloo group in this process and its ``make_host_mesh()``,
    (1, 1): the layout ``chip_smoke.py`` phase 10 runs on one card."""
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_host_mesh()
    finally:
        dist.destroy_process_group()


def _granite_with_norms():
    from repro_torch.models import init_params
    from repro_torch.training.tree import flatten_with_paths
    cfg = _torch_cfg("granite")
    g = torch.Generator().manual_seed(5)
    params = init_params(cfg, g, device="cpu")
    for name, leaf in flatten_with_paths(params):
        if name.endswith(("ln1", "ln2", "final_norm")):
            leaf.copy_(1.0 + 0.1 * torch.randn(leaf.shape, generator=g))
    return cfg, params


def test_one_rank_mesh_serves_prefills_and_trains_as_plain_tensors(one_rank_mesh):
    """On (1, 1) every DTensor op runs the plain op on the whole tensor:
    the served tokens, the prefill's logits and cache and a train step's
    loss and parameters equal the plain run's bit for bit."""
    from torch.distributed.tensor import DTensor

    from repro_torch import models as M
    from repro_torch.launch.serve import make_requests, serve
    from repro_torch.models import sharding as sh
    from repro_torch.training import OptimizerConfig, TrainConfig, init_train_state, make_train_step
    from repro_torch.launch.train import place_state, state_specs
    assert tuple(one_rank_mesh.mesh.shape) == (1, 1)
    cfg, params = _granite_with_norms()
    reqs = make_requests(cfg, SERVE_REQUESTS, 10, SERVE_NEW)
    plain = serve(cfg, params, reqs, 4, "cpu")
    sharded = serve(cfg, params, reqs, 4, "cpu", mesh=one_rank_mesh)
    assert [c.tokens for c in sharded.completions] == [c.tokens for c in plain.completions]

    specs = M.param_specs(cfg, params, one_rank_mesh)
    dparams = M.shard_params(params, specs, one_rank_mesh)
    assert isinstance(dparams["embed"], DTensor)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 500, (4, 12)).astype(np.int32))
    want_logits, want_cache = M.prefill(cfg, params, {"tokens": tokens})
    with sh.mesh_context(one_rank_mesh, sh.make_rules(cfg, one_rank_mesh)):
        logits, cache = M.prefill(cfg, dparams, {"tokens": tokens})
    assert torch.equal(logits.full_tensor(), want_logits)
    for k in want_cache:
        assert torch.equal(cache[k].full_tensor(), want_cache[k]), k

    tc = TrainConfig(optimizer=OptimizerConfig(**ONE_STEP), remat="full")
    batch = {"tokens": tokens.long(), "labels": tokens.roll(-1, 1).long()}
    ref_state = init_train_state(cfg, tc, torch.Generator().manual_seed(0), "cpu")
    state = init_train_state(cfg, tc, torch.Generator().manual_seed(0), "cpu")
    state = place_state(state, state_specs(cfg, state, one_rank_mesh), one_rank_mesh)
    _, want = make_train_step(cfg, tc)(ref_state, batch)
    with sh.mesh_context(one_rank_mesh, sh.make_rules(cfg, one_rank_mesh)):
        _, got = make_train_step(cfg, tc)(state, batch)
    assert float(sh.whole(got["loss"])) == float(want["loss"])
    assert float(sh.whole(got["grad_norm"])) == float(want["grad_norm"])
    assert torch.equal(state["params"]["embed"].full_tensor(), ref_state["params"]["embed"])
