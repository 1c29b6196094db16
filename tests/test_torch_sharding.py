"""The port's sharding rules and specs (``repro_torch.models.sharding``,
``models.param_specs``/``cache_pspecs``/``batch_pspecs``) against the JAX
package's, on the CPU, and the MoE's token groups at G > 1 with no process
group.

The rules and every leaf's spec must equal JAX's entry for entry
(``tuple(PartitionSpec)``), for every arch at the production meshes (16,
16) and (2, 16, 16) (the ``FakeMesh`` of ``tests/test_sharding.py``: only
``.shape`` and ``.axis_names``), under both ``attn_fallback`` options and
under ``layout="fsdp"`` with a ``global_batch``. The MoE layer at G = 2 and
4 is held to JAX's ``moe_ffn`` with ``repro.models.sharding.dispatch_groups``
patched to return the same G, with the tolerances of
``tests/test_torch_moe.py``: routing (``gate_ids``, ``slot``, ``keep``) of
every group exactly, outputs ``3e-5``, gradients ``1e-4`` of each one's
largest value. Their input has 256 tokens, so that 64-token groups still
drop pairs at a capacity factor of 0.5 (capacities are 8-aligned).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models import batch_pspecs as jax_batch_pspecs
from repro.models import cache_pspecs as jax_cache_pspecs
from repro.models import cache_spec as jax_cache_spec
from repro.models import make_rules as jax_make_rules
from repro.models import moe as jmoe
from repro.models import param_shapes as jax_param_shapes
from repro.models import param_specs as jax_param_specs
from repro.models import sharding as jsharding
from repro_torch.configs import get_config
from repro_torch.models import (batch_pspecs, cache_pspecs, cache_spec, make_rules,
                                param_shapes, param_specs)
from repro_torch.models import moe as tmoe
from repro_torch.models import sharding

from test_sharding import FakeMesh
from test_torch_moe import LAYER_TOL, _flat, _inputs, _moe_cfg, _torch, jax_route

MESHES = {"16x16": FakeMesh({"data": 16, "model": 16}),
          "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16})}
OPTIONS = {"replicate": {"attn_fallback": "replicate"},
           "head_dim": {"attn_fallback": "head_dim"},
           "fsdp": {"layout": "fsdp", "global_batch": 64}}
GRID = [(a, m, o) for a in ARCH_IDS for m in MESHES for o in OPTIONS]


def _tuples(tree):
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    assert isinstance(tree, P)
    return tuple(tree)


def _cfgs(arch):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


@pytest.mark.parametrize("arch,mesh,opts", GRID)
def test_rules_equal_jax(arch, mesh, opts):
    jcfg, tcfg = _cfgs(arch)
    want = jax_make_rules(jcfg, MESHES[mesh], OPTIONS[opts])
    assert make_rules(tcfg, MESHES[mesh], OPTIONS[opts]) == want


@pytest.mark.parametrize("arch,mesh,opts", GRID)
def test_param_specs_equal_jax(arch, mesh, opts):
    jcfg, tcfg = _cfgs(arch)
    want = _tuples(jax_param_specs(jcfg, jax_param_shapes(jcfg), MESHES[mesh], OPTIONS[opts]))
    got = param_specs(tcfg, param_shapes(tcfg), MESHES[mesh], OPTIONS[opts])
    assert got == want


@pytest.mark.parametrize("arch,mesh,opts", GRID)
def test_cache_and_batch_specs_equal_jax(arch, mesh, opts):
    jcfg, tcfg = _cfgs(arch)
    m, o = MESHES[mesh], OPTIONS[opts]
    want = _tuples(jax_cache_pspecs(jcfg, jax_cache_spec(jcfg, 32, 4096), m, o))
    assert cache_pspecs(tcfg, cache_spec(tcfg, 32, 4096), m, o) == want
    shapes = {"tokens": (64, 128), "labels": (64, 128), "position": (),
              "frames": (64, 1500, tcfg.d_model), "odd": (3, 5)}
    jb = {k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in shapes.items()}
    assert batch_pspecs(tcfg, {k: (s, torch.int32) for k, s in shapes.items()}, m, o) == \
        _tuples(jax_batch_pspecs(jcfg, jb, m, o))


SMALL = FakeMesh({"data": 2, "model": 8})


@pytest.mark.parametrize("opts", OPTIONS)
def test_reduced_configs_reach_every_fallback_as_jax(opts):
    """The production configs pad their heads to the model axis, so their
    grid never takes the fallbacks; the reduced configs (4 heads of 16
    lanes) on a (2, 8) mesh do. Rules and parameter specs equal JAX's
    there too, and between them the branches are all taken: heads on
    ``model``, the head-dim fallback, replicated attention, sharded
    experts and SSM heads."""
    seen = set()
    for arch in ARCH_IDS:
        jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
        rules = make_rules(tcfg, SMALL, OPTIONS[opts])
        assert rules == jax_make_rules(jcfg, SMALL, OPTIONS[opts])
        assert param_specs(tcfg, param_shapes(tcfg), SMALL, OPTIONS[opts]) == \
            _tuples(jax_param_specs(jcfg, jax_param_shapes(jcfg), SMALL, OPTIONS[opts]))
        seen |= {k for k in ("heads", "head_dim", "experts", "ssm_heads", "kv") if rules.get(k)}
        if tcfg.num_heads and not (rules["heads"] or rules["head_dim"]):
            seen.add("replicated attention")
    want = {"replicate": {"replicated attention", "ssm_heads"},
            "head_dim": {"head_dim", "ssm_heads"}, "fsdp": {"replicated attention"}}[opts]
    assert seen == want
    for arch, mesh, o in GRID:                 # and the production grid the rest
        rules = make_rules(get_config(arch), MESHES[mesh], OPTIONS[o])
        seen |= {k for k in ("heads", "experts", "kv") if rules.get(k)}
    assert {"heads", "experts", "kv"} <= seen


def test_spec_of_normalises_one_axis_tuples_like_partition_spec():
    rules = {"batch": ("data",), "x": ("pod", "data")}
    assert sharding.spec_of(("batch", None, "x"), rules) == \
        tuple(P(("data",), None, ("pod", "data"))) == ("data", None, ("pod", "data"))


def test_placements_map_a_spec_onto_the_mesh_dims():
    from torch.distributed.tensor import Replicate, Shard
    mesh = FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert sharding.placements((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert sharding.placements((None, "data"), mesh) == (Replicate(), Shard(1), Replicate())
    assert sharding.placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's axis order"):
        sharding.placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="two dims"):
        sharding.placements(("data", "data"), mesh)


def test_without_a_context_constrain_is_the_identity_and_there_is_one_group():
    x = torch.ones(4, 3)
    assert sharding.current_mesh() == (None, None)
    assert sharding.constrain(x, ("batch", None)) is x
    assert sharding.dispatch_groups() == 1
    mesh = FakeMesh({"pod": 2, "data": 4, "model": 8})
    rules = make_rules(get_config("olmoe-1b-7b"), mesh)
    with sharding.mesh_context(mesh, rules):
        assert sharding.dispatch_groups() == 8
        assert sharding.constrain(x, ("batch", None)) is x    # a plain tensor
    with sharding.mesh_context(mesh, dict(rules, moe_local_dispatch=False)):
        assert sharding.dispatch_groups() == 1
    assert sharding.current_mesh() == (None, None)


# ---------------------------------------------------------------- MoE groups

GROUPS = (2, 4)
MOE_ARCHS = ("olmoe-1b-7b", "llama4-scout-17b-a16e")
CAPACITY = (1.25, 0.5)
X_SHAPE = (4, 64)     # 64 tokens a group at G = 4: capacities 8-aligned still drop


def _group_inputs(arch, jm):
    params, x, act = _inputs(arch, jm)
    x = np.random.default_rng(9).standard_normal(X_SHAPE + x.shape[-1:]).astype(np.float32)
    return params, x, act


def _patched_groups(monkeypatch, G):
    monkeypatch.setattr(jsharding, "dispatch_groups", lambda: G)
    monkeypatch.setattr(tmoe, "dispatch_groups", lambda: G)


class _Routes:
    def __init__(self, monkeypatch):
        self.routes, route = [], tmoe.route

        def recording(*args):
            r = route(*args)
            self.routes.append(r)
            return r

        monkeypatch.setattr(tmoe, "route", recording)


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("capacity_factor", CAPACITY)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_groups_route_drop_and_output_as_jax(arch, capacity_factor, G, monkeypatch):
    jm, tm = _moe_cfg(arch, capacity_factor)
    params, x, act = _group_inputs(arch, jm)
    _patched_groups(monkeypatch, G)
    routes = _Routes(monkeypatch)
    want = np.asarray(jmoe.moe_ffn(jnp.asarray(x), jax.tree.map(jnp.asarray, params), jm, act))
    got = tmoe.moe_ffn(torch.from_numpy(x), _torch(params), tm, act).numpy()
    np.testing.assert_allclose(got, want, **LAYER_TOL)
    T = x.shape[0] * x.shape[1]
    Tg, C = T // G, jmoe.capacity_for(T // G, jm)
    assert len(routes.routes) == G
    dropped = 0
    for g, r in enumerate(routes.routes):
        w = jax_route(jnp.asarray(x.reshape(G, Tg, -1)[g]), jnp.asarray(params["router"]), jm, C)
        for key in ("gate_ids", "slot", "keep"):
            np.testing.assert_array_equal(getattr(r, key).numpy(), w[key], err_msg=f"{g} {key}")
        dropped += int((~w["keep"]).sum())
    if capacity_factor < 1:
        assert dropped > 0, "capacity factor 0.5 must drop pairs"


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_group_gradients_match_jax_grad(arch, G, monkeypatch):
    jm, tm = _moe_cfg(arch, 0.5)
    params, x, act = _group_inputs(arch, jm)
    _patched_groups(monkeypatch, G)
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def jloss(x, p):
        return jnp.sum(jnp.asarray(w) * jmoe.moe_ffn(x, p, jm, act))

    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jax.tree.map(jnp.asarray, params))
    tx = torch.from_numpy(x).requires_grad_()
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(), params)
    (torch.from_numpy(w) * tmoe.moe_ffn(tx, tp, tm, act)).sum().backward()
    got = {"x": tx.grad.numpy(), **{k: v.grad.numpy() for k, v in _flat(tp).items()}}
    want = {"x": np.asarray(jgx), **{k: np.asarray(v) for k, v in _flat(jgp).items()}}
    if tm.top_k == 1:          # p / p = 1: the router's gradient is rounding
        zero = 1e-4 * float(np.abs(want["x"]).max())
        assert np.abs(want.pop("router")).max() < zero
        assert np.abs(got.pop("router")).max() < zero
    for name, g in want.items():
        scale = float(np.abs(g).max())
        assert scale > 0, name
        np.testing.assert_allclose(got[name], g, rtol=0, atol=1e-4 * scale, err_msg=name)
