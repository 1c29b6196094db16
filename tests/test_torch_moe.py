"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe``, on the CPU.

Reduced olmoe-1b-7b (4 experts, top-2) and reduced llama4-scout (4 experts,
top-1, a shared expert) take parameters drawn by the JAX ``init_moe_params``
and inputs from a numpy seed. The routing (``gate_ids``, ``slot``,
``keep``) must equal JAX's exactly: it decides which pairs an expert's
capacity drops, and a pair routed elsewhere moves its token's output by a
share of an expert's output. The JAX function keeps its routing inside
``_dispatch_one_group``; :func:`jax_route` repeats those lines in jnp, and
:func:`test_jax_route_is_the_dispatch_of_the_jax_package` holds that
repetition to the JAX dispatch itself. The outputs are held to
``LAYER_TOL`` (float32, two libraries' summation orders), at the configs'
capacity factor 1.25 and at 0.5, where the capacity drops pairs; the
gradients to ``jax.grad`` within ``1e-4`` of each gradient's largest value.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.models import moe as tmoe

LAYER_TOL = dict(rtol=3e-5, atol=3e-5)
ARCHS = ("olmoe-1b-7b", "llama4-scout-17b-a16e")
CAPACITY = (1.25, 0.5)
T = 48            # tokens: (B, S) = (3, 16)


def _moe_cfg(arch, capacity_factor):
    jm = jax_get_config(arch).reduced().moe
    tm = get_config(arch).reduced().moe
    assert dataclasses.asdict(jm) == dataclasses.asdict(tm)
    return (dataclasses.replace(jm, capacity_factor=capacity_factor),
            dataclasses.replace(tm, capacity_factor=capacity_factor))


def _inputs(arch, jm, seed=0):
    """(numpy params of the JAX init, numpy x (3, 16, D), activation)."""
    cfg = jax_get_config(arch).reduced()
    params = jax.tree.map(np.asarray, jmoe.init_moe_params(jax.random.PRNGKey(seed),
                                                           cfg.d_model, jm, jnp.float32))
    x = np.random.default_rng(seed + 1).standard_normal((3, 16, cfg.d_model)).astype(np.float32)
    return params, x, cfg.activation


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def jax_route(xt, router, m, C):
    """The routing lines of the JAX package's ``_dispatch_one_group``
    (``src/repro/models/moe.py``), returning what they compute."""
    Tg = xt.shape[0]
    E, K = m.num_experts, m.top_k
    logits = jnp.einsum("td,de->te", xt.astype(jnp.float32), router.astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    gate_w, gate_ids = jax.lax.top_k(probs, K)
    gate_w = gate_w / jnp.maximum(gate_w.sum(-1, keepdims=True), 1e-9)
    flat_ids = gate_ids.reshape(-1)
    sort_idx = jnp.argsort(flat_ids)
    sorted_ids = flat_ids[sort_idx]
    counts = jnp.bincount(flat_ids, length=E)
    group_start = jnp.cumsum(counts) - counts
    pos_in_expert = jnp.arange(Tg * K) - group_start[sorted_ids]
    keep = pos_in_expert < C
    slot = sorted_ids * C + jnp.clip(pos_in_expert, 0, C - 1)
    slot = jnp.where(keep, slot, E * C)
    return {"gate_w": np.asarray(gate_w), "gate_ids": np.asarray(gate_ids),
            "token_of": np.asarray(sort_idx // K), "slot": np.asarray(slot),
            "keep": np.asarray(keep)}


def _assert_routes_equal(got: tmoe.Routing, want: dict):
    for name in ("gate_ids", "token_of", "slot", "keep"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), want[name], err_msg=name)
    np.testing.assert_allclose(got.gate_w.numpy(), want["gate_w"], **LAYER_TOL)


def test_capacity_for_matches_jax():
    for arch in ARCHS:
        jm, tm = jax_get_config(arch).moe, get_config(arch).moe
        for n in (1, 4, 7, 8, 48, 1000, 4096, 4097):
            for cf in CAPACITY:
                assert tmoe.capacity_for(n, dataclasses.replace(tm, capacity_factor=cf)) == \
                    jmoe.capacity_for(n, dataclasses.replace(jm, capacity_factor=cf))
    assert tmoe.capacity_for(4096, get_config("olmoe-1b-7b").moe) == 640


@pytest.mark.parametrize("capacity_factor", CAPACITY)
@pytest.mark.parametrize("arch", ARCHS)
def test_jax_route_is_the_dispatch_of_the_jax_package(arch, capacity_factor):
    """The repeated routing lines, fed to the JAX dispatch's own expert and
    combine lines, give ``_dispatch_one_group``'s output bit for bit."""
    jm, _ = _moe_cfg(arch, capacity_factor)
    params, x, act = _inputs(arch, jm)
    xt = jnp.asarray(x.reshape(T, -1))
    C = jmoe.capacity_for(T, jm)
    r = jax_route(xt, jnp.asarray(params["router"]), jm, C)
    E, D = jm.num_experts, xt.shape[1]
    w_sorted = r["gate_w"].reshape(-1)[np.argsort(r["gate_ids"].reshape(-1), kind="stable")]
    disp = jnp.zeros((E * C + 1, D)).at[r["slot"]].set(xt[r["token_of"]])
    expert_in = disp[: E * C].reshape(E, C, D)
    h = jmoe._activate(jnp.einsum("ecd,edf->ecf", expert_in, params["wg"]), act)
    h = h * jnp.einsum("ecd,edf->ecf", expert_in, params["wu"])
    out_e = jnp.einsum("ecf,efd->ecd", h, params["wd"])
    flat = jnp.concatenate([out_e.reshape(E * C, D), jnp.zeros((1, D))], 0)
    out = jnp.zeros((T, D)).at[r["token_of"]].add(flat[r["slot"]] * w_sorted[:, None])
    want = jmoe._dispatch_one_group(xt, jnp.asarray(params["router"]), jm, act,
                                    params["wg"], params["wu"], params["wd"], C)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(want))


@pytest.mark.parametrize("capacity_factor", CAPACITY)
@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax_exactly(arch, capacity_factor):
    jm, tm = _moe_cfg(arch, capacity_factor)
    params, x, _ = _inputs(arch, jm)
    C = jmoe.capacity_for(T, jm)
    want = jax_route(jnp.asarray(x.reshape(T, -1)), jnp.asarray(params["router"]), jm, C)
    got = tmoe.route(torch.from_numpy(x.reshape(T, -1)), torch.from_numpy(params["router"]),
                     tm, C)
    _assert_routes_equal(got, want)
    dropped = int((~got.keep).sum())
    assert dropped == int((~want["keep"]).sum())
    assert (got.slot.numpy()[~want["keep"]] == tm.num_experts * C).all()
    if capacity_factor < 1:
        assert dropped > 0, "capacity factor 0.5 must drop pairs"
        assert dropped > _dropped_at(arch, 1.25)
    assert len(np.unique(want["gate_ids"])) == tm.num_experts  # every expert takes tokens


def _dropped_at(arch, capacity_factor):
    jm, _ = _moe_cfg(arch, capacity_factor)
    params, x, _ = _inputs(arch, jm)
    r = jax_route(jnp.asarray(x.reshape(T, -1)), jnp.asarray(params["router"]), jm,
                  jmoe.capacity_for(T, jm))
    return int((~r["keep"]).sum())


@pytest.mark.parametrize("capacity_factor", CAPACITY)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch, capacity_factor):
    jm, tm = _moe_cfg(arch, capacity_factor)
    params, x, act = _inputs(arch, jm)
    want = np.asarray(jmoe.moe_ffn(jnp.asarray(x), jax.tree.map(jnp.asarray, params), jm, act))
    got = tmoe.moe_ffn(torch.from_numpy(x), _torch(params), tm, act).numpy()
    assert got.shape == want.shape == x.shape
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, **LAYER_TOL)
    if capacity_factor < 1 and not tm.shared_expert_ff:
        # a token whose every pair was dropped gets exactly zero, in both
        keep = jax_route(jnp.asarray(x.reshape(T, -1)), jnp.asarray(params["router"]), jm,
                         jmoe.capacity_for(T, jm))
        kept = np.zeros(T, bool)
        kept[keep["token_of"][keep["keep"]]] = True
        np.testing.assert_array_equal(got.reshape(T, -1)[~kept], 0.0)
        assert (~kept).any()


def _tied_inputs(E=4, K=2):
    """Router logits where experts tie: a zero router (every expert ties for
    every token), and a router whose columns 1 and 3 are equal and largest."""
    m = dataclasses.replace(get_config("olmoe-1b-7b").reduced().moe, num_experts=E, top_k=K)
    jm = dataclasses.replace(jax_get_config("olmoe-1b-7b").reduced().moe, num_experts=E,
                             top_k=K)
    rng = np.random.default_rng(3)
    x = np.abs(rng.standard_normal((8, 16))).astype(np.float32)
    twin = np.zeros((16, E), np.float32)
    twin[:, 1] = twin[:, 3] = 1.0
    return m, jm, x, [np.zeros((16, E), np.float32), twin]


def _assert_ties_go_like_jax(route_fn):
    m, jm, x, routers = _tied_inputs()
    for router in routers:
        C = jmoe.capacity_for(len(x), jm)
        want = jax_route(jnp.asarray(x), jnp.asarray(router), jm, C)
        got = route_fn(torch.from_numpy(x), torch.from_numpy(router), m, C)
        np.testing.assert_array_equal(got.gate_ids.numpy(), want["gate_ids"])
        _assert_routes_equal(got, want)


def test_ties_go_to_the_lower_expert_as_in_jax():
    m, jm, x, (zero, twin) = _tied_inputs()
    _assert_ties_go_like_jax(tmoe.route)
    assert (np.asarray(jax.lax.top_k(jnp.full((4,), 0.25), 2)[1]) == [0, 1]).all()
    assert (tmoe.top_k(torch.full((5, 4), 0.25), 2)[1] == torch.tensor([0, 1])).all()
    got = tmoe.route(torch.from_numpy(x), torch.from_numpy(twin), m, 8)
    assert (got.gate_ids[:, 0] == 1).all() and (got.gate_ids[:, 1] == 3).all()


def test_a_torch_topk_router_fails_the_tie_test(monkeypatch):
    """The tie test tells the two top-k rules apart: with ``torch.topk`` in
    place of the stable sort it fails (on a zero router this CPU build's
    ``torch.topk`` picks experts [2, 3], JAX [0, 1])."""
    monkeypatch.setattr(tmoe, "top_k", lambda p, k: tuple(torch.topk(p, k, dim=-1)))
    with pytest.raises(AssertionError):
        _assert_ties_go_like_jax(tmoe.route)


@pytest.mark.parametrize("capacity_factor", CAPACITY)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_gradients_match_jax_grad(arch, capacity_factor):
    """The gradient of ``sum(w * moe_ffn(x))`` with respect to ``x`` and every
    weight. The router gets its gradient through the gate weights alone (the
    top-k indices carry none), in both packages. At top-1 the renormalised
    gate weight is ``p / p = 1`` whatever the router, so its gradient is zero
    but for rounding, in both: there the router's gradient is held to that
    zero, within ``1e-4`` of the input gradient's largest value."""
    jm, tm = _moe_cfg(arch, capacity_factor)
    params, x, act = _inputs(arch, jm)
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def jloss(x, p):
        return jnp.sum(jnp.asarray(w) * jmoe.moe_ffn(x, p, jm, act))

    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jax.tree.map(jnp.asarray, params))
    tx = torch.from_numpy(x).requires_grad_()
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(), params)
    (torch.from_numpy(w) * tmoe.moe_ffn(tx, tp, tm, act)).sum().backward()
    got = {"x": tx.grad.numpy(), **{k: v.grad.numpy() for k, v in _flat(tp).items()}}
    want = {"x": np.asarray(jgx), **{k: np.asarray(v) for k, v in _flat(jgp).items()}}
    assert got.keys() == want.keys() >= {"x", "router", "wg", "wu", "wd"}
    if tm.top_k == 1:
        zero = 1e-4 * float(np.abs(want["x"]).max())
        assert np.abs(want.pop("router")).max() < zero
        assert np.abs(got.pop("router")).max() < zero
    for name, g in want.items():
        scale = float(np.abs(g).max())
        assert scale > 0, name
        np.testing.assert_allclose(got[name], g, rtol=0, atol=1e-4 * scale, err_msg=name)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_load_balance_loss_matches_jax(arch):
    jm, tm = _moe_cfg(arch, 1.25)
    params, x, _ = _inputs(arch, jm)
    want = float(jmoe.aux_load_balance_loss(jnp.asarray(x), jnp.asarray(params["router"]), jm))
    got = tmoe.aux_load_balance_loss(torch.from_numpy(x), torch.from_numpy(params["router"]), tm)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == pytest.approx(want, abs=1e-6)
    assert want > 0.5
    # on tied logits both count the experts top_k picks, the lower ones
    _, jm4, xt, (zero, _) = _tied_inputs()
    m4 = dataclasses.replace(tm, num_experts=4, top_k=2)
    want = float(jmoe.aux_load_balance_loss(jnp.asarray(xt[None]), jnp.asarray(zero), jm4))
    got = tmoe.aux_load_balance_loss(torch.from_numpy(xt[None]), torch.from_numpy(zero), m4)
    assert float(got) == pytest.approx(want, abs=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_params_has_the_jax_tree(arch):
    """Names, shapes and dtypes of the JAX tree, stacked along ``layers``;
    the router float32 under bfloat16 weights; JAX's scales."""
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = jax.eval_shape(jax.vmap(lambda k: jmoe.init_moe_params(
            k, jcfg.d_model, jcfg.moe, jdtype)), jax.ShapeDtypeStruct((3, 2), jnp.uint32))
        got = tmoe.init_moe_params(torch.Generator().manual_seed(0), cfg.d_model, cfg.moe,
                                   dtype, "cpu", 3)
        rows = {k: (tuple(v.shape), str(v.dtype).split(".")[1]) for k, v in _flat(got).items()}
        assert rows == {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(want).items()}
        assert got["router"].dtype == torch.float32
    big = tmoe.init_moe_params(torch.Generator().manual_seed(0), 256, cfg.moe, torch.float32,
                               "cpu", 1)
    assert float(big["router"].std()) == pytest.approx(256 ** -0.5, rel=0.1)
    assert float(big["wd"].std()) == pytest.approx(cfg.moe.d_ff_expert ** -0.5, rel=0.05)
