"""The port's training path against the JAX package's, on the CPU.

The optimizer on a random tree, then a reduced granite-3-2b with
``num_kv_heads=2`` (GQA groups of 2) whose JAX train state is made numpy
and handed to both packages with every norm weight of the parameters and of
the float32 master copy set to ``1 + 0.1 N(0, 1)`` from a numpy seed: on
the JAX init's zero norms every gradient but ``final_norm``'s is exactly 0
(ROADMAP.md, faults of the reference), and a comparison on such weights
would check no product and no attention backward. Each test asserts that
what it compares is not degenerate.

Tolerances (float32, the two frameworks' summation orders):
- the schedule and the norm: ``rtol 1e-6``;
- the loss ``rtol 1e-5``; each gradient leaf ``1e-4 x max |JAX leaf|``
  (the forward's ~1e-6 differences carried back through 4 layers; a wrong
  backward is off by the leaf's own size);
- after 3 AdamW steps, ``m`` and ``v`` within ``1e-3`` relative to each
  leaf's largest value, and every parameter within the summed learning
  rates: where a gradient is ~0, ``mhat / sqrt(vhat)`` is its sign, which
  two right implementations may take apart, so an element may move by up
  to 2 lr one way or the other in a step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config
from repro.models import loss_fn as jax_loss_fn
from repro.models import param_shapes as jax_param_shapes
from repro.training import OptimizerConfig as JaxOptimizerConfig
from repro.training import TrainConfig as JaxTrainConfig
from repro.training import adamw_update as jax_adamw_update
from repro.training import global_norm as jax_global_norm
from repro.training import init_opt_state as jax_init_opt_state
from repro.training import init_train_state as jax_init_train_state
from repro.training import lr_at as jax_lr_at
from repro.training import make_train_step as jax_make_train_step
from repro.training import train_state_shapes as jax_train_state_shapes
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import shift_labels
from repro_torch.kernels import attention as tattn
from repro_torch.models import (FAMILIES, forward, init_params, loss_fn, param_shapes,
                                params_from_numpy, params_to_numpy, transformer)
from repro_torch.training import (OptimizerConfig, TrainConfig, adamw_update,
                                  global_norm, init_opt_state, init_train_state, lr_at,
                                  make_train_step, train_state_shapes)
from repro_torch.training.tree import flatten_with_paths

OPT = dict(learning_rate=1e-3, warmup_steps=1, decay_steps=10)
STEPS = 3


def _cfgs():
    jcfg = dataclasses.replace(jax_get_config("granite-3-2b").reduced(), num_kv_heads=2)
    tcfg = dataclasses.replace(get_config("granite-3-2b").reduced(), num_kv_heads=2)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _perturb_norms(params, rng):
    for tree, key in ((params["layers"], "ln1"), (params["layers"], "ln2"),
                      (params, "final_norm")):
        tree[key] = (1.0 + 0.1 * rng.standard_normal(tree[key].shape)).astype(np.float32)


def numpy_state(jcfg, seed=7):
    """JAX's train state at ``jcfg``, numpy leaves, perturbed norms in the
    parameters and in the master copy alike."""
    jtcfg = JaxTrainConfig(optimizer=JaxOptimizerConfig(**OPT), remat="none")
    tree = jax.tree.map(np.asarray, jax_init_train_state(jcfg, jtcfg, jax.random.PRNGKey(0)))
    _perturb_norms(tree["params"], np.random.default_rng(seed))
    tree["opt"]["master"] = jax.tree.map(np.copy, tree["params"])
    return tree


def numpy_batches(cfg, n, shape=(4, 16), seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        out.append({"tokens": toks, "labels": shift_labels(toks)})
    return out


def _paths(tree):
    return {name: np.asarray(leaf) for name, leaf in flatten_with_paths(tree)}


def assert_leaves_close(got, want, rel):
    """Every leaf of ``got`` within ``rel x max |leaf of want|``; ``want``
    not all zero."""
    got, want = _paths(got), _paths(want)
    assert got.keys() == want.keys()
    for name, w in want.items():
        scale = float(np.abs(w).max())
        assert scale > 0, f"{name} is all zero: the comparison would be degenerate"
        np.testing.assert_allclose(got[name], w, rtol=0, atol=rel * scale, err_msg=name)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    return jcfg, tcfg, numpy_state(jcfg)


# ---------------------------------------------------------------- optimizer

@pytest.mark.parametrize("opt", [OPT, dict(learning_rate=3e-4, warmup_steps=20, decay_steps=100),
                                 dict(learning_rate=1e-3, warmup_steps=0, decay_steps=50,
                                      min_lr_ratio=0.3)])
def test_lr_at_matches_jax(opt):
    jcfg, tcfg = JaxOptimizerConfig(**opt), OptimizerConfig(**opt)
    for step in (0, 1, 5, 19, 20, 21, 55, 99, 100, 1000):
        want = float(jax_lr_at(jcfg, jnp.int32(step)))
        got = lr_at(tcfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12)
    assert float(lr_at(tcfg, 0)) == float(jax_lr_at(jcfg, jnp.int32(0)))


def _random_tree(rng):
    return {"a": rng.standard_normal((7, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(13).astype(np.float32) * 1e-3,
                  "d": rng.standard_normal((2, 3, 4)).astype(np.float32) * 10}}


def test_global_norm_matches_jax():
    tree = _random_tree(np.random.default_rng(0))
    want = float(jax_global_norm(jax.tree.map(jnp.asarray, tree)))
    got = global_norm(params_from_numpy(tree, "cpu"))
    assert float(got) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("master_fp32", [True, False])
@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_matches_jax_on_a_random_tree(master_fp32, clip):
    rng = np.random.default_rng(1)
    opt = dict(OPT, grad_clip_norm=clip, master_fp32=master_fp32)
    jcfg, tcfg = JaxOptimizerConfig(**opt), OptimizerConfig(**opt)
    params = _random_tree(rng)
    jp = jax.tree.map(jnp.asarray, params)
    js = jax_init_opt_state(jcfg, jp)
    tp = params_from_numpy(params, "cpu")
    ts = init_opt_state(tcfg, tp)
    assert set(ts) == set(js)
    lrs = 0.0
    for step in range(4):
        grads = _random_tree(rng)
        jp, js, jm = jax_adamw_update(jcfg, jax.tree.map(jnp.asarray, grads), js, jp,
                                      jnp.int32(step))
        tp2, ts2, tm = adamw_update(tcfg, params_from_numpy(grads, "cpu"), ts, tp,
                                    torch.tensor(step, dtype=torch.int32))
        assert tp2 is tp and ts2 is ts  # updated in place
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        lrs += float(jm["lr"])
    assert lrs > 0
    for key in ("m", "v"):
        assert_leaves_close(params_to_numpy(ts[key]), jax.tree.map(np.asarray, js[key]), 1e-3)
    got, want = _paths(params_to_numpy(tp)), _paths(jax.tree.map(np.asarray, jp))
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=lrs, err_msg=name)
        assert not np.array_equal(w, _paths(params)[name])  # the steps moved it
    if master_fp32:
        np.testing.assert_array_equal(_paths(params_to_numpy(ts["master"]))["a"], got["a"])


def test_adamw_keeps_a_bfloat16_parameter_with_its_float32_master():
    cfg = OptimizerConfig(**OPT)
    params = {"w": torch.tensor([0.5, -0.25, 2.0], dtype=torch.bfloat16)}
    state = init_opt_state(cfg, params)
    assert state["master"]["w"].dtype == torch.float32
    for step in range(3):
        adamw_update(cfg, {"w": torch.ones(3, dtype=torch.bfloat16)}, state, params, step)
    assert params["w"].dtype == torch.bfloat16
    assert torch.equal(params["w"], state["master"]["w"].to(torch.bfloat16))
    assert (state["master"]["w"] < torch.tensor([0.5, -0.25, 2.0])).all()


# ---------------------------------------------------------------- shapes

def test_param_and_state_shapes_match_jax_on_the_meta_device():
    jcfg, tcfg = jax_get_config("granite-3-2b"), get_config("granite-3-2b")
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        got = param_shapes(tcfg, dtype)
        want = jax_param_shapes(jcfg, jdtype)
        got_rows = [(n, tuple(t.shape), str(t.dtype).split(".")[1], t.device.type)
                    for n, t in flatten_with_paths(got)]
        want_rows = [(jax.tree_util.keystr(p, simple=True, separator="/"), tuple(s.shape),
                      str(s.dtype), "meta")
                     for p, s in jax.tree_util.tree_flatten_with_path(want)[0]]
        assert got_rows == want_rows
    got = train_state_shapes(tcfg, TrainConfig())
    want = jax_train_state_shapes(jcfg, JaxTrainConfig())
    assert [(n, tuple(t.shape), str(t.dtype).split(".")[1]) for n, t in flatten_with_paths(got)] == \
        [(jax.tree_util.keystr(p, simple=True, separator="/"), tuple(s.shape), str(s.dtype))
         for p, s in jax.tree_util.tree_flatten_with_path(want)[0]]


def test_train_state_numpy_round_trip(model):
    _, _, tree = model
    state = params_from_numpy(tree, "cpu")
    assert state["step"].dtype == torch.int32 and state["step"].dim() == 0
    assert set(state["opt"]) == {"m", "v", "master"}
    back = params_to_numpy(state)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- loss

def _jax_loss_and_grads(jcfg, params, batch, remat="none"):
    return jax.value_and_grad(lambda p: jax_loss_fn(jcfg, p, batch, remat=remat))(
        jax.tree.map(jnp.asarray, params))


def _with_grad(params):
    """(leaf name -> a copy requiring grad, the tree of those copies)."""
    leaves = {n: p.clone().requires_grad_() for n, p in flatten_with_paths(params)}
    tree = {}
    for name, leaf in leaves.items():
        node = tree
        *keys, last = name.split("/")
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = leaf
    return leaves, tree


def _loss_and_grads(tcfg, params, batch, remat):
    leaves, tree = _with_grad(params)
    loss = loss_fn(tcfg, tree, {k: torch.from_numpy(v) for k, v in batch.items()}, remat=remat)
    loss.backward()
    return loss.detach(), {n: t.grad.numpy() for n, t in leaves.items()}


def test_loss_fn_and_gradients_match_jax(model):
    jcfg, tcfg, tree = model
    batch = numpy_batches(jcfg, 1)[0]
    batch["labels"][0, :5] = -1  # masked positions besides the last
    jloss, jgrads = _jax_loss_and_grads(jcfg, tree["params"],
                                        jax.tree.map(jnp.asarray, batch))
    loss, grads = _loss_and_grads(tcfg, params_from_numpy(tree["params"], "cpu"), batch, "none")
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(jloss) > 1.0
    assert_leaves_close(grads, jax.tree.map(np.asarray, jgrads), 1e-4)
    # the mask counts: a loss over every position is another number
    unmasked = dict(batch, labels=np.maximum(batch["labels"], 0))
    assert float(jax_loss_fn(jcfg, jax.tree.map(jnp.asarray, tree["params"]),
                             jax.tree.map(jnp.asarray, unmasked))) != pytest.approx(float(jloss))


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_values_of_none(model, remat):
    _, tcfg, tree = model
    batch = numpy_batches(tcfg, 1, seed=3)[0]
    params = params_from_numpy(tree["params"], "cpu")
    want_loss, want = _loss_and_grads(tcfg, params, batch, "none")
    launches = tattn.flash_attention.launches
    loss, got = _loss_and_grads(tcfg, params, batch, remat)
    assert tattn.flash_attention.launches == launches  # CPU tensors: the plain version
    assert float(loss) == float(want_loss)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6, atol=1e-7, err_msg=name)


class _CountProducts(TorchDispatchMode):
    """Counts the matrix products without batch dimensions that run."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default or (
                func is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _remat_costs(tcfg, params, batch, remat):
    """(bytes autograd keeps from the forward through saved-tensor hooks,
    products without batch dimensions run in the backward)."""
    kept = {}

    def pack(t):
        kept.setdefault(t.untyped_storage().data_ptr(), t.untyped_storage().nbytes())
        return t

    _, tree = _with_grad(params)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        logits = forward(tcfg, tree, {"tokens": torch.from_numpy(batch["tokens"])},
                         remat=remat)
    with _CountProducts() as count:
        logits.square().mean().backward()
    return sum(kept.values()), count.n


def test_remat_policies_keep_and_recompute_what_jax_names(model):
    """``none`` keeps every layer's activations and recomputes nothing;
    ``full`` keeps each layer's input and recomputes the layer, its products
    too; ``dots`` keeps the outputs of the products without batch dimensions
    (JAX's ``checkpoint_dots_with_no_batch_dims``, held apart from the hooks)
    and recomputes the rest, no such product."""
    _, tcfg, tree = model
    batch = numpy_batches(tcfg, 1, shape=(4, 64), seed=5)[0]
    params = params_from_numpy(tree["params"], "cpu")
    (none_kept, none_mm), (full_kept, full_mm), (dots_kept, dots_mm) = (
        _remat_costs(tcfg, params, batch, r) for r in ("none", "full", "dots"))
    assert full_kept < none_kept / 4 and dots_kept < none_kept / 4
    # q, k, v, wo, gate and up; the recompute stops once it holds what the
    # backward needs, before the down product
    per_layer = 6
    assert full_mm == none_mm + per_layer * tcfg.num_layers
    assert dots_mm == none_mm


def test_unbind_layers_gives_every_layer_as_views(model):
    _, tcfg, tree = model
    layers = params_from_numpy(tree["params"], "cpu")["layers"]
    per_layer = transformer.unbind_layers(layers)
    assert len(per_layer) == tcfg.num_layers
    for li, lp in enumerate(per_layer):
        want = transformer.layer_params(layers, li)
        for (n, a), (m, b) in zip(flatten_with_paths(lp), flatten_with_paths(want)):
            assert n == m and torch.equal(a, b)
            assert a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def test_stacked_leaves_get_one_gradient_each(model):
    """The backward of the per-layer split is one ``unbind`` per stacked
    leaf (its backward one ``stack``), not a select per layer (whose
    backward adds a zero-filled leaf-sized gradient for each layer)."""
    _, tcfg, tree = model
    leaves, tree = _with_grad(params_from_numpy(tree["params"], "cpu"))
    batch = numpy_batches(tcfg, 1)[0]
    loss = loss_fn(tcfg, tree, {k: torch.from_numpy(v) for k, v in batch.items()},
                   remat="none")
    stacked = {id(t): n for n, t in leaves.items() if n.startswith("layers/")}
    feeds = {}  # stacked leaf -> the kinds of node that take its gradient
    seen, todo = set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            var = getattr(nxt, "variable", None)
            if var is not None and id(var) in stacked:
                feeds.setdefault(stacked[id(var)], []).append(type(node).__name__)
            todo.append(nxt)
    assert feeds == {n: ["UnbindBackward0"] for n in stacked.values()}


def test_families_cover_every_config_and_whisper_trains():
    """The port's model API takes the family of every config (the audio
    family was the last to land, ROADMAP item 8f), and the reduced
    whisper-small runs ``forward`` and ``loss_fn`` through it, with a
    gradient in every parameter."""
    assert {get_config(arch).family for arch in ARCH_IDS} <= set(FAMILIES)
    cfg = get_config("whisper-small").reduced()
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 6), generator=g)
    batch = {"frames": torch.randn(2, cfg.encdec.encoder_seq, cfg.d_model, generator=g),
             "tokens": tokens, "labels": torch.from_numpy(shift_labels(tokens.numpy()))}
    leaves, params = _with_grad(init_params(cfg, torch.Generator().manual_seed(0),
                                            device="cpu"))
    logits = forward(cfg, params, batch, remat="none")
    assert logits.shape == (2, 6, cfg.padded_vocab) and torch.isfinite(logits).all()
    loss = loss_fn(cfg, params, batch)
    loss.backward()
    assert float(loss.detach()) > 1.0
    for name, leaf in leaves.items():
        assert leaf.grad is not None and torch.isfinite(leaf.grad).all(), name
        assert leaf.grad.abs().max() > 0, name


# ---------------------------------------------------------------- train step

def run_jax_steps(jcfg, tree, batches, remat, microbatches):
    step = jax.jit(jax_make_train_step(jcfg, JaxTrainConfig(
        optimizer=JaxOptimizerConfig(**OPT), remat=remat, microbatches=microbatches)))
    state, metrics = jax.tree.map(jnp.asarray, tree), []
    for b in batches:
        state, m = step(state, jax.tree.map(jnp.asarray, b))
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree.map(np.asarray, state), metrics


def run_port_steps(tcfg, tree, batches, remat, microbatches):
    step = make_train_step(tcfg, TrainConfig(optimizer=OptimizerConfig(**OPT), remat=remat,
                                             microbatches=microbatches))
    state, metrics = params_from_numpy(tree, "cpu"), []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return params_to_numpy(state), metrics


def assert_states_close(got, want, lrs):
    assert int(got["step"]) == int(want["step"])
    for key in ("m", "v"):
        assert_leaves_close(got["opt"][key], want["opt"][key], 1e-3)
    for key in ("params", ):
        g, w = _paths(got[key]), _paths(want[key])
        for name in w:
            np.testing.assert_allclose(g[name], w[name], rtol=0, atol=lrs, err_msg=name)
    np.testing.assert_array_equal(_paths(got["opt"]["master"])["embed"], _paths(got["params"])["embed"])


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_jax(model, remat, microbatches):
    jcfg, tcfg, tree = model
    batches = numpy_batches(jcfg, STEPS)
    want_state, want = run_jax_steps(jcfg, tree, batches, remat, microbatches)
    got_state, got = run_port_steps(tcfg, tree, batches, remat, microbatches)
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"loss", "grad_norm", "lr", "tokens"}
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-4)
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6)
        assert g["tokens"] == w["tokens"] == 64
    lrs = sum(m["lr"] for m in want)
    assert lrs > 0 and want[-1]["loss"] < want[0]["loss"]
    assert_states_close(got_state, want_state, lrs)


def test_microbatches_split_the_batch_in_order(model):
    """Two microbatches give the one-batch step's loss and state (mean loss
    is linear in the batch's halves), as in tests/test_training.py."""
    _, tcfg, tree = model
    batches = numpy_batches(tcfg, 2)
    one, m1 = run_port_steps(tcfg, tree, batches, "none", 1)
    two, m2 = run_port_steps(tcfg, tree, batches, "none", 2)
    for a, b in zip(m1, m2):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
    assert_states_close(two, one, sum(m["lr"] for m in m1))
    with pytest.raises(ValueError, match="not divisible"):
        run_port_steps(tcfg, tree, numpy_batches(tcfg, 1, shape=(3, 16)), "none", 2)


def test_init_train_state_from_a_generator():
    cfg = get_config("granite-3-2b").reduced()
    tcfg = TrainConfig()
    a = init_train_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu")
    b = init_train_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = train_state_shapes(cfg, tcfg)
    for (n, x), (_, y), (_, s) in zip(flatten_with_paths(a), flatten_with_paths(b),
                                      flatten_with_paths(shapes)):
        assert torch.equal(x, y) and x.shape == s.shape and x.dtype == s.dtype, n
    assert int(a["step"]) == 0 and a["step"].dtype == torch.int32
    assert torch.equal(a["opt"]["master"]["embed"], a["params"]["embed"])
    assert a["opt"]["master"]["embed"].data_ptr() != a["params"]["embed"].data_ptr()
    assert not a["opt"]["m"]["embed"].any()
