"""The port's int8 error-feedback gradient compression against the JAX
package's, on the CPU.

``quantize_int8`` and ``compress_decompress`` run the same float32
operations in the same order in both packages (``torch.round`` and
``jnp.round`` both round half to even), so ``q``, ``scale``, the
dequantized gradient and the new error feedback must be equal bit for bit,
on exact .5 ties and an all-zero leaf too. The train step with
``compress_dp_grads=True`` is held to JAX's ``make_train_step`` over 3 steps
with the tolerances ``tests/test_torch_train.py`` states for the
uncompressed step (loss ``rtol 1e-5``, gradient norm ``1e-4``, parameters
within the summed learning rates, gradients ``1e-4`` of the leaf's largest
value, moments ``1e-3``). One thing is new: where the two frameworks'
gradients (~1e-6 apart) straddle a rounding boundary of the int8 grid,
``q`` differs by one, and so the residual by one int8 step
(``max |g + ef| / 127``) and the moments by that step's share. Measured: at
most 3 such elements in a leaf of 8192 to 32768, in 3 of 11 leaves. So
``ef``, ``m`` and ``v`` are held to those tolerances on all but 1 % of
each leaf, and each flipped residual to one step
(:func:`assert_compressed_states_close`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import CheckpointManager as JaxCheckpointManager
from repro.training import OptimizerConfig as JaxOptimizerConfig
from repro.training import TrainConfig as JaxTrainConfig
from repro.training import compress_decompress as jax_compress_decompress
from repro.training import compression_wire_bytes as jax_compression_wire_bytes
from repro.training import dequantize_int8 as jax_dequantize_int8
from repro.training import init_error_feedback as jax_init_error_feedback
from repro.training import init_train_state as jax_init_train_state
from repro.training import make_train_step as jax_make_train_step
from repro.training import quantize_int8 as jax_quantize_int8
from repro.training import train_state_shapes as jax_train_state_shapes
from repro_torch.configs import get_config
from repro_torch.models import params_from_numpy, params_to_numpy
from repro_torch.training import (CheckpointManager, OptimizerConfig, TrainConfig,
                                  compress_decompress, compressed_psum_pod,
                                  compression_wire_bytes, dequantize_int8,
                                  init_error_feedback, init_train_state, make_train_step,
                                  quantize_int8, train_state_shapes)
from repro_torch.training.compression import compress_decompress_
from repro_torch.training.tree import flatten_with_paths, tree_leaves

from test_torch_train import OPT, STEPS, _cfgs, _paths, numpy_batches, numpy_state


def _leaves():
    """(name, gradient, error feedback) as float32 numpy arrays."""
    rng = np.random.default_rng(0)
    ties = np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, -126.5, 126.5, 3.5],
                    np.float32) * np.float32(2.0 ** -10)
    big = rng.standard_normal((64, 257)).astype(np.float32)
    return [
        ("normal", big, np.zeros_like(big)),
        ("normal+ef", big, (rng.standard_normal(big.shape) * 1e-2).astype(np.float32)),
        ("ties", ties, np.zeros_like(ties)),
        ("zeros", np.zeros((5, 7), np.float32), np.zeros((5, 7), np.float32)),
        ("tiny", (rng.standard_normal(300) * 1e-14).astype(np.float32), np.zeros(300, np.float32)),
        ("skewed", np.concatenate([rng.standard_normal(999) * 1e-3, [50.0]]).astype(np.float32),
         (rng.standard_normal(1000) * 1e-4).astype(np.float32)),
    ]


def _bits_equal(got, want, name):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    np.testing.assert_array_equal(got.reshape(-1).view(np.uint8), want.reshape(-1).view(np.uint8),
                                  err_msg=name)


@pytest.mark.parametrize("name, g, ef", _leaves(), ids=[n for n, _, _ in _leaves()])
def test_quantize_and_compress_match_jax_bit_for_bit(name, g, ef):
    jq, js = jax_quantize_int8(jnp.asarray(g))
    q, s = quantize_int8(torch.from_numpy(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.dim() == 0
    _bits_equal(q, jq, f"{name} q")
    _bits_equal(s, js, f"{name} scale")
    _bits_equal(dequantize_int8(q, s), jax_dequantize_int8(jq, js), f"{name} deq")
    jdeq, jef = jax_compress_decompress(jnp.asarray(g), jnp.asarray(ef))
    deq, new_ef = compress_decompress(torch.from_numpy(g), torch.from_numpy(ef))
    _bits_equal(deq, jdeq, f"{name} compress deq")
    _bits_equal(new_ef, jef, f"{name} compress ef")
    # in place: the gradient's storage becomes deq, ef's the new error feedback
    tg, tef = torch.from_numpy(g.copy()), torch.from_numpy(ef.copy())
    out = compress_decompress_(tg, tef)
    assert out.data_ptr() == tg.data_ptr()
    _bits_equal(out, jdeq, f"{name} in place deq")
    _bits_equal(tef, jef, f"{name} in place ef")
    if name == "ties":
        assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, -126, 126, 4]  # half to even
    if name == "zeros":
        assert not q.any() and float(s) == np.float32(1e-12) / np.float32(127.0)


def test_compress_in_place_widens_a_bfloat16_gradient():
    g = torch.tensor([0.5, -0.25, 2.0, 3.0], dtype=torch.bfloat16)
    ef = torch.tensor([0.01, 0.0, -0.02, 0.5], dtype=torch.float32)
    want_deq, want_ef = jax_compress_decompress(
        jnp.asarray(g.float().numpy()).astype(jnp.bfloat16), jnp.asarray(ef.numpy()))
    out = compress_decompress_(g, ef)
    assert out.dtype == torch.float32 and g.dtype == torch.bfloat16
    _bits_equal(out, want_deq, "deq")
    _bits_equal(ef, want_ef, "ef")


def test_error_feedback_and_wire_bytes_match_jax():
    jcfg, tcfg = _cfgs()
    tree = numpy_state(jcfg)["params"]
    jef = jax_init_error_feedback(jax.tree.map(jnp.asarray, tree))
    params = params_from_numpy(tree, "cpu")
    ef = init_error_feedback(params)
    got, want = dict(flatten_with_paths(ef)), _paths(jax.tree.map(np.asarray, jef))
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert got[name].dtype == torch.float32 and tuple(got[name].shape) == w.shape
        assert not got[name].any() and got[name].device == params["embed"].device
    assert compression_wire_bytes(params) == \
        jax_compression_wire_bytes(jax.tree.map(jnp.asarray, tree))
    assert compression_wire_bytes(ef) == compression_wire_bytes(params)


@pytest.fixture
def one_pod():
    """A one-rank gloo group and its (1,) ``pod`` mesh, torn down after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_mesh((1,), ("pod",))
    finally:
        dist.destroy_process_group()


def test_compressed_psum_pod_at_one_pod_is_compress_decompress(one_pod):
    """One pod: the all-reduced payload is the pod's own ``q``, the mean
    scale its own scale, so the pod mean is ``compress_decompress``'s
    dequantized gradient and the error feedback its new one, bit for bit,
    and both JAX's (the cross-pod form at two pods: test_torch_mesh.py)."""
    names = [n for n, _, _ in _leaves()]
    grads = {n: torch.from_numpy(g) for n, g, _ in _leaves()}
    ef = {n: torch.from_numpy(e) for n, _, e in _leaves()}
    mean, new_ef = compressed_psum_pod(grads, ef, one_pod)
    assert sorted(mean) == sorted(new_ef) == sorted(names)
    for n, g, e in _leaves():
        want_deq, want_ef = jax_compress_decompress(jnp.asarray(g), jnp.asarray(e))
        _bits_equal(mean[n], want_deq, f"{n} mean")
        _bits_equal(new_ef[n], want_ef, f"{n} ef")
        deq, ef2 = compress_decompress(torch.from_numpy(g), torch.from_numpy(e))
        assert torch.equal(mean[n], deq) and torch.equal(new_ef[n], ef2)
    assert torch.equal(ef["normal+ef"], torch.from_numpy(_leaves()[1][2]))  # not in place


def test_compressed_psum_pod_payload_is_the_int8_values_at_one_pod(one_pod):
    from repro_torch.training.compression import pod_reduce_leaf
    for n, g, e in _leaves():
        target = torch.from_numpy(g) + torch.from_numpy(e)
        q, _ = quantize_int8(target)
        _, _, acc = pod_reduce_leaf(torch.from_numpy(g), torch.from_numpy(e),
                                    one_pod.get_group("pod"), 1)
        assert acc.dtype == torch.int32
        assert torch.equal(acc, q.to(torch.int32)), n


def test_compressed_psum_pod_keeps_dtensor_leaves_placed(one_pod):
    """A DTensor leaf is reduced by its local shard and comes back a
    DTensor placed as it was."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
    n, g, e = _leaves()[1]
    dg = distribute_tensor(torch.from_numpy(g), one_pod, [Replicate()])
    de = distribute_tensor(torch.from_numpy(e), one_pod, [Replicate()])
    mean, new_ef = compressed_psum_pod({n: dg}, {n: de}, one_pod)
    assert isinstance(mean[n], DTensor) and tuple(mean[n].placements) == (Replicate(),)
    deq, ef2 = compress_decompress(torch.from_numpy(g), torch.from_numpy(e))
    assert torch.equal(mean[n].to_local(), deq) and torch.equal(new_ef[n].to_local(), ef2)


# ---------------------------------------------------------------- train step

def test_compressed_train_state_shapes_match_jax():
    jcfg, tcfg = get_config("granite-3-2b"), get_config("granite-3-2b")
    want = jax_train_state_shapes(jcfg, JaxTrainConfig(compress_dp_grads=True))
    got = train_state_shapes(tcfg, TrainConfig(compress_dp_grads=True))
    rows = [(n, tuple(t.shape), str(t.dtype).split(".")[1]) for n, t in flatten_with_paths(got)]
    assert rows == [(jax.tree_util.keystr(p, simple=True, separator="/"), tuple(s.shape),
                     str(s.dtype)) for p, s in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert sum(1 for n, _, _ in rows if n.startswith("ef/")) == \
        sum(1 for n, _, _ in rows if n.startswith("params/")) > 0
    assert all(t.device.type == "meta" for t in tree_leaves(got["ef"]))


def test_init_train_state_adds_error_feedback():
    cfg = get_config("granite-3-2b").reduced()
    state = init_train_state(cfg, TrainConfig(compress_dp_grads=True),
                             torch.Generator().manual_seed(0), "cpu")
    assert "ef" not in init_train_state(cfg, TrainConfig(), torch.Generator(), "cpu")
    assert set(state["ef"]) == set(state["params"])
    for (n, e), (_, p) in zip(flatten_with_paths(state["ef"]),
                              flatten_with_paths(state["params"])):
        assert e.shape == p.shape and e.dtype == torch.float32 and not e.any(), n


def _compressed_state(jcfg):
    tree = numpy_state(jcfg)
    tree["ef"] = jax.tree.map(np.zeros_like, tree["params"])
    return tree


def _jax_steps(jcfg, tree, batches, microbatches):
    step = jax.jit(jax_make_train_step(jcfg, JaxTrainConfig(
        optimizer=JaxOptimizerConfig(**OPT), remat="none", microbatches=microbatches,
        compress_dp_grads=True)))
    state, metrics = jax.tree.map(jnp.asarray, tree), []
    for b in batches:
        state, m = step(state, jax.tree.map(jnp.asarray, b))
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree.map(np.asarray, state), metrics


def _port_steps(tcfg, tree, batches, microbatches, compress=True):
    step = make_train_step(tcfg, TrainConfig(optimizer=OptimizerConfig(**OPT), remat="none",
                                             microbatches=microbatches,
                                             compress_dp_grads=compress))
    state, metrics = params_from_numpy(tree, "cpu"), []
    ef_ptrs = [e.data_ptr() for e in tree_leaves(state.get("ef", {}))]
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    if ef_ptrs:
        assert [e.data_ptr() for e in tree_leaves(state["ef"])] == ef_ptrs  # in place
    return params_to_numpy(state), metrics


def _flip_share(got, want, tol):
    """Per leaf, the share of elements off by more than ``tol(leaf of want)``."""
    got, want = _paths(got), _paths(want)
    assert got.keys() == want.keys()
    out = {}
    for name, w in want.items():
        assert np.abs(w).max() > 0, f"{name} is all zero: the comparison would be degenerate"
        out[name] = np.abs(got[name] - w) > tol(w)
    return out


def assert_compressed_states_close(got, want, lrs):
    """Parameters within the summed learning rates, as uncompressed. A
    residual lies within half an int8 step of zero, so ``step = 2 max |ef|``
    of JAX's leaf is the leaf's last step. Every element of ``ef`` within
    ``1e-4 x 127 step`` (the gradient tolerance on the quantized target) of
    JAX's, but for rounding flips: at most 1 % of a leaf, each within 1.1
    steps. ``m`` and ``v`` within ``1e-3`` of each leaf's largest value but
    for at most 1 % of a leaf (the elements a flip moved)."""
    assert int(got["step"]) == int(want["step"])
    g, w = _paths(got["params"]), _paths(want["params"])
    for name in w:
        np.testing.assert_allclose(g[name], w[name], rtol=0, atol=lrs, err_msg=name)
    flips = _flip_share(got["ef"], want["ef"], lambda x: 1e-4 * 127 * 2 * np.abs(x).max())
    gef, wef = _paths(got["ef"]), _paths(want["ef"])
    for name, flip in flips.items():
        assert flip.mean() <= 0.01, name
        assert np.abs(gef[name] - wef[name]).max() <= 1.1 * 2 * np.abs(wef[name]).max(), name
    for key in ("m", "v"):
        off = _flip_share(got["opt"][key], want["opt"][key], lambda x: 1e-3 * np.abs(x).max())
        assert all(o.mean() <= 0.01 for o in off.values()), key
    np.testing.assert_array_equal(_paths(got["opt"]["master"])["embed"], g["embed"])


@pytest.mark.parametrize("microbatches", [1, 2])
def test_compressed_train_steps_match_jax(microbatches):
    jcfg, tcfg = _cfgs()
    tree = _compressed_state(jcfg)
    batches = numpy_batches(jcfg, STEPS)
    want_state, want = _jax_steps(jcfg, tree, batches, microbatches)
    got_state, got = _port_steps(tcfg, tree, batches, microbatches)
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"loss", "grad_norm", "lr", "tokens"}
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-4)
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6)
    lrs = sum(m["lr"] for m in want)
    assert lrs > 0 and want[-1]["loss"] < want[0]["loss"]
    assert_compressed_states_close(got_state, want_state, lrs)
    # compression changed the step: the uncompressed one gives other parameters
    plain, _ = _port_steps(tcfg, numpy_state(jcfg), batches, microbatches, compress=False)
    assert not np.array_equal(_paths(plain["params"])["embed"],
                              _paths(got_state["params"])["embed"])


# ---------------------------------------------------------------- checkpoint

@pytest.fixture(scope="module")
def ef_state():
    jcfg, _ = _cfgs()
    tree = _compressed_state(jcfg)
    rng = np.random.default_rng(9)
    tree["ef"] = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 1e-3).astype(np.float32),
                              tree["ef"])
    tree["step"] = np.asarray(2, np.int32)
    return tree


def _assert_trees_equal(got, want):
    got, want = _paths(got), _paths(want)
    assert got.keys() == want.keys()
    assert any(n.startswith("ef/") for n in want)
    for name, w in want.items():
        _bits_equal(got[name], w, name)


def test_checkpoint_with_error_feedback_restores_in_both_directions(tmp_path, ef_state):
    _, tcfg = _cfgs()
    like = params_from_numpy(ef_state, "cpu")
    CheckpointManager(str(tmp_path / "port")).save(2, like)
    restored, _ = JaxCheckpointManager(str(tmp_path / "port")).restore(
        2, like=jax.tree.map(jnp.asarray, ef_state))
    _assert_trees_equal(jax.tree.map(np.asarray, restored), ef_state)
    JaxCheckpointManager(str(tmp_path / "jax")).save(2, jax.tree.map(jnp.asarray, ef_state))
    for tlike in (like, train_state_shapes(tcfg, TrainConfig(compress_dp_grads=True))):
        restored, _ = CheckpointManager(str(tmp_path / "jax")).restore(2, like=tlike,
                                                                     device="cpu")
        _assert_trees_equal(params_to_numpy(restored), ef_state)


def test_jax_compressed_state_converts_to_the_port():
    jcfg, _ = _cfgs()
    jtcfg = JaxTrainConfig(optimizer=JaxOptimizerConfig(**OPT), compress_dp_grads=True)
    tree = jax.tree.map(np.asarray, jax_init_train_state(jcfg, jtcfg, jax.random.PRNGKey(0)))
    state = params_from_numpy(tree, "cpu")
    assert set(state) == {"params", "opt", "ef", "step"}
    _assert_trees_equal(params_to_numpy(state), tree)
