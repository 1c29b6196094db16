"""The port's dense, MoE, VLM, SSM, hybrid and audio configs against the
JAX package's, on the CPU: every config of those families but granite-3-2b
(which ``test_torch_serve.py`` and ``test_torch_train.py`` hold);
``test_torch_ssm.py`` holds the SSD scan and the SSM serving paths besides,
``test_torch_encdec.py`` the encoder-decoder's parts.

Each reduced config takes the JAX ``init_params`` tree with every norm
weight (``ln1``, ``ln2``, ``final_norm``, ``q_norm``/``k_norm`` where the
config has them; an SSM layer's ``ln`` and gated ``norm``; the hybrid's
shared ``ln1``/``ln2``) set to ``1 + 0.1 N(0, 1)`` from a numpy seed: the
JAX init's zero norms make every logit 0 (ROADMAP.md, faults of the
reference). whisper's layer norms (encoder ``ln1``, ``ln2``, decoder
``ln1``–``ln3``, both final norms) start at ``w = 1``, ``b = 0``; their
``w`` is set to ``1 + 0.1 N(0, 1)`` and ``b`` to ``0.1 N(0, 1)``, so that a
swapped or dropped bias shows. The internvl2 batch adds ``patch_embeds``
(B, 4, 64): its logits cover ``4 + S`` positions and its loss the text
only; the whisper batch adds ``frames`` (B, 24, 64), the encoder's input.

Tolerances: ``MODEL_TOL`` (``rtol = atol = 1e-4``) on logits and caches,
the largest difference measured 3.1e-5 (gemma-2b's logits, std ~16); the
train step as ``test_torch_train.py`` states it (loss ``rtol 1e-5``,
gradient norm ``1e-4``, ``m`` and ``v`` ``1e-3`` of each leaf's largest
value, parameters within the learning rate); decode against the port's own
forward within ``2e-4``, as ``tests/test_models_smoke.py`` holds the JAX
package. Served tokens must be equal exactly. An MoE model is held to JAX
only where its routing is JAX's: two routings of one token can differ only
where two experts' probabilities tie to rounding, and none does here.
"""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import decode as jax_decode
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.models import param_shapes as jax_param_shapes
from repro.models import prefill as jax_prefill
from repro.models import mamba2 as jmamba2
from repro.models import transformer as jtransformer
from repro.serving import Batcher as JaxBatcher
from repro.serving import Request as JaxRequest
from repro.training import CheckpointManager as JaxCheckpointManager
from repro.training import OptimizerConfig as JaxOptimizerConfig
from repro.training import TrainConfig as JaxTrainConfig
from repro.training import init_train_state as jax_init_train_state
from repro.training import make_train_step as jax_make_train_step
from repro.training import train_state_shapes as jax_train_state_shapes
from repro_torch.configs import get_config
from repro_torch.data import shift_labels
from repro_torch.launch.serve import make_requests, serve
from repro_torch.models import (decode, encdec, forward, loss_fn, moe, param_shapes,
                                params_from_numpy, params_to_numpy, prefill, transformer)
from repro_torch.training import (CheckpointManager, OptimizerConfig, TrainConfig,
                                  init_train_state, make_train_step, train_state_shapes)
from repro_torch.training.tree import flatten_with_paths

from test_torch_compression import _jax_steps, _port_steps, assert_compressed_states_close
from test_torch_train import OPT, _paths, _with_grad, assert_states_close

ROOT = Path(__file__).resolve().parents[1]
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ("gemma-2b", "deepseek-67b", "deepseek-coder-33b", "olmoe-1b-7b",
         "llama4-scout-17b-a16e", "internvl2-76b", "mamba2-780m", "zamba2-1.2b",
         "whisper-small")
KV_KEYS = ("k", "v", "self_k", "self_v")   # the cache leaves that grow with the sequence
B, S, EXTRA = 2, 12, 4
ONE_STEP = dict(OPT, warmup_steps=0)   # the full learning rate at step 0


def _cfgs(arch):
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _norm_nodes(params):
    """Every norm weight of a family's tree, as (node, key)."""
    if "mamba_layers" in params:                     # hybrid
        layers, shared = params["mamba_layers"], params["shared"]
        return [(layers, "ln"), (layers, "norm"), (shared, "ln1"), (shared, "ln2"),
                (params, "final_norm")]
    layers = params["layers"]
    if "attn" not in layers:                         # ssm
        return [(layers, "ln"), (layers, "norm"), (params, "final_norm")]
    nodes = [(layers, "ln1"), (layers, "ln2"), (params, "final_norm")]
    return nodes + [(layers["attn"], k) for k in ("q_norm", "k_norm") if k in layers["attn"]]


def _perturb_norms(params, rng):
    if "encoder" in params:                          # audio: LayerNorm w and b
        for node in encdec.layer_norm_nodes(params):
            node["w"] = (1.0 + 0.1 * rng.standard_normal(node["w"].shape)).astype(np.float32)
            node["b"] = (0.1 * rng.standard_normal(node["b"].shape)).astype(np.float32)
        return
    for node, key in _norm_nodes(params):
        node[key] = (1.0 + 0.1 * rng.standard_normal(node[key].shape)).astype(np.float32)


_TREES = {}


def numpy_params(arch):
    """JAX's init at the reduced ``arch``, numpy leaves, perturbed norms."""
    if arch not in _TREES:
        jcfg, _ = _cfgs(arch)
        tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
        _perturb_norms(tree, np.random.default_rng(7))
        _TREES[arch] = tree
    return _TREES[arch]


def numpy_batch(cfg, length=S, seed=11, batch=B):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, length)).astype(np.int32)
    out = {"tokens": toks, "labels": shift_labels(toks)}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal(
            (batch, cfg.vlm.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (batch, cfg.encdec.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _prefix(cfg):
    return cfg.vlm.num_patches if cfg.family == "vlm" else 0


class _RecordRoutes:
    """Records every routing the port's MoE layers make."""

    def __init__(self, monkeypatch):
        self.routes = []
        route = moe.route

        def recording(*args):
            r = route(*args)
            self.routes.append(r)
            return r

        monkeypatch.setattr(moe, "route", recording)

    @property
    def dropped(self) -> int:
        return sum(int((~r.keep).sum()) for r in self.routes)


# ---------------------------------------------------------------- fault 4

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_embed_tokens_scale_is_rounded_like_jax(dtype):
    """gemma-2b's ``embed_scale`` at its full ``d_model`` of 2048: JAX
    multiplies by ``sqrt(2048)`` rounded to the table's dtype (45.25 in
    bf16), so the port must too, bit for bit (ROADMAP.md §3, fault 4)."""
    jcfg, tcfg = jax_get_config("gemma-2b"), get_config("gemma-2b")
    assert tcfg.embed_scale and tcfg.d_model == 2048
    rng = np.random.default_rng(0)
    table = jnp.asarray(rng.standard_normal((64, 2048)).astype(np.float32)).astype(dtype)
    toks = rng.integers(0, 64, (4, 8)).astype(np.int32)
    want = jtransformer.embed_tokens(jcfg, {"embed": table}, jnp.asarray(toks))
    ttable = torch.from_numpy(np.array(table.astype(jnp.float32))).to(getattr(torch, dtype))
    got = transformer.embed_tokens(tcfg, {"embed": ttable}, torch.from_numpy(toks))
    assert got.dtype == ttable.dtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------- shapes

@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "llama4-scout-17b-a16e", "gemma-2b",
                                  "mamba2-780m", "zamba2-1.2b", "whisper-small"])
def test_param_shapes_match_jax_at_full_size(arch):
    """Names, shapes and dtypes leaf for leaf on the meta device, at full
    size; an MoE router stays float32 under bf16, in the parameters and in
    the train state."""
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        got = [(n, tuple(t.shape), str(t.dtype).split(".")[1], t.device.type)
               for n, t in flatten_with_paths(param_shapes(tcfg, dtype))]
        want = [(jax.tree_util.keystr(p, simple=True, separator="/"), tuple(s.shape),
                 str(s.dtype), "meta")
                for p, s in jax.tree_util.tree_flatten_with_path(jax_param_shapes(jcfg, jdtype))[0]]
        assert got == want
    if tcfg.moe is not None:
        rows = dict((n, d) for n, _, d, _ in got)
        assert rows["layers/moe/router"] == "float32"
    tc = TrainConfig(param_dtype="bfloat16")
    got = [(n, tuple(t.shape), str(t.dtype).split(".")[1])
           for n, t in flatten_with_paths(train_state_shapes(tcfg, tc))]
    want = [(jax.tree_util.keystr(p, simple=True, separator="/"), tuple(s.shape), str(s.dtype))
            for p, s in jax.tree_util.tree_flatten_with_path(
                jax_train_state_shapes(jcfg, JaxTrainConfig(param_dtype="bfloat16")))[0]]
    assert got == want


# ---------------------------------------------------------------- forward, loss

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    tree = numpy_params(arch)
    batch = numpy_batch(jcfg)
    batch["labels"][0, :3] = -1
    want = np.asarray(jax_forward(jcfg, _jax(tree), _jax(batch), remat="none"))
    got = forward(tcfg, params_from_numpy(tree, "cpu"), _torch(batch), remat="none").numpy()
    assert got.shape == want.shape == (B, _prefix(jcfg) + S, jcfg.padded_vocab)
    assert want[..., :jcfg.vocab_size].std() > 0.1
    np.testing.assert_allclose(got, want, **MODEL_TOL)
    jloss = float(jax_loss_fn(jcfg, _jax(tree), _jax(batch), remat="none"))
    tloss = float(loss_fn(tcfg, params_from_numpy(tree, "cpu"), _torch(batch), remat="none"))
    assert tloss == pytest.approx(jloss, rel=1e-5) and jloss > 1.0


def test_vlm_loss_counts_the_text_positions_only():
    jcfg, tcfg = _cfgs("internvl2-76b")
    params = params_from_numpy(numpy_params("internvl2-76b"), "cpu")
    batch = _torch(numpy_batch(jcfg))
    logits = forward(tcfg, params, batch, remat="none")
    text = logits[:, tcfg.vlm.num_patches:]
    from repro_torch.models.layers import softmax_cross_entropy
    labels = batch["labels"]
    want = softmax_cross_entropy(text, labels.clamp(min=0), (labels >= 0).float())
    assert float(loss_fn(tcfg, params, batch, remat="none")) == float(want)
    # the patches count: other patches, other text logits
    moved = dict(batch, patch_embeds=batch["patch_embeds"] + 1.0)
    assert not torch.allclose(forward(tcfg, params, moved, remat="none")[:, -1], logits[:, -1])


# ---------------------------------------------------------------- train step

def _numpy_state(arch, param_dtype="float32"):
    jcfg, _ = _cfgs(arch)
    jtcfg = JaxTrainConfig(optimizer=JaxOptimizerConfig(**OPT), remat="none",
                           param_dtype=param_dtype)
    tree = jax.tree.map(np.asarray, jax_init_train_state(jcfg, jtcfg, jax.random.PRNGKey(0)))
    params = numpy_params(arch)
    tree["params"] = jax.tree.map(np.copy, params)
    tree["opt"]["master"] = jax.tree.map(np.copy, params)
    return tree


def jax_ssd_chunked_masked(x, dt, A, B_, C_, D_skip, chunk, return_final_state=False):
    """The JAX package's ``ssd_chunked`` (``repro/models/mamba2.py:87-149``)
    with its causal mask applied before the ``exp`` of the segment sums, as
    the port applies it. The values are the same; the JAX package's
    ``where(causal, exp(seg), 0)`` has a NaN gradient wherever a masked
    ``exp`` overflows to inf (ROADMAP.md, faults of the reference), and the
    port's train step is held to this one."""
    Bb, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    Q = math.gcd(S, chunk) if S % chunk else chunk
    nc, hpg = S // Q, H // G
    xf = x.astype(jnp.float32).reshape(Bb, nc, Q, H, P)
    dtc = dt.reshape(Bb, nc, Q, H)
    Bc = B_.astype(jnp.float32).reshape(Bb, nc, Q, G, N)
    Cc = C_.astype(jnp.float32).reshape(Bb, nc, Q, G, N)
    dAcum = jnp.cumsum(dtc * A[None, None, None, :], axis=2)
    seg = dAcum[:, :, :, None, :] - dAcum[:, :, None, :, :]
    causal = jnp.tril(jnp.ones((Q, Q), bool))[None, None, :, :, None]
    Lmat = jnp.exp(jnp.where(causal, seg, -jnp.inf))
    CB = jnp.repeat(jnp.einsum("bclgn,bcsgn->bclsg", Cc, Bc), hpg, axis=-1)
    y_diag = jnp.einsum("bclsh,bcshp->bclhp", CB * Lmat * dtc[:, :, None, :, :], xf)
    decay_end = jnp.exp(dAcum[:, :, -1:, :] - dAcum)
    Bx = jnp.einsum("bcsgn,bcsh,bcshp->bchpn", Bc, decay_end * dtc, xf)

    def step(state, inputs):
        dec, bx = inputs
        return state * dec[..., None, None] + bx, state

    final_state, states_in = jax.lax.scan(
        step, jnp.zeros((Bb, H, P, N), jnp.float32),
        (jnp.moveaxis(jnp.exp(dAcum[:, :, -1, :]), 1, 0), jnp.moveaxis(Bx, 1, 0)))
    y_off = jnp.einsum("bclhn,bclh,bchpn->bclhp", jnp.repeat(Cc, hpg, axis=-2),
                       jnp.exp(dAcum), jnp.moveaxis(states_in, 0, 1))
    y = (y_diag + y_off + xf * D_skip[None, None, None, :, None]).reshape(Bb, S, H, P)
    y = y.astype(x.dtype)
    return (y, final_state) if return_final_state else y


def _jax_step(jcfg, tree, batch, **kw):
    step = jax.jit(jax_make_train_step(jcfg, JaxTrainConfig(
        optimizer=JaxOptimizerConfig(**ONE_STEP), remat="none", **kw)))
    state, m = step(_jax(tree), _jax(batch))
    return jax.tree.map(np.asarray, state), {k: float(v) for k, v in m.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, monkeypatch):
    """One step against JAX's; an SSM's against JAX's with the SSD's mask
    before its ``exp`` (:func:`jax_ssd_chunked_masked`): JAX's own gradient
    is NaN at zamba2's batch here (``test_torch_ssm.py`` pins that)."""
    jcfg, tcfg = _cfgs(arch)
    tree = _numpy_state(arch)
    batch = numpy_batch(jcfg, seed=13)
    if jcfg.ssm is not None:
        monkeypatch.setattr(jmamba2, "ssd_chunked", jax_ssd_chunked_masked)
    want_state, want = _jax_step(jcfg, tree, batch)
    step = make_train_step(tcfg, TrainConfig(optimizer=OptimizerConfig(**ONE_STEP),
                                             remat="none"))
    state, got = step(params_from_numpy(tree, "cpu"), _torch(batch))
    got = {k: float(v) for k, v in got.items()}
    assert got.keys() == want.keys() == {"loss", "grad_norm", "lr", "tokens"}
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-4)
    assert got["lr"] == pytest.approx(want["lr"], rel=1e-6) and want["lr"] > 0
    assert got["tokens"] == want["tokens"] == B * S
    got_state = params_to_numpy(state)
    if tcfg.moe is not None and tcfg.moe.top_k == 1:
        # top-1: the gate weight is p / p = 1, so the router's gradient is
        # zero but for rounding in both packages (test_torch_moe.py), and
        # its moments are that rounding
        for st in (got_state, want_state):
            for key in ("m", "v"):
                noise = st["opt"][key]["layers"]["moe"].pop("router")
                assert np.abs(noise).max() < 1e-8
    # one step: where a gradient is ~0, mhat / sqrt(vhat) is its sign, which
    # two right implementations may take apart (test_torch_train.py)
    assert_states_close(got_state, want_state, 2 * want["lr"])
    moved = [n for n, a in _paths(want_state["params"]).items()
             if not np.array_equal(a, _paths(tree["params"])[n])]
    assert len(moved) == len(_paths(tree["params"]))  # every leaf has a gradient


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_values_of_none_on_the_moe(remat):
    """The MoE layer under ``torch.utils.checkpoint``: the recompute routes
    the tokens again, to the same experts, so loss and gradients equal
    those of remat none (as ``test_torch_train.py`` holds the dense model)."""
    _, tcfg = _cfgs("olmoe-1b-7b")
    batch = _torch(numpy_batch(tcfg, seed=3))
    out = {}
    for mode in ("none", remat):
        leaves, tree = _with_grad(params_from_numpy(numpy_params("olmoe-1b-7b"), "cpu"))
        loss = loss_fn(tcfg, tree, batch, remat=mode)
        loss.backward()
        out[mode] = (float(loss), {n: t.grad for n, t in leaves.items()})
    (want_loss, want), (loss, got) = out["none"], out[remat]
    assert loss == want_loss
    assert float(want["layers/moe/router"].abs().max()) > 0
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=1e-6, atol=1e-7, msg=name)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "llama4-scout-17b-a16e"])
def test_bf16_train_state_keeps_the_float32_router(arch):
    """``param_dtype="bfloat16"``: every parameter bf16 but the MoE router,
    float32 as in JAX; the master copy and the moments float32. A step keeps
    every dtype, and its loss is near the JAX step's on the same bf16
    weights (the two round to bf16 at other places)."""
    jcfg, tcfg = _cfgs(arch)
    tc = TrainConfig(optimizer=OptimizerConfig(**ONE_STEP), remat="none",
                     param_dtype="bfloat16")
    state = init_train_state(tcfg, tc, torch.Generator().manual_seed(0), "cpu")
    jstate = jax_init_train_state(jcfg, JaxTrainConfig(param_dtype="bfloat16"),
                                  jax.random.PRNGKey(0))

    def dtypes(rows):
        return [(n, str(t.dtype).split(".")[-1]) for n, t in rows]

    want = dtypes((jax.tree_util.keystr(p, simple=True, separator="/"), s)
                  for p, s in jax.tree_util.tree_flatten_with_path(jstate)[0])
    assert dtypes(flatten_with_paths(state)) == want
    assert dict(want)["params/layers/moe/router"] == "float32"
    assert dict(want)["params/layers/moe/wg"] == "bfloat16"
    # both steps from the same bf16 weights: JAX's, perturbed norms
    tree = jax.tree.map(np.asarray, jax.tree.map(lambda a: a.astype(jnp.float32), jstate))
    _perturb_norms(tree["params"], np.random.default_rng(7))
    tree["opt"]["master"] = jax.tree.map(np.copy, tree["params"])
    bf16 = jax.tree.map(lambda a, like: jnp.asarray(a).astype(like.dtype), tree, jstate)
    ported = jax.tree.map(lambda a, like: torch.from_numpy(np.array(a)).to(
        getattr(torch, str(like.dtype))), tree, jstate)
    batch = numpy_batch(jcfg, seed=13)
    step = jax.jit(jax_make_train_step(jcfg, JaxTrainConfig(
        optimizer=JaxOptimizerConfig(**ONE_STEP), remat="none", param_dtype="bfloat16")))
    jafter, jm = step(bf16, _jax(batch))
    after, m = make_train_step(tcfg, tc)(ported, _torch(batch))
    assert dtypes(flatten_with_paths(after)) == want
    assert dtypes((jax.tree_util.keystr(p, simple=True, separator="/"), s)
                  for p, s in jax.tree_util.tree_flatten_with_path(jafter)[0]) == want
    assert np.isfinite(float(m["loss"])) and float(m["loss"]) == pytest.approx(
        float(jm["loss"]), rel=2.0 ** -5)
    router = after["params"]["layers"]["moe"]["router"]
    assert not torch.equal(router, torch.from_numpy(np.array(tree["params"]["layers"]["moe"]["router"])))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "gemma-2b"])
def test_compressed_train_steps_match_jax(arch):
    """``compress_dp_grads=True`` on the MoE and gemma trees: three steps
    against JAX's with the tolerances of ``test_torch_compression.py``."""
    jcfg, tcfg = _cfgs(arch)
    tree = _numpy_state(arch)
    tree["ef"] = jax.tree.map(np.zeros_like, tree["params"])
    batches = [numpy_batch(jcfg, seed=20 + i) for i in range(3)]
    want_state, want = _jax_steps(jcfg, tree, batches, 1)
    got_state, got = _port_steps(tcfg, tree, batches, 1)
    for g, w in zip(got, want):
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-4)
    assert_compressed_states_close(got_state, want_state, sum(m["lr"] for m in want))


def test_moe_checkpoint_restores_in_both_packages(tmp_path):
    """The MoE train state (its float32 router among bf16 leaves too) saved
    by either package restores in the other bit for bit."""
    jcfg, tcfg = _cfgs("olmoe-1b-7b")
    for dtype in ("float32", "bfloat16"):
        jstate = jax_init_train_state(jcfg, JaxTrainConfig(param_dtype=dtype),
                                      jax.random.PRNGKey(3))
        d = tmp_path / dtype
        JaxCheckpointManager(str(d / "jax")).save(1, jstate, cursors={"batch_offset": 2})
        like = train_state_shapes(tcfg, TrainConfig(param_dtype=dtype))
        restored, man = CheckpointManager(str(d / "jax")).restore(1, like=like, device="cpu")
        assert man.cursors == {"batch_offset": 2}
        want = [(jax.tree_util.keystr(p, simple=True, separator="/"), np.asarray(
            a.astype(jnp.float32)), str(a.dtype))
                for p, a in jax.tree_util.tree_flatten_with_path(jstate)[0]]
        got = flatten_with_paths(restored)
        assert [n for n, _ in got] == [n for n, _, _ in want]
        for (n, t), (_, w, dt) in zip(got, want):
            assert str(t.dtype).split(".")[1] == dt, n
            np.testing.assert_array_equal(t.float().numpy(), w, err_msg=n)
        CheckpointManager(str(d / "port")).save(1, restored, cursors={"batch_offset": 2})
        back, _ = JaxCheckpointManager(str(d / "port")).restore(1, like=jstate)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)),
                                          np.asarray(b.astype(jnp.float32)))


# ---------------------------------------------------------------- prefill, decode

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_and_the_forward(arch, monkeypatch):
    """Prefill, then four decode steps on caches whose k and v grew by four
    slots, fed the tokens of a longer sequence: against JAX's prefill and
    decode (every cache leaf: an SSM's state and conv taps too), and the
    last logits against the port's own forward over the whole sequence (as
    ``test_attention_decode_matches_forward`` and
    ``test_ssm_decode_matches_forward``: the recurrent and the chunked form
    of the SSD agree). The prefill and the
    forward route their MoE tokens as one group each and a decode step its
    batch as another, so the three agree only where no capacity drops a
    pair: the check against the forward runs the config at a capacity
    factor of ``num_experts / top_k``, where each expert can take every
    token, and asserts that nothing was dropped."""
    jcfg, tcfg = _cfgs(arch)
    tree = numpy_params(arch)
    jparams, tparams = _jax(tree), params_from_numpy(tree, "cpu")
    full = numpy_batch(jcfg, length=S + EXTRA, seed=17, batch=1)
    head = dict(full, tokens=full["tokens"][:, :S])
    head.pop("labels")
    jl, jc = jax_prefill(jcfg, jparams, _jax(head), remat="none")
    tl, tc = prefill(tcfg, tparams, _torch(head))
    P = _prefix(jcfg)
    assert tl.shape == (1, P + S, jcfg.padded_vocab)
    assert np.asarray(jl)[..., :jcfg.vocab_size].std() > 0.1
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    kv_rows = jcfg.num_layers if jcfg.hybrid is None else jcfg.num_layers // jcfg.hybrid.shared_every
    want_keys = {"ssm": {"state", "conv"}, "hybrid": {"state", "conv", "k", "v"},
                 "audio": {"self_k", "self_v", "cross_k", "cross_v"}}
    assert set(tc) == set(jc) == want_keys.get(jcfg.family, {"k", "v"})
    for name in jc:
        want = np.asarray(jc[name])
        assert tc[name].shape == want.shape and tc[name].dtype == torch.float32
        if name in KV_KEYS:
            assert want.shape == (kv_rows, 1, P + S, jcfg.eff_kv, jcfg.resolved_head_dim)
        assert np.abs(want).max() > 0.1
        np.testing.assert_allclose(tc[name].numpy(), want, **MODEL_TOL)

    pad = [(0, 0), (0, 0), (0, EXTRA), (0, 0), (0, 0)]
    jc = {k: jnp.pad(v, pad) if k in KV_KEYS else v for k, v in jc.items()}
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    for i in range(S, S + EXTRA):
        tok = full["tokens"][:, i:i + 1]
        jl1, jc = jax_decode(jcfg, jparams, jc, jnp.asarray(tok), jnp.int32(P + i))
        tl1, tc = decode(tcfg, tparams, tc, torch.from_numpy(tok), P + i)
        np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), **MODEL_TOL)
        for name in jc:
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **MODEL_TOL)

    if tcfg.moe is not None:
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=tcfg.moe.num_experts / tcfg.moe.top_k))
    routes = _RecordRoutes(monkeypatch)
    _, tc = prefill(tcfg, tparams, _torch(head))
    tc = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, EXTRA)) if k in KV_KEYS else v
          for k, v in tc.items()}
    for i in range(S, S + EXTRA):
        tl1, tc = decode(tcfg, tparams, tc, torch.from_numpy(full["tokens"][:, i:i + 1]), P + i)
    whole = forward(tcfg, tparams, _torch(full), remat="none")
    assert routes.dropped == 0
    assert len(routes.routes) == (jcfg.num_layers * (EXTRA + 2) if jcfg.moe else 0)
    np.testing.assert_allclose(tl1[:, -1].numpy(), whole[:, -1].numpy(), **DECODE_TOL)


# ---------------------------------------------------------------- serving

def _jax_completions(jcfg, tree, requests, batch_size):
    jparams = _jax(tree)

    def jpf(tokens):
        return jax_prefill(jcfg, jparams, {"tokens": tokens}, remat="none")

    def jdec(cache, tokens, position):
        return jax_decode(jcfg, jparams, cache, tokens, position)

    jb = JaxBatcher(jax.jit(jpf), jax.jit(jdec), batch_size=batch_size)
    for r in requests:
        jb.submit(JaxRequest(r.request_id, r.prompt, max_new_tokens=r.max_new_tokens))
    return [(c.request_id, c.tokens) for c in jb.run()]


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "gemma-2b", "mamba2-780m", "zamba2-1.2b"])
def test_serve_gives_the_jax_greedy_tokens(arch):
    jcfg, tcfg = _cfgs(arch)
    tree = numpy_params(arch)
    requests = make_requests(tcfg, 6, 12, 5)
    res = serve(tcfg, params_from_numpy(tree, "cpu"), requests, batch_size=4, device="cpu")
    got = [(c.request_id, c.tokens) for c in res.completions]
    assert got == _jax_completions(jcfg, tree, requests, 4)
    tokens = [t for _, toks in got for t in toks]
    assert len(tokens) == 30 and len(set(tokens)) > 1
    assert res.delivered.to_pydict()["token"] == tokens


_BLOCKED = f"""
import importlib.abc, runpy, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ModuleNotFoundError(f"blocked import of {{name}}")
sys.meta_path.insert(0, Block())
sys.path.insert(0, {str(ROOT / "src")!r})
sys.argv = sys.argv[1:]
runpy.run_module(sys.argv[0], run_name="__main__")
"""


def _run_blocked(tmp_path, *argv):
    return subprocess.run([sys.executable, "-c", _BLOCKED, *argv], capture_output=True,
                          text=True, timeout=300, cwd=tmp_path,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "gemma-2b", "mamba2-780m", "zamba2-1.2b"])
def test_launchers_run_the_family_on_cpu_without_jax_or_repro(arch, tmp_path):
    out = _run_blocked(tmp_path, "repro_torch.launch.serve", "--arch", arch, "--reduced",
                       "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "served 8 requests, 64 tokens" in out.stdout
    out = _run_blocked(tmp_path, "repro_torch.launch.train", "--arch", arch, "--reduced",
                       "--device", "cpu", "--steps", "2", "--log-every", "1",
                       "--batch-seqs", "4", "--seq-len", "16", "--num-seqs", "32",
                       "--ckpt-dir", str(tmp_path / "ck"))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("step     1 loss ") and lines[-1].startswith("done: 2 steps")
    assert sorted(os.listdir(tmp_path / "ck" / arch))[-1] == "ckpt_00000002.thallus"


@pytest.mark.parametrize("arch", ["internvl2-76b", "whisper-small"])
def test_serve_launcher_refuses_the_vlm_as_jax_does(tmp_path, arch):
    """The vlm and the audio family need front-end inputs that the serve
    launcher does not make, in either package."""
    out = _run_blocked(tmp_path, "repro_torch.launch.serve", "--arch", arch,
                       "--reduced", "--device", "cpu")
    assert out.returncode != 0 and "vlm/audio need frontend inputs" in out.stderr
