"""The port's serve path against the JAX package's, on the CPU.

A reduced granite-3-2b with ``num_kv_heads=2`` (GQA groups of 2; the
reduced config itself has 4 query and 4 KV heads) takes the JAX package's
``init_params`` tree with every norm weight (``ln1``, ``ln2``,
``final_norm``) replaced by ``1 + 0.1 N(0, 1)`` from a numpy seed: the JAX
init leaves them zero, which makes every logit 0 and every cache entry 0
(ROADMAP.md, faults of the reference), and a comparison on such weights
would hold for any attention. Each test asserts that what it compares is
not degenerate.

Tolerances: the layers 3e-5 (float32, two libraries' summation orders, as
``tests/test_kernels.py``); the 4-layer model ``rtol = atol = 1e-4`` on
logits of std ~8 and caches of max ~4 (measured differences ~2e-5 and
~2e-6: the layers' rounding, carried through depth). Served tokens and the
response batch must be equal exactly. A bfloat16 cache written from float32
k and v holds the same values on both sides or values one bf16 rounding
apart (``BF16_ULP``: 7 stored significand bits). Prefill on bfloat16 weights
is held to the JAX prefill on the same weights within ``BF16_REL`` x the
largest reference value: the two frameworks round to bf16 at other places
(activations, products' outputs), measured 0.5 on logits of max 50 and 0.04
on caches of max 4 at this size, while a non-causal attention moves the
logits by 35.
"""
import dataclasses
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
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import layers as jlayers
from repro.models import param_shapes as jax_param_shapes
from repro.models import prefill as jax_prefill
from repro.serving import Batcher as JaxBatcher
from repro.serving import Request as JaxRequest
from repro.serving import completions_to_batch as jax_completions_to_batch
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import attention as tattn
from repro_torch.launch.serve import make_requests, serve
from repro_torch.models import (FAMILIES, decode, init_cache, init_params, layers as tlayers,
                                params_from_numpy, params_to_numpy, prefill)
from repro_torch.serving import Batcher, Request, completions_to_batch

ROOT = Path(__file__).resolve().parents[1]
LAYER_TOL = dict(rtol=3e-5, atol=3e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_ULP = 2.0 ** -7
BF16_REL = 2.0 ** -5


def _cfgs():
    jcfg = dataclasses.replace(jax_get_config("granite-3-2b").reduced(), num_kv_heads=2)
    tcfg = dataclasses.replace(get_config("granite-3-2b").reduced(), num_kv_heads=2)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _perturb_norms(tree, seed):
    rng = np.random.default_rng(seed)

    def norm(w):
        return (1.0 + 0.1 * rng.standard_normal(w.shape)).astype(w.dtype)

    tree["layers"]["ln1"] = norm(tree["layers"]["ln1"])
    tree["layers"]["ln2"] = norm(tree["layers"]["ln2"])
    tree["final_norm"] = norm(tree["final_norm"])
    return tree


@pytest.fixture(scope="module")
def model():
    """(jax cfg, port cfg, numpy tree, jax params, port params)."""
    jcfg, tcfg = _cfgs()
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tree = _perturb_norms(tree, seed=7)
    return (jcfg, tcfg, tree, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu"))


def _assert_not_degenerate(logits, cache, cfg):
    real = logits[..., :cfg.vocab_size]
    assert float(real.std()) > 0.1
    assert float(np.abs(cache["k"]).max()) > 0.1 and float(np.abs(cache["v"]).max()) > 0.1


# ---------------------------------------------------------------- layers

def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    for zc in (False, True):
        want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, zc)
        got = tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5, zc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_apply_rope_matches_jax_halves_not_pairs():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32)[None] + 3, (2, 9)).copy()
    want = np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0).numpy()
    np.testing.assert_allclose(got, want, **LAYER_TOL)
    # position 0 is the identity; at position p dims d and d + hd/2 rotate together
    np.testing.assert_array_equal(
        tlayers.apply_rope(torch.from_numpy(x), torch.zeros(2, 9, dtype=torch.int32),
                           10000.0).numpy(), x)


@pytest.mark.parametrize("kind", ["gelu", "geglu", "swiglu", "silu", "relu"])
def test_activations_and_mlps_match_jax(kind):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    wg, wu, wi = (rng.standard_normal((16, 24)).astype(np.float32) * 0.3 for _ in range(3))
    wd = rng.standard_normal((24, 16)).astype(np.float32) * 0.3
    np.testing.assert_allclose(tlayers._activate(torch.from_numpy(x * 3), kind).numpy(),
                               np.asarray(jlayers._activate(jnp.asarray(x * 3), kind)),
                               **LAYER_TOL)
    t, j = (lambda *a: [torch.from_numpy(b) for b in a]), (lambda *a: [jnp.asarray(b) for b in a])
    np.testing.assert_allclose(tlayers.gated_mlp(*t(x, wg, wu, wd), kind).numpy(),
                               np.asarray(jlayers.gated_mlp(*j(x, wg, wu, wd), kind)),
                               **LAYER_TOL)
    np.testing.assert_allclose(tlayers.plain_mlp(*t(x, wi, wd), kind).numpy(),
                               np.asarray(jlayers.plain_mlp(*j(x, wi, wd), kind)),
                               **LAYER_TOL)


def test_softmax_cross_entropy_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 6, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, (2, 6)).astype(np.int32)
    mask = (rng.random((2, 6)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = jlayers.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                             None if m is None else jnp.asarray(m))
        got = tlayers.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), **LAYER_TOL)


# ---------------------------------------------------------------- params

def test_init_params_has_the_jax_tree_shapes_and_zero_norms():
    jcfg, tcfg = _cfgs()
    want = jax.tree.map(lambda s: tuple(s.shape), jax_param_shapes(jcfg))
    params = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    got = jax.tree.map(lambda t: tuple(t.shape), params_to_numpy(params))
    assert got == want
    assert all(params[k].dtype == torch.float32 for k in ("embed", "final_norm"))
    for w in (params["layers"]["ln1"], params["layers"]["ln2"], params["final_norm"]):
        assert not w.any()  # as the JAX init: see ROADMAP.md, faults of the reference
    assert float(params["layers"]["attn"]["wq"].std()) == pytest.approx(64 ** -0.5, rel=0.05)


def test_params_numpy_round_trip(model):
    _, _, tree, _, tparams = model
    back = params_to_numpy(params_from_numpy(tree, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert tparams["layers"]["mlp"]["wg"].device.type == "cpu"


def test_families_cover_every_config_and_whisper_prefills():
    """The port's model API takes the family of every config (the audio
    family was the last to land, ROADMAP item 8f), and the reduced
    whisper-small runs ``init_params``, ``prefill`` and a decode step
    through it: logits over the prompt, the self and cross caches."""
    assert {get_config(arch).family for arch in ARCH_IDS} <= set(FAMILIES)
    cfg = get_config("whisper-small").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    frames = torch.randn(2, cfg.encdec.encoder_seq, cfg.d_model, generator=g)
    tokens = torch.randint(0, cfg.vocab_size, (2, 5), generator=g)
    logits, cache = prefill(cfg, params, {"frames": frames, "tokens": tokens})
    assert logits.shape == (2, 5, cfg.padded_vocab) and torch.isfinite(logits).all()
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        "self_k": (4, 2, 5, 4, 16), "self_v": (4, 2, 5, 4, 16),
        "cross_k": (4, 2, 24, 4, 16), "cross_v": (4, 2, 24, 4, 16)}
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 1)) if k.startswith("self") else v
             for k, v in cache.items()}
    step, _ = decode(cfg, params, cache, tokens[:, :1], 5)
    assert step.shape == (2, 1, cfg.padded_vocab) and torch.isfinite(step).all()


# ---------------------------------------------------------------- model

def test_prefill_and_decode_match_jax(model):
    jcfg, tcfg, _, jparams, tparams = model
    rng = np.random.default_rng(11)
    toks = rng.integers(0, jcfg.vocab_size, (3, 21)).astype(np.int32)
    jl, jc = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)}, remat="none")
    launches = tattn.flash_attention.launches
    tl, tc = prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)})
    assert tattn.flash_attention.launches == launches
    jl, tl = np.asarray(jl), tl.numpy()
    _assert_not_degenerate(jl, {k: np.asarray(v) for k, v in jc.items()}, jcfg)
    np.testing.assert_allclose(tl, jl, **MODEL_TOL)
    for name in ("k", "v"):
        assert tc[name].shape == (4, 3, 21, 2, 16)
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **MODEL_TOL)

    # three decode steps on caches grown by 3 slots, fed the same tokens
    jc = {k: jnp.pad(v, [(0, 0), (0, 0), (0, 3), (0, 0), (0, 0)]) for k, v in jc.items()}
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    nxt = jl[:, -1].argmax(-1).astype(np.int32)
    for step in range(3):
        pos = 21 + step
        jl1, jc = jax_decode(jcfg, jparams, jc, jnp.asarray(nxt)[:, None], jnp.int32(pos))
        tl1, tc = decode(tcfg, tparams, tc, torch.from_numpy(nxt)[:, None], pos)
        jl1 = np.asarray(jl1)
        assert jl1[..., :jcfg.vocab_size].std() > 0.1
        np.testing.assert_allclose(tl1.numpy(), jl1, **MODEL_TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **MODEL_TOL)
        nxt = jl1[:, -1].argmax(-1).astype(np.int32)


def test_decode_on_the_default_bf16_cache_matches_jax(model):
    """``init_cache``'s default dtype is bfloat16 in both packages: decode
    promotes the cache to float32 for its products, returns float32 logits
    and writes k and v into the cache rounded to bf16."""
    jcfg, tcfg, _, jparams, tparams = model
    jc, tc = jax_init_cache(jcfg, 2, 8), init_cache(tcfg, 2, 8, device="cpu")
    assert tc["k"].dtype == torch.bfloat16 and jc["k"].dtype == jnp.bfloat16
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 6)).astype(np.int32)
    for pos in range(6):
        jl, jc = jax_decode(jcfg, jparams, jc, jnp.asarray(toks[:, pos:pos + 1]),
                            jnp.int32(pos))
        tl, tc = decode(tcfg, tparams, tc, torch.from_numpy(toks[:, pos:pos + 1]), pos)
        jl = np.asarray(jl)
        assert tl.dtype == torch.float32 and jl[..., :jcfg.vocab_size].std() > 0.1
        np.testing.assert_allclose(tl.numpy(), jl, **MODEL_TOL)
    for name in ("k", "v"):
        assert tc[name].dtype == torch.bfloat16
        got = tc[name].float().numpy()
        want = np.asarray(jc[name].astype(jnp.float32))
        assert np.abs(want).max() > 0.1 and not want[:, :, 6:].any()
        assert (np.abs(got - want) <= BF16_ULP * np.maximum(np.abs(got), np.abs(want))).all()


def test_prefill_on_bf16_params_matches_jax(model):
    """bfloat16 weights (the JAX package's ``param_shapes`` default) through
    prefill: bf16 logits and caches, near the JAX prefill's."""
    jcfg, tcfg, tree, _, _ = model
    bf16 = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), tree)
    tparams = jax.tree.map(
        lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16), bf16)
    toks = np.random.default_rng(11).integers(0, jcfg.vocab_size, (3, 21)).astype(np.int32)
    jl, jc = jax_prefill(jcfg, bf16, {"tokens": jnp.asarray(toks)}, remat="none")
    tl, tc = prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.bfloat16 and jl.dtype == jnp.bfloat16
    real = slice(0, jcfg.vocab_size)
    got = {"logits": tl.float().numpy()[..., real],
           **{n: tc[n].float().numpy() for n in ("k", "v")}}
    want = {"logits": np.asarray(jl.astype(jnp.float32))[..., real],
            **{n: np.asarray(jc[n].astype(jnp.float32)) for n in ("k", "v")}}
    _assert_not_degenerate(want["logits"], want, jcfg)
    for name in got:
        assert got[name].shape == want[name].shape
        assert np.abs(got[name] - want[name]).max() <= BF16_REL * np.abs(want[name]).max(), name


def test_decode_writes_the_cache_in_place(model):
    _, tcfg, _, _, tparams = model
    cache = init_cache(tcfg, 2, 6, dtype=torch.float32, device="cpu")
    k = cache["k"]
    _, out = decode(tcfg, tparams, cache, torch.tensor([[3], [4]]), 2)
    assert out["k"] is k
    assert k[:, :, 2].abs().sum() > 0 and not k[:, :, [0, 1, 3, 4, 5]].any()


def _requests(cfg, pkg_request, seed, n=7):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(3, 13))
        out.append(pkg_request(i, rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
                               max_new_tokens=int(rng.integers(2, 6))))
    return out


def test_batcher_run_equals_jax_exactly(model):
    jcfg, tcfg, _, jparams, tparams = model

    def jpf(tokens):
        return jax_prefill(jcfg, jparams, {"tokens": tokens}, remat="none")

    def jdec(cache, tokens, position):
        return jax_decode(jcfg, jparams, cache, tokens, position)

    jb = JaxBatcher(jax.jit(jpf), jax.jit(jdec), batch_size=3)
    tb = Batcher(lambda t: prefill(tcfg, tparams, {"tokens": t}),
                 lambda c, t, p: decode(tcfg, tparams, c, t, p), batch_size=3, device="cpu")
    for r in _requests(jcfg, JaxRequest, seed=5):
        jb.submit(r)
    for r in _requests(tcfg, Request, seed=5):
        tb.submit(r)
    want, got = jb.run(), tb.run()
    assert [(c.request_id, c.tokens) for c in got] == [(c.request_id, c.tokens) for c in want]
    tokens = [t for c in got for t in c.tokens]
    assert len(set(tokens)) > 1 and all(0 <= t < tcfg.vocab_size for t in tokens)
    assert completions_to_batch(got).to_pydict() == jax_completions_to_batch(want).to_pydict()


def test_serve_delivers_the_batcher_completions(model):
    _, tcfg, _, _, tparams = model
    reqs = make_requests(tcfg, 6, 12, 4)
    assert [len(r.prompt) for r in reqs] and all(4 <= len(r.prompt) <= 12 for r in reqs)
    res = serve(tcfg, tparams, reqs, batch_size=4, device="cpu")
    assert len(res.prefill_s) == len(res.cohort_tokens) == 2
    assert len(res.decode_s) == 2 * 3 and res.num_tokens == 24
    assert [c.shape[0] for c in res.cohort_tokens] == [4, 2]
    d = res.delivered.to_pydict()
    assert d["token"] == [t for c in res.completions for t in c.tokens]
    assert len(set(d["token"])) > 1
    assert res.transport.serialize_s == 0.0


def test_ingest_batches_reads_token_tables():
    from repro_torch.data import make_token_table
    table = make_token_table("toks", 10, 8, 503, seqs_per_batch=4, seed=3)
    b = Batcher(None, None, batch_size=2, device="cpu")
    assert b.ingest_batches(table.batches, 8, max_new_tokens=3, start_id=100) == 10
    assert [r.request_id for r in b.queue] == list(range(100, 110))
    assert all(r.prompt.shape == (8,) and r.max_new_tokens == 3 for r in b.queue)


_BLOCKED_SERVE = f"""
import importlib.abc, runpy, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ModuleNotFoundError(f"blocked import of {{name}}")
sys.meta_path.insert(0, Block())
sys.path.insert(0, {str(ROOT / "src")!r})
sys.argv = ["serve", "--arch", "granite-3-2b", "--reduced", "--device", "cpu"]
runpy.run_module("repro_torch.launch.serve", run_name="__main__")
"""


def test_serve_cli_runs_on_cpu_without_jax_or_repro():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_SERVE], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "served 8 requests, 64 tokens" in out.stdout
    assert "zero serialize copies: True" in out.stdout
