"""The port's SSD scan and the SSM serving paths against the JAX package's,
on the CPU (``test_torch_families.py`` holds the mamba2-780m and
zamba2-1.2b forward, loss, train step, prefill and decode, served tokens and
launchers).

- ``ssd_chunked`` at the JAX package's chunk rule (``Q = chunk`` when it
  divides ``S``, else ``gcd(S, chunk)``): Q 8, 4 and 1 at ``chunk`` 8, and
  two groups (group ``g`` serves heads ``g * H / G`` on, ``jnp.repeat``),
  within ``MODEL_TOL`` (``rtol = atol = 1e-4``), its final state too;
- a config ``dataclasses.replace``d to ``ngroups = 2``, forward, prefill and
  decode within ``MODEL_TOL``;
- bfloat16 parameters on the default cache (bf16 conv taps and K/V, float32
  state): logits within ``BF16_REL`` of the largest JAX logit (the two
  round to bf16 at other places);
- two faults of the reference (ROADMAP.md): the batchers' cache growth,
  which both packages reproduce, and the NaN gradient of the SSD's
  ``where(causal, exp(seg), 0)``, which the port does not.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import decode as jax_decode
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import mamba2 as jmamba2
from repro.models import prefill as jax_prefill
from repro_torch.launch.serve import serve
from repro_torch.models import (decode, forward, init_cache, mamba2, params_from_numpy,
                                prefill)
from repro_torch.serving import Request

from test_torch_families import (MODEL_TOL, _cfgs, _jax, _jax_completions, _perturb_norms,
                                 _torch, jax_ssd_chunked_masked, numpy_batch, numpy_params)

ARCHS = ("mamba2-780m", "zamba2-1.2b")
BF16_REL = 2.0 ** -5


def _ssd_inputs(S, G, seed=0, B=2, H=4, P=8, N=16, dt_scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(dt_scale * rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(np.linspace(0.0, np.log(16.0), H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    return x, dt, A, Bm, Cm, D


@pytest.mark.parametrize("S,G,Q", [(24, 1, 8), (20, 1, 4), (23, 1, 1), (24, 2, 8), (23, 2, 1)])
def test_ssd_chunked_matches_jax(S, G, Q):
    assert mamba2.chunk_len(S, 8) == Q
    inputs = _ssd_inputs(S, G, seed=S + G)
    jy, jstate = jmamba2.ssd_chunked(*map(jnp.asarray, inputs), 8, return_final_state=True)
    ty, tstate = mamba2.ssd_chunked(*map(torch.from_numpy, inputs), 8, return_final_state=True)
    assert ty.shape == jy.shape and tstate.shape == jstate.shape == (2, 4, 8, 16)
    assert np.abs(np.asarray(jy)).max() > 1.0
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MODEL_TOL)
    np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate), **MODEL_TOL)
    if G == 2:   # the groups are not interchangeable: heads 0-1 read group 0
        swapped = list(inputs)
        swapped[3] = inputs[3][:, :, ::-1].copy()
        other = mamba2.ssd_chunked(*map(torch.from_numpy, swapped), 8)
        assert not torch.allclose(other, ty)


def test_ssd_chunk_sizes_agree():
    """The chunked form at Q 8 and 4 and the recurrence at Q 1 are one
    function: the port's three chunkings of one input agree."""
    inputs = [torch.from_numpy(a) for a in _ssd_inputs(24, 1, seed=5)]
    want = mamba2.ssd_chunked(*inputs, 1)
    for chunk in (8, 4, 24):
        torch.testing.assert_close(mamba2.ssd_chunked(*inputs, chunk), want, **MODEL_TOL)


def test_jax_ssd_gradient_is_nan_where_a_masked_exp_overflows():
    """The reference's fault: ``where(causal, exp(seg), 0)`` sends a zero
    cotangent into an ``exp`` that overflowed to inf above the diagonal, and
    0 x inf is NaN, so JAX's gradient is NaN. The port masks before the
    ``exp``: the same values, and the gradient of the masked JAX form."""
    inputs = _ssd_inputs(24, 1, seed=3, dt_scale=3.0)   # dt up to ~10, dA down to ~-160

    def jax_loss(fn):
        return jax.grad(lambda x, dt: jnp.sum(fn(x, dt, *map(jnp.asarray, inputs[2:]), 8) ** 2),
                        argnums=(0, 1))(jnp.asarray(inputs[0]), jnp.asarray(inputs[1]))

    jdx, jddt = jax_loss(jmamba2.ssd_chunked)
    assert np.isfinite(np.asarray(jdx)).all() and np.isnan(np.asarray(jddt)).any()
    want = jax_loss(jax_ssd_chunked_masked)
    x, dt = (torch.from_numpy(a).requires_grad_() for a in inputs[:2])
    y = mamba2.ssd_chunked(x, dt, *map(torch.from_numpy, inputs[2:]), 8)
    np.testing.assert_allclose(
        y.detach().numpy(), np.asarray(jmamba2.ssd_chunked(*map(jnp.asarray, inputs), 8)),
        **MODEL_TOL)
    (y ** 2).sum().backward()
    for got, w in zip((x.grad, dt.grad), want):
        assert torch.isfinite(got).all()
        scale = float(np.abs(np.asarray(w)).max())
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5 * scale)


def test_ssd_chunked_keeps_the_input_dtype():
    inputs = [torch.from_numpy(a) for a in _ssd_inputs(16, 1)]
    inputs[0] = inputs[0].bfloat16()
    y, state = mamba2.ssd_chunked(*inputs, 8, return_final_state=True)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32


# ---------------------------------------------------------------- ngroups 2

def test_two_groups_match_jax():
    """mamba2-780m reduced, ``ngroups = 2``: B and C have two groups of 16
    state dims, each read by half the heads."""
    jcfg, tcfg = (dataclasses.replace(c, ssm=dataclasses.replace(c.ssm, ngroups=2))
                  for c in _cfgs("mamba2-780m"))
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(1)))
    _perturb_norms(tree, np.random.default_rng(7))
    assert tree["layers"]["in_proj"].shape[-1] == 2 * 128 + 2 * 2 * 16 + 16
    tparams = params_from_numpy(tree, "cpu")
    full = numpy_batch(jcfg, length=16, seed=4, batch=2)
    want = np.asarray(jax_forward(jcfg, _jax(tree), _jax(full), remat="none"))
    got = forward(tcfg, tparams, _torch(full), remat="none").numpy()
    assert want[..., :jcfg.vocab_size].std() > 0.1
    np.testing.assert_allclose(got, want, **MODEL_TOL)
    head = {"tokens": full["tokens"][:, :12]}
    jl, jc = jax_prefill(jcfg, _jax(tree), _jax(head), remat="none")
    tl, tc = prefill(tcfg, tparams, _torch(head))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    for i in range(12, 16):
        tok = full["tokens"][:, i:i + 1]
        jl, jc = jax_decode(jcfg, _jax(tree), jc, jnp.asarray(tok), jnp.int32(i))
        tl, tc = decode(tcfg, tparams, tc, torch.from_numpy(tok), i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
        for name in jc:
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **MODEL_TOL)
    # the reference's fault at G > 1, in both packages: the chunk-final
    # states read the sum of the groups' B, decode its own group's, so
    # decode after prefill is not the forward (it is at G = 1:
    # test_torch_families.py)
    for last, whole in ((tl, got), (np.asarray(jl), want)):
        last, whole = np.asarray(last)[:, -1, :jcfg.vocab_size], whole[:, -1, :jcfg.vocab_size]
        assert np.abs(last - whole).max() > 1e-2 * np.abs(whole).max()   # 7.6 % measured


# ---------------------------------------------------------------- caches

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_init_cache_matches_jax(arch, dtype):
    """Leaf names, shapes and dtypes of ``init_cache``: the SSM state is
    float32 whatever ``dtype`` is."""
    jcfg, tcfg = _cfgs(arch)
    want = jax_init_cache(jcfg, 3, 10, getattr(jnp, dtype))
    got = init_cache(tcfg, 3, 10, getattr(torch, dtype), device="cpu")
    assert sorted(got) == sorted(want)
    for name, leaf in got.items():
        assert tuple(leaf.shape) == want[name].shape, name
        assert str(leaf.dtype).split(".")[1] == str(want[name].dtype), name
        assert not leaf.any()
    assert got["state"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_writes_the_cache_in_place(arch):
    _, tcfg = _cfgs(arch)
    params = params_from_numpy(numpy_params(arch), "cpu")
    cache = init_cache(tcfg, 2, 6, dtype=torch.float32, device="cpu")
    before = dict(cache)
    _, out = decode(tcfg, params, cache, torch.tensor([[3], [4]]), 2)
    assert out is cache and all(out[k] is before[k] for k in before)
    assert out["state"].abs().sum() > 0 and out["conv"][:, :, -1].abs().sum() > 0
    if "k" in out:
        assert out["k"][:, :, 2].abs().sum() > 0 and not out["k"][:, :, [0, 1, 3, 4, 5]].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_params_on_the_default_bf16_cache_match_jax(arch):
    """bfloat16 weights, prefill of 8 tokens, then 4 decode steps; and 4
    decode steps from ``init_cache``'s zeros (bf16 conv taps and K/V, a
    float32 state): bf16 logits near JAX's, the conv taps in bf16."""
    jcfg, tcfg = _cfgs(arch)
    bf16 = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), numpy_params(arch))
    tparams = jax.tree.map(
        lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16), bf16)
    toks = np.random.default_rng(9).integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)

    def close(tl, jl):
        got = tl.float().numpy()[..., :jcfg.vocab_size]
        want = np.asarray(jl.astype(jnp.float32))[..., :jcfg.vocab_size]
        assert want.std() > 0.1
        assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()

    jl, jc = jax_prefill(jcfg, bf16, {"tokens": jnp.asarray(toks[:, :8])}, remat="none")
    tl, tc = prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks[:, :8])})
    assert tl.dtype == torch.bfloat16 and tc["conv"].dtype == torch.bfloat16
    assert tc["state"].dtype == torch.float32 and jc["state"].dtype == jnp.float32
    close(tl, jl)
    pad = [(0, 0), (0, 0), (0, 4), (0, 0), (0, 0)]
    jc = {k: jnp.pad(v, pad) if k in ("k", "v") else v for k, v in jc.items()}
    tc = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(tc[k].dtype)
          for k, v in jc.items()}
    jz = jax_init_cache(jcfg, 2, 4)
    tz = init_cache(tcfg, 2, 4, device="cpu")
    assert tz["conv"].dtype == torch.bfloat16 and tz["state"].dtype == torch.float32
    for i in range(8, 12):
        tok = toks[:, i:i + 1]
        jl, jc = jax_decode(jcfg, bf16, jc, jnp.asarray(tok), jnp.int32(i))
        tl, tc = decode(tcfg, tparams, tc, torch.from_numpy(tok), i)
        close(tl, jl)
        jl, jz = jax_decode(jcfg, bf16, jz, jnp.asarray(tok), jnp.int32(i - 8))
        tl, tz = decode(tcfg, tparams, tz, torch.from_numpy(tok), i - 8)
        close(tl, jl)
    assert tz["conv"].dtype == torch.bfloat16 and tz["state"].dtype == torch.float32


# ---------------------------------------------------------------- the batchers' fault

def _requests(longest):
    rng = np.random.default_rng(longest)
    return [Request(i, rng.integers(0, 503, n).astype(np.int32), max_new_tokens=3)
            for i, n in enumerate((longest, max(1, longest - 1)))]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("longest", [3, 16, 5])
def test_both_batchers_break_an_ssm_cache_at_the_reference_lengths(arch, longest):
    """The reference's fault (``serving/batcher.py:137-141``): a cohort's
    cache grows on axis 2 of every leaf of >= 4 dims whose axis 2 equals the
    longest prompt. The SSM ``conv`` leaf's axis 2 is ``conv_width - 1`` (3)
    and the ``state``'s the SSM head count (16 at ``reduced()``), so at
    those lengths both packages grow the wrong axis and decode raises; at 5
    both serve the same tokens."""
    jcfg, tcfg = _cfgs(arch)
    assert tcfg.ssm.conv_width - 1 == 3 and mamba2.ssm_dims(tcfg)[1] == 16
    tree = numpy_params(arch)
    requests = _requests(longest)
    if longest == 5:
        res = serve(tcfg, params_from_numpy(tree, "cpu"), requests, batch_size=2, device="cpu")
        got = [(c.request_id, c.tokens) for c in res.completions]
        assert got == _jax_completions(jcfg, tree, requests, 2)
        assert len(got) == 2 and all(len(t) == 3 for _, t in got)
        return
    with pytest.raises((TypeError, ValueError)):   # jnp.einsum: the dims differ
        _jax_completions(jcfg, tree, requests, 2)
    with pytest.raises(RuntimeError):       # torch.einsum / torch.cat
        serve(tcfg, params_from_numpy(tree, "cpu"), requests, batch_size=2, device="cpu")
