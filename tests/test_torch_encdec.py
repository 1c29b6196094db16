"""The port's encoder-decoder (``repro_torch.models.encdec``, the audio
family) against the JAX package's ``repro.models.encdec``, on the CPU, at
whisper-small as ``.reduced()`` gives it: 2 encoder and 4 decoder layers,
``encoder_seq`` 24, d_model 64, 4 heads of 16 over 4 K/V heads, d_ff 128,
vocab 503 (512 padded).

Parameters are the JAX init through ``params_from_numpy`` with every layer
norm's ``w`` set to ``1 + 0.1 N(0, 1)`` and ``b`` to ``0.1 N(0, 1)``
(``test_torch_families.py``). On the CPU the port's prefill attention is
``flash_gqa``'s plain version, causal for the decoder's self-attention and
non-causal for the encoder and the cross-attention (``Sq != Sk``), where
the JAX package runs ``chunked_attention``.

Tolerances: ``MODEL_TOL`` (``rtol = atol = 1e-4``) on logits, caches and
activations in float32, as ``test_torch_families.py``; decode against the
port's own forward ``DECODE_TOL`` (``2e-4``); ``layer_norm`` ``1e-5`` in
float32 (two summation orders of a 4- to 768-wide mean), and in bf16 one
bf16 rounding (``2^-7`` relative) of the same float32 value; prefill on
bf16 weights within ``BF16_REL`` (``2^-5``) of the largest reference value,
as ``test_torch_serve.py`` holds the dense model (the two frameworks round
to bf16 at other places).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import decode as jax_decode
from repro.models import encdec as jencdec
from repro.models import init_cache as jax_init_cache
from repro.models import layers as jlayers
from repro.models import prefill as jax_prefill
from repro.serving import Batcher as JaxBatcher
from repro.serving import Request as JaxRequest
from repro_torch.kernels.attention import flash_gqa
from repro_torch.models import (decode, encdec, forward, init_cache, layers, loss_fn,
                                params_from_numpy, prefill)
from repro_torch.serving import Batcher, Request

from test_torch_families import (DECODE_TOL, MODEL_TOL, _cfgs, _jax, _torch, numpy_batch,
                                 numpy_params)
from test_torch_train import _with_grad

ARCH = "whisper-small"
LN_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ULP = 2.0 ** -7
BF16_REL = 2.0 ** -5


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs(ARCH)
    tree = numpy_params(ARCH)
    return jcfg, tcfg, tree, _jax(tree), params_from_numpy(tree, "cpu")


def _frames(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, cfg.encdec.encoder_seq, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------- layer_norm

@pytest.mark.parametrize("width", [4, 64, 768])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype, width):
    """The population variance, as ``jnp.var``: at width 4 the unbiased one
    (``torch.var``'s default) is 4/3 of it and moves the output by ~13 %,
    which this case tells apart."""
    rng = np.random.default_rng(width)
    x = (3.0 + 2.0 * rng.standard_normal((5, 7, width))).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(width)).astype(np.float32)
    b = (0.1 * rng.standard_normal(width)).astype(np.float32)
    jx, jw, jb = (jnp.asarray(a).astype(dtype) for a in (x, w, b))
    want = np.asarray(jlayers.layer_norm(jx, jw, jb).astype(jnp.float32))
    tx, tw, tb = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype))
                  for a in (jx, jw, jb))
    got = layers.layer_norm(tx, tw, tb)
    assert got.dtype == tx.dtype
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **LN_TOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_ULP, atol=1e-6)
    if width == 4:
        x32 = tx.float()
        unbiased = ((x32 - x32.mean(-1, keepdim=True)) * torch.rsqrt(x32.var(-1, keepdim=True)
                                                                     + 1e-5) * tw.float()
                    + tb.float())
        assert np.abs(unbiased.numpy() - want).max() > 0.05


# ---------------------------------------------------------------- encoder, decoder

def test_encode_matches_jax(model):
    jcfg, tcfg, _, jparams, tparams = model
    frames = _frames(jcfg, 2, 3)
    want = np.asarray(jencdec.encode(jcfg, jparams, jnp.asarray(frames), remat="none"))
    got = encdec.encode(tcfg, tparams, torch.from_numpy(frames), remat="none")
    assert got.shape == want.shape == (2, jcfg.encdec.encoder_seq, jcfg.d_model)
    assert want.std() > 0.5
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)


def test_decode_train_matches_jax(model):
    """The decoder alone, on one encoder output (JAX's) for both: token
    rows read without ``embed_scale``, ``dec_pos[:S]`` added, causal
    self-attention, cross-attention, tied logits with the padded rows
    masked."""
    jcfg, tcfg, _, jparams, tparams = model
    enc_out = np.asarray(jencdec.encode(jcfg, jparams, jnp.asarray(_frames(jcfg, 2, 4)),
                                        remat="none"))
    toks = numpy_batch(jcfg, length=9, seed=5)["tokens"]
    want = np.asarray(jencdec.decode_train(jcfg, jparams, jnp.asarray(enc_out),
                                           jnp.asarray(toks), remat="none"))
    got = encdec.decode_train(tcfg, tparams, torch.from_numpy(enc_out), torch.from_numpy(toks),
                              remat="none").numpy()
    assert got.shape == want.shape == (2, 9, jcfg.padded_vocab)
    assert want[..., :jcfg.vocab_size].std() > 0.1
    assert (got[..., jcfg.vocab_size:] == -1e30).all()
    np.testing.assert_allclose(got, want, **MODEL_TOL)


@pytest.mark.parametrize("sq,sk,kv_chunk", [(7, 24, 8), (12, 24, 1024), (224, 1500, 1024),
                                            (1, 3000, 1024)])
def test_cross_attention_matches_jax_chunked_attention(sq, sk, kv_chunk):
    """Non-causal attention with ``Sq != Sk`` (and one ``Sq == Sk``) through
    the port's prefill attention, against JAX's ``chunked_attention``,
    which its chunk rule splits into 3, 2 (whisper's 1500 keys: 2 x 750) and
    3 chunks of keys where ``kv_chunk`` is below ``Sk``."""
    rng = np.random.default_rng(sq + sk)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, sk, 4, 16)).astype(np.float32) for _ in range(2))
    chunks = sk // jlayers._kv_chunks(sk, kv_chunk)
    assert chunks == {8: 3, 1024: {24: 1, 1500: 2, 3000: 3}[sk]}[kv_chunk]
    want = np.asarray(jlayers.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        q_positions=jnp.broadcast_to(jnp.arange(sq)[None], (2, sq)),
        k_positions=jnp.broadcast_to(jnp.arange(sk)[None], (2, sk)), kv_chunk=kv_chunk))
    got = flash_gqa(*(torch.from_numpy(a) for a in (q, k, v)), causal=False).numpy()
    np.testing.assert_allclose(got, want, **MODEL_TOL)


@pytest.mark.parametrize("sk", [24, 1500])
def test_mha_block_matches_jax(model, sk):
    """One cross-attention block (projections, attention, ``wo``) of layer
    0 with 12 queries over ``sk`` encoder positions."""
    jcfg, tcfg, tree, _, _ = model
    p = {k: v[0] for k, v in tree["decoder"]["cross_attn"].items()}
    rng = np.random.default_rng(sk)
    xq = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    xkv = rng.standard_normal((2, sk, jcfg.d_model)).astype(np.float32)
    want = np.asarray(jencdec._mha(
        jcfg, _jax(p), jnp.asarray(xq), jnp.asarray(xkv),
        jnp.broadcast_to(jnp.arange(12)[None], (2, 12)),
        jnp.broadcast_to(jnp.arange(sk)[None], (2, sk)), causal=False))
    got, k, v = encdec._mha(tcfg, _torch(p), torch.from_numpy(xq), torch.from_numpy(xkv),
                            causal=False)
    assert k.shape == v.shape == (2, sk, jcfg.eff_kv, jcfg.resolved_head_dim)
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)


# ---------------------------------------------------------------- serving

def test_prefill_then_decode_matches_jax_and_the_forward(model):
    """Batch 3: prefill (all four leaves) then four decode steps on self
    caches grown by four slots, against JAX's; decode writes the self k and
    v in place and leaves the cross leaves as the prefill wrote them; the
    last step's logits against the port's forward over the whole
    sequence."""
    jcfg, tcfg, _, jparams, tparams = model
    S, extra = 10, 4
    full = numpy_batch(jcfg, length=S + extra, seed=19, batch=3)
    head = {"frames": full["frames"], "tokens": full["tokens"][:, :S]}
    jl, jc = jax_prefill(jcfg, jparams, _jax(head), remat="none")
    tl, tc = prefill(tcfg, tparams, _torch(head))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    T, shape = jcfg.encdec.encoder_seq, (jcfg.num_layers, 3)
    for name, length in (("self_k", S), ("self_v", S), ("cross_k", T), ("cross_v", T)):
        want = np.asarray(jc[name])
        assert tc[name].shape == want.shape == shape + (length, jcfg.eff_kv, 16)
        assert tc[name].dtype == torch.float32 and np.abs(want).max() > 0.1
        np.testing.assert_allclose(tc[name].numpy(), want, **MODEL_TOL)

    pad = [(0, 0), (0, 0), (0, extra), (0, 0), (0, 0)]
    jc = {k: jnp.pad(v, pad) if k.startswith("self") else v for k, v in jc.items()}
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    cross = {k: tc[k].clone() for k in ("cross_k", "cross_v")}
    self_k = tc["self_k"]
    for i in range(S, S + extra):
        tok = full["tokens"][:, i:i + 1]
        jl1, jc = jax_decode(jcfg, jparams, jc, jnp.asarray(tok), jnp.int32(i))
        tl1, out = decode(tcfg, tparams, tc, torch.from_numpy(tok), i)
        assert out is tc and out["self_k"] is self_k
        np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), **MODEL_TOL)
        for name in jc:
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **MODEL_TOL)
    for name, want in cross.items():
        assert torch.equal(tc[name], want)
    whole = forward(tcfg, tparams, _torch(full), remat="none")
    np.testing.assert_allclose(tl1[:, -1].numpy(), whole[:, -1].numpy(), **DECODE_TOL)


@pytest.mark.parametrize("frames_dtype", ["bfloat16", "float32"])
def test_prefill_on_bf16_params_matches_jax(model, frames_dtype):
    """bf16 weights through prefill: bf16 logits and self caches, as in
    JAX; float32 frames promote the encoder and the cross k and v to
    float32, as jnp promotes them."""
    jcfg, tcfg, tree, _, _ = model
    bf16 = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), tree)
    tparams = jax.tree.map(
        lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16), bf16)
    batch = numpy_batch(jcfg, length=11, seed=23, batch=2)
    frames = jnp.asarray(batch["frames"]).astype(frames_dtype)
    jl, jc = jax_prefill(jcfg, bf16, {"frames": frames, "tokens": jnp.asarray(batch["tokens"])},
                         remat="none")
    tl, tc = prefill(tcfg, tparams, {
        "frames": torch.from_numpy(np.asarray(frames.astype(jnp.float32))).to(
            getattr(torch, frames_dtype)),
        "tokens": torch.from_numpy(batch["tokens"])})
    assert str(tl.dtype).split(".")[1] == str(jl.dtype) == "bfloat16"
    for name in jc:
        assert str(tc[name].dtype).split(".")[1] == str(jc[name].dtype)
    assert str(jc["cross_k"].dtype) == frames_dtype
    real = slice(0, jcfg.vocab_size)
    got = {"logits": tl.float().numpy()[..., real],
           **{n: tc[n].float().numpy() for n in jc}}
    want = {"logits": np.asarray(jl.astype(jnp.float32))[..., real],
            **{n: np.asarray(jc[n].astype(jnp.float32)) for n in jc}}
    assert want["logits"].std() > 0.1
    for name in got:
        assert got[name].shape == want[name].shape
        assert np.abs(got[name] - want[name]).max() <= BF16_REL * np.abs(want[name]).max(), name


def test_init_cache_matches_jax(model):
    jcfg, tcfg, _, _, _ = model
    for dtype, jdtype in ((None, None), (torch.float32, jnp.float32)):
        kw = {} if dtype is None else {"dtype": dtype}
        jkw = {} if jdtype is None else {"dtype": jdtype}
        got = init_cache(tcfg, 3, 40, device="cpu", **kw)
        want = jax_init_cache(jcfg, 3, 40, **jkw)
        assert sorted(got) == sorted(want) == ["cross_k", "cross_v", "self_k", "self_v"]
        for name, w in want.items():
            assert tuple(got[name].shape) == w.shape
            assert str(got[name].dtype).split(".")[1] == str(w.dtype)
            assert not got[name].any()


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_values_of_none(model, remat):
    """Loss and gradients through ``torch.utils.checkpoint`` around every
    encoder and decoder layer (the encoder's output crosses into each
    recomputed decoder layer) equal those of remat none."""
    _, tcfg, tree, _, _ = model
    batch = _torch(numpy_batch(tcfg, seed=29))
    out = {}
    for mode in ("none", remat):
        leaves, params = _with_grad(params_from_numpy(tree, "cpu"))
        loss = loss_fn(tcfg, params, batch, remat=mode)
        loss.backward()
        out[mode] = (float(loss.detach()), {n: t.grad for n, t in leaves.items()})
    (want_loss, want), (loss, got) = out["none"], out[remat]
    assert loss == want_loss
    assert float(want["encoder/attn/wq"].abs().max()) > 0
    assert float(want["enc_pos"].abs().max()) > 0
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=1e-6, atol=1e-7, msg=name)


# ---------------------------------------------------------------- fault of the reference

def _served(batcher, request_cls, prompts) -> list[list[int]]:
    for i, p in enumerate(prompts):
        batcher.submit(request_cls(i, p, max_new_tokens=3))
    return [c.tokens for c in batcher.run()]


def _recording(decode_fn, shapes):
    def recording_decode(cache, tokens, position):
        shapes.append(tuple(cache["cross_k"].shape))
        return decode_fn(cache, tokens, position)
    return recording_decode


@pytest.mark.parametrize("length", [12, 24])
def test_both_batchers_grow_the_cross_cache_at_a_prompt_of_encoder_length(model, length):
    """ROADMAP.md, faults of the reference: the batchers grow every cache
    leaf of >= 4 dims whose axis 2 equals the longest prompt. A prompt as
    long as the encoder's output (24 frames reduced, 1500 at full size)
    grows ``cross_k`` and ``cross_v`` too, and every decode step's
    cross-attention then reads the zero slots as keys (its query position
    ``T + 1`` masks none of them). Both packages serve the same tokens, the
    fault included; a decode on the ungrown cross cache gives other
    logits."""
    jcfg, tcfg, _, jparams, tparams = model
    prompts = list(numpy_batch(jcfg, length=length, seed=31, batch=2)["tokens"])
    frames = _frames(jcfg, 2, 37)
    T = jcfg.encdec.encoder_seq

    def jpf(tokens):
        return jax_prefill(jcfg, jparams, {"frames": jnp.asarray(frames), "tokens": tokens},
                           remat="none")

    def jdec(cache, tokens, position):
        return jax_decode(jcfg, jparams, cache, tokens, position)

    def tpf(tokens):
        return prefill(tcfg, tparams, {"frames": torch.from_numpy(frames), "tokens": tokens})

    def tdec(cache, tokens, position):
        return decode(tcfg, tparams, cache, tokens, position)

    jshapes, tshapes = [], []
    want = _served(JaxBatcher(jpf, _recording(jdec, jshapes), batch_size=2), JaxRequest, prompts)
    got = _served(Batcher(tpf, _recording(tdec, tshapes), batch_size=2, device="cpu"), Request,
                  prompts)
    assert got == want
    grown = T + 3 if length == T else T
    assert [s[2] for s in jshapes] == [s[2] for s in tshapes] == [grown, grown]

    logits, cache = tpf(torch.from_numpy(np.stack(prompts)))
    first = torch.argmax(logits[:, -1], -1)[:, None]
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 3)) if k.startswith("self") else v
             for k, v in cache.items()}
    right, _ = tdec({k: v.clone() for k, v in cache.items()}, first, length)
    as_served = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 3))
                 if k.startswith("cross") and length == T else v for k, v in cache.items()}
    served, _ = tdec(as_served, first, length)
    assert torch.equal(served, right) == (length != T)
