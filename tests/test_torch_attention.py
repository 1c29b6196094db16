"""The port's attention against the JAX package's, on the CPU.

The same numpy inputs go through both packages. The port's
``flash_attention`` takes its plain version for CPU tensors, so it is held
to the JAX ``attention_ref`` (the Pallas kernel itself fails under the
installed jax); ``flash_gqa`` and ``chunked_attention`` are held to the JAX
``chunked_attention``, which the JAX models run for prefill, and
``decode_attention`` to its JAX namesake. Tolerance 3e-5, as the JAX
package's own flash-vs-model test (``tests/test_kernels.py``): float32 with
the summation orders of two libraries; gradients are held to ``jax.grad``
at the same tolerance. bfloat16 outputs, computed in float32 and rounded
once on each side, may differ by one bf16 rounding (``BF16_ULP``). The
kernel on the card is checked in ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import attention_ref as jax_attention_ref
from repro.models import layers as jlayers
from repro_torch.kernels import attention as tattn
from repro_torch.models import layers as tlayers

TOL = dict(rtol=3e-5, atol=3e-5)
BF16_ULP = 2.0 ** -7

# (BH, Sq, Sk, hd): the JAX kernel tests' shapes, causal with Sq != Sk both
# ways, ragged lengths, and a short slice of granite's prefill shape.
SHAPES = [(2, 128, 128, 64), (1, 256, 256, 32), (1, 128, 384, 128),
          (2, 100, 300, 64), (2, 300, 100, 64),
          (1, 1, 1, 64), (2, 7, 7, 16), (3, 12, 12, 64), (1, 129, 129, 32),
          (2, 129, 1, 64), (1, 1, 129, 256), (4, 64, 64, 64)]


def _qkv(rng, bh, sq, sk, hd, bkv=None):
    bkv = bh if bkv is None else bkv
    return (rng.standard_normal((bh, sq, hd)).astype(np.float32),
            rng.standard_normal((bkv, sk, hd)).astype(np.float32),
            rng.standard_normal((bkv, sk, hd)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_flash_attention_matches_jax_ref(shape, causal):
    rng = np.random.default_rng(sum(shape) + causal)
    q, k, v = _qkv(rng, *shape)
    launches = tattn.flash_attention.launches
    got = tattn.flash_attention(*_t(q, k, v), causal=causal)
    assert tattn.flash_attention.launches == launches  # CPU: plain version
    want = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("group", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_shared_kv_rows_match_repeated_heads(group, causal):
    """K/V rows shared by ``group`` query rows equal the JAX reference on K/V
    heads repeated ``group`` times (``jnp.repeat``, as the JAX wrapper does)."""
    rng = np.random.default_rng(group)
    q, k, v = _qkv(rng, 8, 40, 56, 32, bkv=8 // group)
    got = tattn.flash_attention(*_t(q, k, v), causal=causal)
    want = jax_attention_ref(jnp.asarray(q), jnp.repeat(jnp.asarray(k), group, 0),
                             jnp.repeat(jnp.asarray(v), group, 0), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _gqa_inputs(rng, B, Sq, Sk, H, KV, hd):
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, hd)).astype(np.float32))


GQA = [(2, 256, 8, 2, 32), (1, 100, 4, 4, 16), (2, 33, 4, 1, 64), (3, 12, 32, 8, 64)]


@pytest.mark.parametrize("B, S, H, KV, hd", GQA)
def test_flash_gqa_matches_jax_chunked_attention(B, S, H, KV, hd):
    rng = np.random.default_rng(S + H)
    q, k, v = _gqa_inputs(rng, B, S, S, H, KV, hd)
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    want = jlayers.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=True, q_positions=pos, k_positions=pos,
                                     kv_chunk=64)
    got = tattn.flash_gqa(*_t(q, k, v), causal=True)
    ref = tattn.flash_gqa_ref(*_t(q, k, v), causal=True)
    assert got.shape == (B, S, H, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B, S, H, KV, hd", GQA)
def test_chunked_attention_matches_jax(B, S, H, KV, hd, causal):
    rng = np.random.default_rng(S * H)
    q, k, v = _gqa_inputs(rng, B, S, S, H, KV, hd)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    want = jlayers.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=causal, q_positions=jnp.asarray(pos),
                                     k_positions=jnp.asarray(pos), kv_chunk=64)
    tpos = torch.from_numpy(pos)
    got = tlayers.chunked_attention(*_t(q, k, v), causal=causal, q_positions=tpos,
                                    k_positions=tpos, kv_chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("position", [0, 5, 23])
def test_decode_attention_matches_jax(position):
    rng = np.random.default_rng(position)
    B, S, H, KV, hd = 3, 24, 8, 2, 16
    q, k, v = _gqa_inputs(rng, B, 1, S, H, KV, hd)
    kpos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    pos_b = np.full((B,), position, np.int32)
    want = jlayers.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    position=jnp.asarray(pos_b),
                                    k_positions=jnp.asarray(kpos))
    got = tlayers.decode_attention(*_t(q, k, v), position=torch.from_numpy(pos_b),
                                   k_positions=torch.from_numpy(kpos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_attention_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(2, 8, 64)
    with pytest.raises(ValueError, match="head dim"):
        tattn.flash_attention(torch.zeros(2, 8, 48), torch.zeros(2, 8, 48),
                              torch.zeros(2, 8, 48))
    with pytest.raises(ValueError, match="float32"):
        tattn.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(2, 64, 8).transpose(1, 2)
        tattn.flash_attention(t, t, t)
    with pytest.raises(ValueError, match="does not fit"):
        tattn.flash_attention(q, torch.zeros(3, 8, 64), torch.zeros(3, 8, 64))
    with pytest.raises(ValueError, match="does not fit"):
        tattn.flash_attention(q, torch.zeros(2, 0, 64), torch.zeros(2, 0, 64))
    # the meta device computes shapes only: the plain version (what the cost
    # counter counts); a device with neither path raises in the kernels' check
    meta = torch.empty(2, 8, 64, device="meta")
    out = tattn.flash_attention(meta, meta, meta)
    assert out.device.type == "meta" and out.shape == (2, 8, 64)
    from repro_torch.kernels import _build
    with pytest.raises(ValueError, match="no kernel for device"):
        _build.on_cuda(meta)


def test_flash_attention_takes_bfloat16():
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 4, 33, 47, 64, bkv=2)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    tb = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16) for a in jb]
    got = tattn.flash_attention(*tb, causal=True)
    want = jax_attention_ref(jb[0], jnp.repeat(jb[1], 2, 0), jnp.repeat(jb[2], 2, 0),
                             causal=True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    assert (np.abs(got - want) <= BF16_ULP * np.maximum(np.abs(got), np.abs(want))).all()


def _jax_grads(q, k, v, w, group, causal):
    def loss(q, k, v):
        out = jax_attention_ref(q, jnp.repeat(k, group, 0), jnp.repeat(v, group, 0),
                                causal=causal)
        return jnp.sum(out * w)
    return jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))


@pytest.mark.parametrize("group", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_gradients_match_jax_grad(group, causal):
    rng = np.random.default_rng(20 + group)
    q, k, v = _qkv(rng, 8, 37, 29, 32, bkv=8 // group)
    w = rng.standard_normal(q.shape).astype(np.float32)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    (tattn.flash_attention(tq, tk, tv, causal=causal) * torch.from_numpy(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), _jax_grads(q, k, v, w, group, causal)):
        assert got.shape == want.shape and float(np.abs(want).max()) > 0.1
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_attention_saves_only_its_inputs():
    """The forward keeps q, k and v for the backward, never the (Sq, Sk)
    probabilities: the backward recomputes them, on every device."""
    rng = np.random.default_rng(6)
    tq, tk, tv = (t.requires_grad_() for t in _t(*_qkv(rng, 4, 40, 50, 16, bkv=2)))
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tattn.flash_attention(tq, tk, tv, causal=True)
    assert sorted(shapes) == sorted([(4, 40, 16), (2, 50, 16), (2, 50, 16)])
    out.sum().backward()
    assert all(t.grad is not None for t in (tq, tk, tv))


def test_kernel_path_carries_the_plain_gradient(monkeypatch):
    """The card's forward goes through the same autograd function: with the
    kernel's launch stood in for by its plain version, the gradients are
    those of the plain version, and the stand-in ran once."""
    from repro_torch.kernels import _build
    calls = []

    def stand_in(q, k, v, causal):
        calls.append(q.shape)
        with torch.no_grad():
            return tattn.attention_ref(q, k, v, causal=causal)

    monkeypatch.setattr(_build, "on_cuda", lambda t: True)
    monkeypatch.setattr(tattn.attention, "_kernel_forward", stand_in)
    rng = np.random.default_rng(8)
    q, k, v = _qkv(rng, 4, 24, 24, 16, bkv=2)
    w = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    (tattn.flash_attention(tq, tk, tv, causal=True) * w).sum().backward()
    assert calls == [(4, 24, 16)]
    pq, pk, pv = (t.requires_grad_() for t in _t(q, k, v))
    (tattn.attention_ref(pq, pk, pv, causal=True) * w).sum().backward()
    for got, want in ((tq, pq), (tk, pk), (tv, pv)):
        torch.testing.assert_close(got.grad, want.grad, rtol=0, atol=0)
