"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: without a CUDA card every test here skips (a CUDA kernel has
no CPU mode; the CPU tests hold the plain versions to the JAX package). The
file imports no JAX, so it also runs on a machine with the card and no JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import batch_from_pydict, schema
from repro_torch.core.device_transport import batch_to_device, batch_to_device_packed
from repro_torch.kernels import attention as tattn
from repro_torch.kernels import pack as tpack
from repro_torch.kernels import take as ttake

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels under csrc/ have no CPU mode")
    return torch.device("cuda")


def _bits(t):
    flat = t.reshape(-1)
    return flat.new_empty(0, dtype=torch.uint8) if flat.numel() == 0 else \
        flat.contiguous().view(torch.uint8)


def _assert_bits_equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_bits(got).cpu(), _bits(want).cpu())


@pytest.mark.parametrize("dtype", (np.float16, np.float32, np.float64, np.int64, np.uint8))
@pytest.mark.parametrize("sizes", [[1], [0, 100], [8192, 64, 3, 4097], [1 << 15] * 3])
def test_pack_unpack_kernels_equal_plain(cuda, dtype, sizes):
    rng = np.random.default_rng(0)
    segs = [torch.from_numpy((rng.standard_normal(n) * 100).astype(dtype)).to(cuda)
            for n in sizes]
    staged, lens = tpack.stage_segments(segs)
    sid, tid = (torch.from_numpy(a).to(cuda) for a in tpack.routing([int(n) for n in lens]))
    launches = tpack.pack_tiles.launches
    packed = tpack.pack_tiles(staged, sid, tid)
    assert tpack.pack_tiles.launches == launches + 1
    _assert_bits_equal(packed, tpack.pack_ref(staged, sid, tid))

    lens = [int(n) for n in lens]
    max_tiles = staged.shape[1]
    padded = torch.cat([packed, torch.zeros_like(packed[:1])])
    inv = torch.from_numpy(tpack.inverse_routing(lens, max_tiles)).to(cuda)
    launches = tpack.unpack_tiles.launches
    ragged = tpack.unpack_tiles(padded, inv, n_seg=len(lens), max_tiles=max_tiles)
    assert tpack.unpack_tiles.launches == launches + 1
    _assert_bits_equal(ragged, tpack.unpack_gather_ref(padded, inv, len(lens), max_tiles))
    _assert_bits_equal(ragged, tpack.unpack_ref(packed, sid, tid, len(lens), max_tiles))
    for s, o in zip(segs, tpack.unpack_segments(packed, lens)):
        assert o.device == packed.device
        _assert_bits_equal(o, _bits(s))


@pytest.mark.parametrize("dtype", (np.float16, np.float32, np.int32, np.int64, np.float64))
@pytest.mark.parametrize("width", [None, 1, 3, 128, 200])
def test_take_kernel_equals_plain(cuda, dtype, width):
    rng = np.random.default_rng(1)
    n = 513
    shape = (n,) if width is None else (n, width)
    vals = torch.from_numpy((rng.standard_normal(shape) * 1e3).astype(dtype)).to(cuda)
    idx = np.concatenate([rng.integers(0, n, 200), [-1, -n, -(n + 2), n, n + 2]])
    idx = torch.from_numpy(idx.astype(np.int32)).to(cuda)
    launches = ttake.take_rows.launches
    got = ttake.take_column(vals, idx)
    assert ttake.take_rows.launches == launches + 1
    _assert_bits_equal(got, ttake.take_ref(vals, idx))


def test_take_kernel_on_unaligned_rows(cuda):
    # A view one 6-byte row into its storage: only a 2-byte vector divides it.
    base = torch.arange(3 * 40, dtype=torch.float16, device=cuda).reshape(40, 3)
    vals = base[1:]
    assert ttake.take.vector_bytes(6, vals.data_ptr()) == 2
    idx = torch.tensor([0, 38, -1, 5, 100], dtype=torch.int32, device=cuda)
    _assert_bits_equal(ttake.take_rows(vals, idx), ttake.take_ref(vals, idx))


@pytest.mark.parametrize("n", [1, 7, 8, 100, 1024, 10000, (1 << 14) + 3])
def test_bitmap_kernel_equals_plain(cuda, n):
    mask = np.random.default_rng(n).integers(0, 2, n).astype(bool)
    bm = torch.from_numpy(np.packbits(mask, bitorder="little")).to(cuda)
    launches = ttake.bitmap_expand.launches
    got = ttake.expand_validity(bm, n)
    assert ttake.bitmap_expand.launches == launches + 1
    _assert_bits_equal(got, ttake.bitmap_expand_ref(bm, n))
    assert torch.equal(got.cpu(), torch.from_numpy(mask))


def test_wrappers_reject_bad_arguments_on_the_card(cuda):
    vals = torch.zeros((4, 2), device=cuda)
    with pytest.raises(ValueError):
        ttake.take_rows(vals, torch.zeros(3, dtype=torch.int32))  # indices on the CPU
    with pytest.raises(ValueError):
        ttake.bitmap_expand(torch.zeros(4, dtype=torch.int16, device=cuda))
    src = torch.zeros((1, 1, 32, 128), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        tpack.pack_tiles(src, torch.zeros(1, dtype=torch.int64, device=cuda),
                         torch.zeros(1, dtype=torch.int32, device=cuda))


def test_landings_on_the_card_equal_the_host(cuda):
    sch = schema(("id", "int64"), ("val", "float64"), ("flag", "bool"))
    batch = batch_from_pydict(sch, {"id": list(range(50)),
                                    "val": [None if i % 17 == 0 else i / 7 for i in range(50)],
                                    "flag": [i % 2 == 0 for i in range(50)]})
    for land in (batch_to_device, batch_to_device_packed):
        db = land(batch)
        for name in ("id", "val", "flag"):
            assert db[name].device.type == "cuda"
            np.testing.assert_array_equal(db[name].cpu().numpy(), batch.column(name).values)
        np.testing.assert_array_equal(db.validity["val"].cpu().numpy(),
                                      batch.column("val").validity)


# Attention: float32 with another summation order than the plain version
# (online softmax over 64- or 32-key tiles, FMAs): atol = rtol = 1e-4,
# against differences of ~1e-6 on unit-normal inputs. A bfloat16 output is
# that float32 result rounded once on each side, so the two may also differ
# by one bf16 ulp more: at most 2^-7 |plain| (7 stored significand bits).
ATT_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_ULP = 2.0 ** -7


# The kernel's tiles: 64 query rows, 64 keys (hd <= 64) or 32 (hd 128, 256);
# the shapes straddle them (63, 65, 129 = 2 x 64 + 1, 33, 65 = 2 x 32 + 1).
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 128, 128, 64), (1, 256, 256, 32), (1, 128, 384, 128),
                                   (2, 100, 300, 64), (2, 300, 100, 64), (1, 1, 1, 64),
                                   (2, 7, 7, 16), (3, 12, 12, 64), (1, 129, 129, 32),
                                   (1, 1000, 1000, 64), (1, 40, 70, 256),
                                   (2, 63, 63, 64), (2, 65, 65, 64), (2, 63, 129, 64),
                                   (2, 129, 65, 16), (1, 65, 33, 128), (1, 33, 65, 256),
                                   (1, 65, 65, 256)], ids=str)
def test_flash_attention_kernel_close_to_plain(cuda, shape, causal):
    bh, sq, sk, hd = shape
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    q, k, v = (torch.randn(bh, s, hd, generator=g, device=cuda) for s in (sq, sk, sk))
    launches = tattn.flash_attention.launches
    got = tattn.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tattn.flash_attention.launches == launches + 1
    want = tattn.attention_ref(q, k, v, causal=causal)
    assert got.shape == want.shape and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **ATT_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_gqa_kernel_reads_shared_kv_heads(cuda, causal):
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(2, 77, 8, 64, generator=g, device=cuda)
    k, v = (torch.randn(2, 77, 2, 64, generator=g, device=cuda) for _ in range(2))
    torch.testing.assert_close(tattn.flash_gqa(q, k, v, causal=causal),
                               tattn.flash_gqa_ref(q, k, v, causal=causal), **ATT_TOL)


def test_flash_attention_kernel_on_unaligned_rows(cuda):
    """A contiguous view 4 bytes into its storage: the kernel reads float4s,
    so the wrapper hands it an aligned copy."""
    base = torch.randn(1 + 2 * 40 * 64, generator=torch.Generator(device=cuda).manual_seed(4),
                       device=cuda)
    q = base[1:].view(2, 40, 64)
    assert q.is_contiguous() and q.data_ptr() % 16
    torch.testing.assert_close(tattn.flash_attention(q, q, q, causal=True),
                               tattn.attention_ref(q, q, q, causal=True), **ATT_TOL)


@pytest.mark.parametrize("shape", [(4, 65, 65, 64, 2), (2, 129, 63, 128, 1), (8, 40, 40, 16, 2)],
                         ids=str)
def test_flash_attention_kernel_takes_bfloat16(cuda, shape):
    bh, sq, sk, hd, bkv = shape
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    q, k, v = (torch.randn(n, s, hd, generator=g, device=cuda).bfloat16()
               for n, s in ((bh, sq), (bkv, sk), (bkv, sk)))
    launches = tattn.flash_attention.launches
    got = tattn.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert tattn.flash_attention.launches == launches + 1
    want = tattn.attention_ref(q, k, v, causal=True)
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    got, want = got.float(), want.float()
    limit = ATT_TOL["atol"] + (ATT_TOL["rtol"] + BF16_ULP) * want.abs()
    assert ((got - want).abs() <= limit).all()


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_has_the_plain_gradient(cuda, causal):
    g = torch.Generator(device=cuda).manual_seed(9)
    q = torch.randn(8, 130, 64, generator=g, device=cuda)
    k, v = (torch.randn(2, 97, 64, generator=g, device=cuda) for _ in range(2))
    w = torch.randn(q.shape, generator=g, device=cuda)
    grads = []
    for attend in (tattn.flash_attention, tattn.attention_ref):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        (attend(*leaves, causal=causal) * w).sum().backward()
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert got is not None and float(want.abs().max()) > 0.1
        torch.testing.assert_close(got, want, **ATT_TOL)


def test_flash_attention_rejects_bad_arguments_on_the_card(cuda):
    q = torch.zeros(2, 8, 64, device=cuda)
    with pytest.raises(ValueError):
        tattn.flash_attention(q, q.cpu(), q.cpu())
    with pytest.raises(ValueError):
        tattn.flash_attention(q.half(), q.half(), q.half())


def test_reduced_granite_prefill_through_the_kernel(cuda):
    """A reduced granite (GQA 4:2, head dim 16) on perturbed norms: prefill
    through the kernel equals prefill through the plain attention."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import prefill, transformer

    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(), num_kv_heads=2)
    params = transformer.init_transformer_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                                                 device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    for key in ("ln1", "ln2"):
        params["layers"][key] = 1 + 0.1 * torch.randn(params["layers"][key].shape,
                                                      generator=g, device=cuda)
    params["final_norm"] = 1 + 0.1 * torch.randn(cfg.d_model, generator=g, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (3, 45), generator=g, device=cuda)
    launches = tattn.flash_attention.launches
    logits, cache = prefill(cfg, params, {"tokens": tokens})
    assert tattn.flash_attention.launches == launches + cfg.num_layers
    plain = transformer.flash_gqa
    transformer.flash_gqa = tattn.flash_gqa_ref
    try:
        want_logits, want_cache = prefill(cfg, params, {"tokens": tokens})
    finally:
        transformer.flash_gqa = plain
    assert logits[..., :cfg.vocab_size].std() > 0.1
    torch.testing.assert_close(logits, want_logits, **ATT_TOL)
    for name in ("k", "v"):
        torch.testing.assert_close(cache[name], want_cache[name], **ATT_TOL)
