"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: without a CUDA card every test here skips (a CUDA kernel has
no CPU mode; the CPU tests hold the plain versions to the JAX package). The
file imports no JAX, so it also runs on a machine with the card and no JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import math

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


def _pinned_indices(rng, n, count=200):
    idx = np.concatenate([rng.integers(0, n, count), [-1, -n, -(n + 2), n, n + 2]])
    return torch.from_numpy(idx.astype(np.int32))


def _table_columns(rng, n, count, kind):
    """``count`` columns of ``n`` rows over the take kernel's dtypes:
    ``mixed``, 1-D and 2-D of 1, 3, 128 and 200 units; ``narrow``, 1-D
    float64; ``narrow_mixed``, 1-D of every dtype."""
    dtypes = (np.float16, np.float32, np.int32, np.int64, np.float64, np.int8)
    widths = {"mixed": (None, 1, 3, 128, 200, None, 3)}.get(kind, (None,))
    if kind == "narrow":
        dtypes = (np.float64,)
    return [torch.from_numpy((rng.standard_normal((n,) if w is None else (n, w)) * 100)
                             .astype(dtypes[k % len(dtypes)]))
            for k, w in ((k, widths[k % len(widths)]) for k in range(count))]


@pytest.mark.parametrize("kind", ["mixed", "narrow", "narrow_mixed"])
@pytest.mark.parametrize("count", [1, 8, 9, 16, 17, 35])
@pytest.mark.parametrize("n_out", [0, 205])
def test_take_table_kernel_equals_plain(cuda, kind, count, n_out):
    rng = np.random.default_rng(count)
    n = 513
    cols = [c.to(cuda) for c in _table_columns(rng, n, count, kind)]
    idx = _pinned_indices(rng, n)[:n_out].to(cuda)
    launches = ttake.take_rows.launches
    got = ttake.take_table(cols, idx)
    assert ttake.take_rows.launches == launches + (-(-count // ttake.MAX_COLUMNS) if n_out else 0)
    assert len(got) == count
    for c, o in zip(cols, got):
        _assert_bits_equal(o, ttake.take_ref(c, idx))


def test_take_table_kernel_clamps_each_column_to_its_rows(cuda):
    rng = np.random.default_rng(5)
    cols = [torch.from_numpy(rng.standard_normal(shape)).to(cuda)
            for shape in ((300,), (40, 3), (7,), (1, 5))]
    idx = _pinned_indices(rng, 300).to(cuda)
    for c, o in zip(cols, ttake.take_columns(cols, idx)):
        _assert_bits_equal(o, ttake.take_ref(c, idx))


def test_take_table_kernel_on_unaligned_rows_and_outputs(cuda):
    """One column of a table a 6-byte row into its storage (only a 2-byte
    vector divides it), and one output 4 bytes into its storage (a 4-byte
    vector for that column alone); the others take 16-byte vectors."""
    rng = np.random.default_rng(6)
    n = 301
    base = torch.from_numpy(rng.standard_normal(3 * (n + 1)).astype(np.float16)).to(cuda)
    cols = [base.view(n + 1, 3)[1:], torch.from_numpy(rng.standard_normal((n, 4))).to(cuda)]
    cols += [torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32)).to(cuda)]
    idx = _pinned_indices(rng, n).to(cuda)
    for c, o in zip(cols, ttake.take_table(cols, idx)):
        _assert_bits_equal(o, ttake.take_ref(c, idx))
    raw = [c.view(torch.uint8).view(n, -1) for c in cols]
    outs = [torch.empty((idx.shape[0], r.shape[1]), dtype=torch.uint8, device=cuda) for r in raw]
    shifted = torch.empty(outs[1].numel() + 16, dtype=torch.uint8, device=cuda)
    outs[1] = shifted[4:4 + outs[1].numel()].view(outs[1].shape)
    vec = [ttake.take.vector_bytes(r.shape[1], r.data_ptr(), o.data_ptr())
           for r, o in zip(raw, outs)]
    assert vec == [2, 4, 16]
    launches = ttake.take_rows.launches
    ttake.take._gather(raw, outs, idx)
    assert ttake.take_rows.launches == launches + 1
    for r, o in zip(raw, outs):
        _assert_bits_equal(o, ttake.take_ref(r, idx))


def test_take_table_launches_once_per_max_columns(cuda):
    """Counted by the profiler, not by the wrapper: ceil(n / MAX_COLUMNS)
    kernels for n columns, none for an empty selection."""
    from torch.profiler import ProfilerActivity, profile

    k = ttake.MAX_COLUMNS
    cols = [torch.arange(100, dtype=torch.float64, device=cuda) + c for c in range(2 * k + 1)]
    idx = torch.tensor([3, -1, 200], dtype=torch.int32, device=cuda)
    for count, n_idx, want in ((1, 3, 1), (k, 3, 1), (k + 1, 3, 2), (2 * k + 1, 3, 3),
                               (k + 1, 0, 0)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ttake.take_table(cols[:count], idx[:n_idx])
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                   and ("take_narrow_kernel" in e.name or "take_wide_kernel" in e.name)]
        assert len(kernels) == want, (count, n_idx)


def test_take_table_rejects_bad_arguments_on_the_card(cuda):
    col = torch.zeros(4, device=cuda)
    idx = torch.zeros(3, dtype=torch.int32, device=cuda)
    for cols, indices in (([col, col.cpu()], idx), ([col], idx.cpu()),
                          ([col, col.view(2, 2, 1)], idx),
                          ([torch.zeros((2, 4), device=cuda).t()], idx), ([col], idx.long())):
        with pytest.raises(ValueError):
            ttake.take_table(cols, indices)
    with pytest.raises(IndexError):
        ttake.take_table([col, col[:0]], idx)


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


@pytest.mark.parametrize("train", [False, True])
def test_flash_gqa_on_the_card_counts_as_on_the_cpu_and_the_meta_device(cuda, train):
    """Under the cost counter the kernel's launch counts as its plain
    version on the same shapes (a ctypes launch is invisible to a dispatch
    mode): one ``flash_gqa`` call, and its backward, count exactly what the
    same call counts on the CPU and on the meta device, in both byte
    accountings, and the kernel ran."""
    from repro_torch.utils import cost

    def count(device):
        g = torch.Generator().manual_seed(6)
        q = torch.randn(2, 96, 8, 64, generator=g).to(device)
        k, v = (torch.randn(2, 96, 2, 64, generator=g).to(device) for _ in range(2))
        if train:
            q, k, v = (t.requires_grad_() for t in (q, k, v))
        with cost.Counter() as c:
            out = cost.fused(cost.FUSED_ATTENTION, tattn.flash_gqa, q, k, v, causal=True)
            if train:
                out.sum().backward()
        return (c.cost(), c.cost(cost.FUSED_ATTENTION_FNS), c.product_flops)

    launches = tattn.flash_attention.launches
    card = count(cuda)
    torch.cuda.synchronize()
    assert tattn.flash_attention.launches == launches + 1
    assert card == count("cpu") == count("meta")
    # the full square's products: 2 forward; with the backward, 1 recomputed, 4 of the gradient
    assert card[2] == (7 if train else 2) * 2 * 2 * 8 * 96 * 96 * 64


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



def _reduced_train_state(device):
    """Reduced granite (GQA 4:2, head dim 16) with the norm weights of the
    parameters and of their master copy set to 1 + 0.1 N(0, 1); drawn on the
    CPU from seeds and copied to ``device``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.training import OptimizerConfig, TrainConfig, init_train_state

    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(), num_kv_heads=2)
    opt = OptimizerConfig(learning_rate=1e-3, warmup_steps=1, decay_steps=10)
    state = init_train_state(cfg, TrainConfig(optimizer=opt), torch.Generator().manual_seed(0),
                             "cpu")
    g = torch.Generator().manual_seed(1)
    params = state["params"]
    for node, key in ((params["layers"], "ln1"), (params["layers"], "ln2"), (params, "final_norm")):
        node[key] = 1 + 0.1 * torch.randn(node[key].shape, generator=g)
    state["opt"]["master"] = _map(lambda t: t.clone(), params)
    return cfg, opt, _map(lambda t: t.to(device), state)


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _token_batch(cfg, shape, seed, device):
    from repro_torch.data import shift_labels

    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)
    return {"tokens": torch.from_numpy(toks).to(device),
            "labels": torch.from_numpy(shift_labels(toks)).to(device)}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def test_reduced_train_steps_on_the_card_match_the_cpu(cuda):
    """Three train steps of reduced granite with ``remat="full"`` on the
    card (the flash kernel's forward, twice per layer per step) against the
    same steps on the CPU (the plain attention): loss within 1e-4 relative,
    ``m`` and ``v`` within 1e-3 of each leaf's largest value, parameters
    within the summed learning rates (Adam's sign where a gradient is ~0)."""
    from repro_torch.training import TrainConfig, make_train_step

    results = {}
    for device in (torch.device("cpu"), cuda):
        cfg, opt, state = _reduced_train_state(device)
        step = make_train_step(cfg, TrainConfig(optimizer=opt, remat="full"))
        launches = tattn.flash_attention.launches
        metrics = []
        for i in range(3):
            state, m = step(state, _token_batch(cfg, (4, 64), seed=i, device=device))
            metrics.append({k: float(v) for k, v in m.items()})
        n = tattn.flash_attention.launches - launches
        assert n == (2 * 3 * cfg.num_layers if device.type == "cuda" else 0)
        results[device.type] = (_map(lambda t: t.cpu(), state), metrics)
    (got, gm), (want, wm) = results["cuda"], results["cpu"]
    lrs = sum(m["lr"] for m in wm)
    assert lrs > 0 and int(got["step"]) == 3
    for g, w in zip(gm, wm):
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-4) and np.isfinite(g["loss"])
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-3)
    for key in ("m", "v"):
        for (name, g), (_, w) in zip(_leaves(got["opt"][key]), _leaves(want["opt"][key])):
            assert float(w.abs().max()) > 0, name
            torch.testing.assert_close(g, w, rtol=0, atol=1e-3 * float(w.abs().max()), msg=name)
    for (name, g), (_, w) in zip(_leaves(got["params"]), _leaves(want["params"])):
        torch.testing.assert_close(g, w, rtol=0, atol=lrs, msg=name)


def test_remat_full_on_the_card_keeps_the_loss_and_lowers_the_peak(cuda):
    """One loss and gradient of reduced granite on the card with ``remat``
    none and full: the same loss and gradients (the recompute repeats the
    forward's kernels; the embedding's index backward may sum in another
    order), and a lower peak of device memory with ``full``."""
    from repro_torch.models import loss_fn

    cfg, _, state = _reduced_train_state(cuda)
    batch = _token_batch(cfg, (16, 512), seed=7, device=cuda)
    out = {}
    for remat in ("none", "full", "none"):
        leaves = {n: t.detach().clone().requires_grad_() for n, t in _leaves(state["params"])}
        tree = {}
        for name, leaf in leaves.items():
            node = tree
            *keys, last = name.split("/")
            for k in keys:
                node = node.setdefault(k, {})
            node[last] = leaf
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss = loss_fn(cfg, tree, batch, remat=remat)
        loss.backward()
        torch.cuda.synchronize()
        out[remat] = (float(loss.detach()), {n: t.grad for n, t in leaves.items()},
                      torch.cuda.max_memory_allocated() - base)
    (loss_none, grads_none, peak_none), (loss_full, grads_full, peak_full) = \
        out["none"], out["full"]
    assert loss_full == pytest.approx(loss_none, rel=1e-6)
    for name, w in grads_none.items():
        torch.testing.assert_close(grads_full[name], w, rtol=0,
                                   atol=1e-5 * float(w.abs().max()), msg=name)
    assert peak_full < peak_none, (peak_full, peak_none)


# ------------------------------------------------- the qos gateway, compression

def _token_gateway():
    from repro_torch.cluster import ClusterCoordinator
    from repro_torch.core import Fabric, ThallusServer
    from repro_torch.data import make_token_table
    from repro_torch.engine import Engine
    from repro_torch.qos import ScanGateway
    from repro_torch.sched import AdaptiveScheduler, TicketTable

    table = make_token_table("tok", num_seqs=12, seq_len=24, vocab_size=128, seqs_per_batch=4)
    coord = ClusterCoordinator()
    for i in range(2):
        eng = Engine()
        eng.register("/tok", table)
        coord.add_server(f"s{i}", ThallusServer(eng, Fabric()))
    coord.place_replicas("/tok", table)
    return ScanGateway(coord, scheduler=AdaptiveScheduler(tickets=TicketTable()),
                       modeled_service=True)


def test_reduced_granite_serves_gateway_prompts_on_the_card_as_on_the_cpu(cuda):
    """Two batchers fetch one prompt table through one gateway scan (one
    fetch shared) and serve it with reduced granite on the card and on the
    CPU: the same completions, token for token."""
    from repro_torch.models import decode, prefill
    from repro_torch.serving import Batcher

    got = {}
    for device in (torch.device("cpu"), cuda):
        cfg, _, state = _reduced_train_state(device)
        params = state["params"]
        gateway = _token_gateway()
        batchers = [Batcher(lambda t: prefill(cfg, params, {"tokens": t}),
                            lambda c, t, p: decode(cfg, params, c, t, p), batch_size=5,
                            device=device) for _ in range(2)]
        reqs = [b.submit_scan(gateway, "SELECT seq_id, tokens FROM tok", "/tok")
                for b in batchers]
        gateway.run()
        fetched = [b.ingest_scan(gateway, r, seq_len=24, max_new_tokens=5)
                   for b, r in zip(batchers, reqs)]
        assert fetched == [(12, False), (12, True)]
        launches = tattn.flash_attention.launches
        done = [[(c.request_id, c.tokens) for c in b.run()] for b in batchers]
        assert tattn.flash_attention.launches - launches == \
            (2 * 3 * cfg.num_layers if device.type == "cuda" else 0)
        assert done[0] == done[1]
        got[device.type] = done[0]
    assert got["cuda"] == got["cpu"]
    assert len({t for _, toks in got["cpu"] for t in toks}) > 1


@pytest.mark.parametrize("shape", [(1,), (1000,), (40, 257, 33), (3, 1 << 20)])
def test_compress_decompress_on_the_card_equals_the_cpu(cuda, shape):
    """``quantize_int8``, ``compress_decompress`` and the in-place pass on
    the card equal the CPU's bit for bit, exact .5 ties (half to even) and
    an all-zero leaf included."""
    from repro_torch.training.compression import (compress_decompress, compress_decompress_,
                                                  quantize_int8)

    gen = torch.Generator().manual_seed(len(shape))
    g = torch.randn(shape, generator=gen) * 1e-3
    ef = torch.randn(shape, generator=gen) * 1e-5
    ties = torch.tensor([127, 0.5, 1.5, -2.5, 126.5, -0.5]) * 2.0 ** -10
    for x in (g, ties, torch.zeros(shape)):
        for got, want in zip(quantize_int8(x.to(cuda)), quantize_int8(x)):
            _assert_bits_equal(got.cpu(), want)
    assert quantize_int8(ties.to(cuda))[0].tolist() == [127, 0, 2, -2, 126, 0]
    want_deq, want_ef = compress_decompress(g, ef)
    for got, want in zip(compress_decompress(g.to(cuda), ef.to(cuda)), (want_deq, want_ef)):
        _assert_bits_equal(got.cpu(), want)
    cg, cef = g.to(cuda), ef.to(cuda)
    out = compress_decompress_(cg, cef)
    assert out.data_ptr() == cg.data_ptr()
    _assert_bits_equal(out.cpu(), want_deq)
    _assert_bits_equal(cef.cpu(), want_ef)


def test_reduced_compressed_train_steps_on_the_card_match_the_cpu(cuda):
    """Three train steps of reduced granite with ``compress_dp_grads=True`` on
    the card against the same on the CPU, held as
    ``tests/test_torch_compression.py`` holds the port to JAX: loss within
    1e-4 relative, parameters within the summed learning rates; ``ef``, ``m``
    and ``v`` on all but 1 % of each leaf within the train tolerances
    (``1e-4 x 127 x`` the int8 step, ``1e-3`` of the leaf's largest value),
    where the two devices' gradients straddle a rounding boundary of the
    int8 grid, within 1.1 int8 steps."""
    from repro_torch.training import TrainConfig, init_error_feedback, make_train_step

    results = {}
    for device in (torch.device("cpu"), cuda):
        cfg, opt, state = _reduced_train_state(device)
        state["ef"] = init_error_feedback(state["params"])
        step = make_train_step(cfg, TrainConfig(optimizer=opt, remat="none",
                                                compress_dp_grads=True))
        metrics = []
        for i in range(3):
            state, m = step(state, _token_batch(cfg, (4, 64), seed=i, device=device))
            metrics.append({k: float(v) for k, v in m.items()})
        results[device.type] = (_map(lambda t: t.cpu(), state), metrics)
    (got, gm), (want, wm) = results["cuda"], results["cpu"]
    lrs = sum(m["lr"] for m in wm)
    assert lrs > 0 and int(got["step"]) == 3
    for g, w in zip(gm, wm):
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-4) and np.isfinite(g["loss"])
    for (name, g), (_, w) in zip(_leaves(got["params"]), _leaves(want["params"])):
        torch.testing.assert_close(g, w, rtol=0, atol=lrs, msg=name)
    for (name, g), (_, w) in zip(_leaves(got["ef"]), _leaves(want["ef"])):
        step = 2 * float(w.abs().max())
        assert step > 0, name
        d = (g - w).abs()
        assert float((d > 1e-4 * 127 * step).float().mean()) <= 0.01, name
        assert float(d.max()) <= 1.1 * step, name
    for key in ("m", "v"):
        for (name, g), (_, w) in zip(_leaves(got["opt"][key]), _leaves(want["opt"][key])):
            scale = float(w.abs().max())
            assert scale > 0, name
            assert float(((g - w).abs() > 1e-3 * scale).float().mean()) <= 0.01, name


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


def _perturbed_family_params(cfg, device):
    """``cfg``'s params drawn on the CPU (seed 0) with every norm weight
    (``q_norm``/``k_norm``, an SSM's ``ln`` and gated ``norm``, the hybrid's
    shared ``ln1``/``ln2`` too) set to 1 + 0.1 N(0, 1) (seed 1), on
    ``device``."""
    from repro_torch.models import init_params

    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    for node, key in _norm_nodes(params):
        node[key] = 1 + 0.1 * torch.randn(node[key].shape, generator=g)
    return _map(lambda t: t.to(device), params)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "gemma-2b"])
def test_reduced_family_prefill_through_the_kernel_matches_the_cpu(cuda, arch, monkeypatch):
    """Reduced olmoe (MoE, qk-norm, head dim 16) and reduced gemma (MQA,
    GeGLU, zero-centred norms, ``embed_scale``): prefill on the card, its
    attention in the kernel (one launch per layer), against the same prefill
    on the CPU through the plain attention. An MoE layer's routing must be
    the CPU's, token for token (no two experts tie at this size)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe, prefill

    cfg = get_config(arch).reduced()
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (3, 45)).astype(np.int32))
    routes = []
    route = moe.route
    monkeypatch.setattr(moe, "route", lambda *a: routes.append(route(*a)) or routes[-1])
    out = {}
    for dev in (cuda, torch.device("cpu")):
        launches = tattn.flash_attention.launches
        out[dev.type] = prefill(cfg, _perturbed_family_params(cfg, dev),
                                {"tokens": tokens.to(dev)})
        assert tattn.flash_attention.launches == launches + (cfg.num_layers if dev == cuda else 0)
    (logits, cache), (want_logits, want_cache) = out["cuda"], out["cpu"]
    assert want_logits[..., :cfg.vocab_size].std() > 0.1
    torch.testing.assert_close(logits.cpu(), want_logits, **ATT_TOL)
    for name in ("k", "v"):
        torch.testing.assert_close(cache[name].cpu(), want_cache[name], **ATT_TOL)
    if cfg.moe is not None:
        assert len(routes) == 2 * cfg.num_layers
        for a, b in zip(routes[:cfg.num_layers], routes[cfg.num_layers:]):
            assert torch.equal(a.gate_ids.cpu(), b.gate_ids) and torch.equal(a.keep.cpu(), b.keep)
    else:
        assert not routes


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "gemma-2b"])
def test_launchers_run_the_family_on_the_card(cuda, arch, tmp_path, capsys):
    """``python -m repro_torch.launch.serve`` and ``.train`` at the reduced
    ``arch`` on the card (their default device): prefill attention in the
    kernel, finite losses, a checkpoint."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train

    launches = tattn.flash_attention.launches
    launch_serve.main(["--arch", arch, "--reduced"])
    out = capsys.readouterr().out
    assert "served 8 requests, 64 tokens" in out and "on cuda" in out, out
    assert tattn.flash_attention.launches > launches
    history = launch_train.main(["--arch", arch, "--reduced", "--steps", "2", "--log-every", "1",
                                 "--batch-seqs", "4", "--seq-len", "16", "--num-seqs", "32",
                                 "--ckpt-dir", str(tmp_path)])
    assert [h["step"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert (tmp_path / arch / "ckpt_00000002.thallus").exists()


def _ssd_inputs(device, S, B=2, H=8, P=64, N=128, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, S, H, P, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g))
    A = -torch.exp(torch.linspace(0.0, math.log(16.0), H))
    Bm, Cm = torch.randn(B, S, 1, N, generator=g), torch.randn(B, S, 1, N, generator=g)
    D = torch.randn(H, generator=g)
    return [t.to(device) for t in (x, dt, A, Bm, Cm, D)]


@pytest.mark.parametrize("chunk", [256, 1])
def test_ssd_chunked_on_the_card_matches_the_cpu(cuda, chunk):
    """The SSD scan (plain torch, no kernel of its own) at 512 positions:
    Q 256 (two chunks) and Q 1 (512 steps of the recurrence), on the card
    against the CPU, output and final state within ``1e-4`` of the largest
    CPU value (float32 in other summation orders)."""
    from repro_torch.models import mamba2

    out = {}
    for dev in (cuda, torch.device("cpu")):
        y, state = mamba2.ssd_chunked(*_ssd_inputs(dev, 512), chunk, return_final_state=True)
        out[dev.type] = (y.cpu(), state.cpu())
    for got, want in zip(out["cuda"], out["cpu"]):
        scale = float(want.abs().max())
        assert scale > 1.0
        assert float((got - want).abs().max()) <= 1e-4 * scale


def test_reduced_zamba2_prefill_through_the_kernel_matches_the_plain_attention(cuda, monkeypatch):
    """zamba2-1.2b reduced on the card: its shared block's prefill attention
    in the kernel (one launch per shared-block call), against the same
    prefill with ``transformer.flash_gqa`` swapped for ``flash_gqa_ref``
    (no launch) and against the CPU; logits and every cache leaf."""
    from repro_torch.configs import get_config
    from repro_torch.models import hybrid, prefill, transformer

    cfg = get_config("zamba2-1.2b").reduced()
    groups = hybrid.hybrid_structure(cfg)[0]
    assert groups == 1
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (3, 40)).astype(np.int32))
    params = _perturbed_family_params(cfg, cuda)
    launches = tattn.flash_attention.launches
    logits, cache = prefill(cfg, params, {"tokens": tokens.to(cuda)})
    assert tattn.flash_attention.launches == launches + groups
    with monkeypatch.context() as m:
        m.setattr(transformer, "flash_gqa", tattn.flash_gqa_ref)
        plain_logits, plain_cache = prefill(cfg, params, {"tokens": tokens.to(cuda)})
    assert tattn.flash_attention.launches == launches + groups
    cpu_logits, cpu_cache = prefill(cfg, _perturbed_family_params(cfg, "cpu"),
                                    {"tokens": tokens})
    assert cpu_logits[..., :cfg.vocab_size].std() > 0.1
    assert sorted(cache) == ["conv", "k", "state", "v"]
    for want_logits, want_cache in ((plain_logits.cpu(), plain_cache), (cpu_logits, cpu_cache)):
        torch.testing.assert_close(logits.cpu(), want_logits, **ATT_TOL)
        for name in cache:
            torch.testing.assert_close(cache[name].cpu(), want_cache[name].cpu(), **ATT_TOL)


def _perturbed_whisper_params(cfg, device):
    """whisper's params drawn on the CPU (seed 0) with every layer norm's
    ``w`` set to 1 + 0.1 N(0, 1) and ``b`` to 0.1 N(0, 1) (seed 1), on
    ``device``."""
    from repro_torch.models import encdec, init_params

    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    for node in encdec.layer_norm_nodes(params):
        node["w"] = 1 + 0.1 * torch.randn(node["w"].shape, generator=g)
        node["b"] = 0.1 * torch.randn(node["b"].shape, generator=g)
    return _map(lambda t: t.to(device), params)


def test_reduced_whisper_on_the_card_matches_the_cpu(cuda):
    """whisper-small reduced on the card: prefill with the encoder's
    self-attention (non-causal), the decoder's (causal) and its
    cross-attention (non-causal, 40 queries over 24 frames) in the kernel,
    ``Le + 2 Ld`` launches (3 x 12 = 36 at full size); a decode step, which
    launches nothing; the loss (``remat="full"``). Each against the same on
    the CPU (the plain attention)."""
    from repro_torch.configs import get_config
    from repro_torch.data import shift_labels
    from repro_torch.models import decode, loss_fn, prefill

    cfg = get_config("whisper-small").reduced()
    g = torch.Generator().manual_seed(2)
    frames = torch.randn(3, cfg.encdec.encoder_seq, cfg.d_model, generator=g)
    tokens = torch.randint(0, cfg.vocab_size, (3, 40), generator=g)
    labels = torch.from_numpy(shift_labels(tokens.numpy()))
    per_prefill = cfg.encdec.num_encoder_layers + 2 * cfg.num_layers
    out = {}
    for dev in (cuda, torch.device("cpu")):
        params = _perturbed_whisper_params(cfg, dev)
        launches = tattn.flash_attention.launches
        logits, cache = prefill(cfg, params, {"frames": frames.to(dev), "tokens": tokens.to(dev)})
        assert tattn.flash_attention.launches == launches + (per_prefill if dev == cuda else 0)
        grown = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 1)) if k.startswith("self") else v
                 for k, v in cache.items()}
        launches = tattn.flash_attention.launches
        step, _ = decode(cfg, params, grown, tokens[:, :1].to(dev), 40)
        assert tattn.flash_attention.launches == launches
        loss = loss_fn(cfg, params, {"frames": frames.to(dev), "tokens": tokens.to(dev),
                                     "labels": labels.to(dev)})
        out[dev.type] = (logits.cpu(), {k: v.cpu() for k, v in cache.items()}, step.cpu(),
                         float(loss))
    (logits, cache, step, loss), (want_logits, want_cache, want_step, want_loss) = \
        out["cuda"], out["cpu"]
    assert want_logits[..., :cfg.vocab_size].std() > 0.1
    torch.testing.assert_close(logits, want_logits, **ATT_TOL)
    torch.testing.assert_close(step, want_step, **ATT_TOL)
    assert sorted(cache) == ["cross_k", "cross_v", "self_k", "self_v"]
    for name in cache:
        torch.testing.assert_close(cache[name], want_cache[name], **ATT_TOL)
    assert loss == pytest.approx(want_loss, rel=1e-5)


# ---------------------------------------------------------------- mesh

@pytest.fixture
def nccl_mesh(cuda):
    """A one-rank NCCL group from an in-process store and its
    ``make_host_mesh()`` (1, 1), torn down after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        yield make_host_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("heads,kv,hd,causal", [(8, 2, 64, True), (4, 4, 128, False),
                                                 (3, 1, 16, True)])
def test_flash_through_local_map_on_a_mesh_matches_the_plain_attention(nccl_mesh, heads, kv,
                                                                       hd, causal):
    """``sharded_attention`` on DTensors (batch rows and heads placed by the
    rules) launches the kernel once on the rank's shard, and its output
    equals the kernel on the plain tensors bit for bit and the plain
    attention within the kernel tests' tolerance."""
    import dataclasses

    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.models import sharding as sh
    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(), num_heads=heads,
                              num_kv_heads=kv, head_dim=hd)
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((2, 70, h, hd), generator=g, device="cuda")
               for h in (heads, kv, kv))
    rules = sh.make_rules(cfg, nccl_mesh)
    with sh.mesh_context(nccl_mesh, rules):
        dq = sh.from_full(q, nccl_mesh, sh.spec_of(("batch", None, "heads", None), rules,
                                                     q.shape, nccl_mesh), q.device)
        dk, dv = (sh.from_full(t, nccl_mesh, sh.spec_of(("batch", None, "kv", None), rules,
                                                         t.shape, nccl_mesh), t.device)
                  for t in (k, v))
        launches = tattn.flash_attention.launches
        out = sh.sharded_attention(tattn.flash_gqa, dq, dk, dv, causal=causal)
        assert tattn.flash_attention.launches == launches + 1
    assert isinstance(out, DTensor)
    got = out.full_tensor()
    assert torch.equal(got, tattn.flash_gqa(q, k, v, causal=causal))
    torch.testing.assert_close(got, tattn.flash_gqa_ref(q, k, v, causal=causal),
                               rtol=1e-4, atol=1e-4)


def test_reduced_granite_on_a_one_rank_mesh_serves_as_plain_tensors(nccl_mesh):
    """The serve launcher's function on DTensors under the (1, 1) mesh: the
    plain run's tokens, one flash launch per layer per cohort."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests, serve
    from repro_torch.models import init_params
    cfg = get_config("granite-3-2b").reduced()
    g = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, g, device="cuda")
    for key in ("ln1", "ln2"):
        params["layers"][key] = 1.0 + 0.1 * torch.randn(params["layers"][key].shape,
                                                        generator=g, device="cuda")
    params["final_norm"] = 1.0 + 0.1 * torch.randn((cfg.d_model,), generator=g, device="cuda")
    reqs = make_requests(cfg, 8, 12, 6)
    plain = serve(cfg, params, reqs, 4, "cuda")
    launches = tattn.flash_attention.launches
    sharded = serve(cfg, params, reqs, 4, "cuda", mesh=nccl_mesh)
    assert tattn.flash_attention.launches - launches == 2 * cfg.num_layers
    assert [c.tokens for c in sharded.completions] == [c.tokens for c in plain.completions]
