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
