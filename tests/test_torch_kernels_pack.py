"""Port vs JAX package: segment pack/unpack (repro_torch.kernels.pack).

Inputs come from a seeded numpy generator and go through the JAX functions
(Pallas in interpret mode) and the port's on the CPU, where the port's
wrappers take their plain PyTorch versions. Data movement is compared bit
for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.pack as jpack
import repro_torch.kernels.pack as tpack
from repro_torch.kernels import _build

DTYPES = (np.float32, np.int32, np.int64, np.uint8, np.float16, np.float64)
SIZES = [[1], [4096], [4096, 4096], [1, 5000, 17], [0, 100], [8192, 64, 3, 4097]]


def _segments(seed, dtype, sizes):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * 100).astype(dtype) for n in sizes]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sizes", SIZES)
def test_pack_segments_bytes_equal_jax(dtype, sizes):
    segs = _segments(0, dtype, sizes)
    want, want_lens = jpack.pack_segments(segs)
    got, lens = tpack.pack_segments(segs, device="cpu")
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert lens == want_lens
    assert got.numel() == tpack.packed_nbytes(lens) == jpack.packed_nbytes(lens)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sizes", SIZES)
def test_unpack_segments_round_trip(dtype, sizes):
    segs = _segments(1, dtype, sizes)
    packed, lens = tpack.pack_segments([torch.from_numpy(s) for s in segs])
    outs = tpack.unpack_segments(packed, lens)
    jouts = jpack.unpack_segments(jnp.asarray(packed.numpy()), lens)
    for s, o, j in zip(segs, outs, jouts):
        assert o.dtype == torch.uint8 and o.device == packed.device
        np.testing.assert_array_equal(o.numpy(), s.view(np.uint8).reshape(-1))
        np.testing.assert_array_equal(o.numpy(), j)


@pytest.mark.parametrize("sizes", SIZES)
def test_layout_helpers_equal_jax(sizes):
    segs = _segments(2, np.float32, sizes)
    lens = [s.nbytes for s in segs]
    for got, want in zip(tpack.layout_segments(lens), jpack.layout_segments(lens)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tpack.routing(lens), jpack.routing(lens)):
        np.testing.assert_array_equal(got, want)
    max_tiles = max(tpack.tiles_for(n) for n in lens)
    np.testing.assert_array_equal(tpack.inverse_routing(lens, max_tiles),
                                  jpack.inverse_routing(lens, max_tiles))
    staged, seg_lens = tpack.stage_segments([torch.from_numpy(s) for s in segs])
    jstaged, jlens = jpack.stage_segments(segs)
    np.testing.assert_array_equal(staged.numpy(), jstaged)
    np.testing.assert_array_equal(seg_lens, jlens)


def test_tiles_for_equal_jax():
    for n in (0, 1, 4095, 4096, 4097, 1 << 21):
        assert tpack.tiles_for(n) == jpack.tiles_for(n)
    assert tpack.tiles_for(0) == 1


@pytest.mark.parametrize("sizes", [[100, 9000, 1], [0, 4096, 8193], [1 << 15] * 3])
def test_plain_versions_equal_jax(sizes):
    rng = np.random.default_rng(3)
    segs = [rng.integers(0, 255, n).astype(np.uint8) for n in sizes]
    staged, lens = jpack.stage_segments(segs)
    seg_ids, tile_ids, _ = jpack.layout_segments([int(x) for x in lens])
    t_staged = torch.from_numpy(staged)
    t_sid, t_tid = torch.from_numpy(seg_ids), torch.from_numpy(tile_ids)
    want = np.array(jpack.pack_ref(jnp.asarray(staged), jnp.asarray(seg_ids),
                                    jnp.asarray(tile_ids)))
    np.testing.assert_array_equal(tpack.pack_ref(t_staged, t_sid, t_tid).numpy(), want)
    np.testing.assert_array_equal(tpack.pack_tiles(t_staged, t_sid, t_tid).numpy(), want)

    n_seg, max_tiles = staged.shape[:2]
    jwant = np.asarray(jpack.unpack_ref(jnp.asarray(want), jnp.asarray(seg_ids),
                                        jnp.asarray(tile_ids), n_seg, max_tiles))
    got = tpack.unpack_ref(torch.from_numpy(want), t_sid, t_tid, n_seg, max_tiles)
    np.testing.assert_array_equal(got.numpy(), jwant)

    padded = np.concatenate([want, np.zeros_like(want[:1])])
    inv = tpack.inverse_routing([int(x) for x in lens], max_tiles)
    jgot = np.asarray(jpack.unpack_tiles(jnp.asarray(padded), jnp.asarray(inv),
                                         n_seg=n_seg, max_tiles=max_tiles))
    tgot = tpack.unpack_tiles(torch.from_numpy(padded), torch.from_numpy(inv),
                              n_seg=n_seg, max_tiles=max_tiles)
    np.testing.assert_array_equal(tgot.numpy(), jgot)
    np.testing.assert_array_equal(jgot, jwant)
    np.testing.assert_array_equal(
        tpack.unpack_gather_ref(torch.from_numpy(padded), torch.from_numpy(inv),
                                n_seg, max_tiles).numpy(), jwant)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    segs = [torch.arange(5000, dtype=torch.int32), torch.ones(7, dtype=torch.float64)]
    before = (tpack.pack_tiles.launches, tpack.unpack_tiles.launches)
    packed, lens = tpack.pack_segments(segs)
    tpack.unpack_segments(packed, lens)
    assert (tpack.pack_tiles.launches, tpack.unpack_tiles.launches) == before
    assert _build.on_cuda(packed) is False
    with pytest.raises(ValueError, match="no kernel for device"):
        _build.on_cuda(torch.empty(1, device="meta"))


@pytest.mark.parametrize("case", ["dtype", "shape", "strided", "ids_dtype", "ids_len"])
def test_pack_tiles_rejects_bad_arguments(case):
    src = torch.zeros((2, 3, 32, 128), dtype=torch.uint8)
    sid = torch.zeros(4, dtype=torch.int32)
    tid = torch.zeros(4, dtype=torch.int32)
    if case == "dtype":
        src = src.to(torch.int16)
    elif case == "shape":
        src = src[..., :64]
    elif case == "strided":
        src = src.transpose(0, 1)
    elif case == "ids_dtype":
        sid = sid.long()
    else:
        tid = tid[:3]
    with pytest.raises(ValueError):
        tpack.pack_tiles(src, sid, tid)


def test_unpack_tiles_rejects_wrong_id_count():
    packed = torch.zeros((3, 32, 128), dtype=torch.uint8)
    with pytest.raises(ValueError, match="gather ids"):
        tpack.unpack_tiles(packed, torch.zeros(5, dtype=torch.int32), n_seg=2, max_tiles=2)
