"""Port vs JAX package: selection take (one column and a table of columns)
and validity expand (repro_torch.kernels.take).

Inputs come from a seeded numpy generator and go through the JAX functions
(Pallas in interpret mode) and the port's on the CPU, where the port's
wrappers take their plain PyTorch versions. Results are compared bit for
bit. The index rule is the JAX reference's: a negative index wraps once,
then the index is clamped to [0, n - 1].
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.take as jtake
import repro_torch.kernels.take as ttake
from repro_torch.kernels.take.take import vector_bytes


def _indices(rng, n, count=97):
    edge = [-1, -n, -(n + 2), n, n + 2, 0, n - 1]
    return np.concatenate([rng.integers(0, n, count), edge]).astype(np.int32)


def _wrapped_clamped(idx, n):
    return np.clip(np.where(idx < 0, idx + n, idx), 0, n - 1)


@pytest.mark.parametrize("dtype", (np.float32, np.int32, np.float16))
@pytest.mark.parametrize("shape", [(64, 1), (130, 7), (512, 128), (300, 200)])
def test_take_column_equals_jax(dtype, shape):
    rng = np.random.default_rng(0)
    vals = (rng.standard_normal(shape) * 10).astype(dtype)
    idx = _indices(rng, shape[0])
    want = np.asarray(jtake.take_column(vals, idx))
    got = ttake.take_column(torch.from_numpy(vals), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jtake.take_ref(jnp.asarray(vals), jnp.asarray(idx))), want)
    np.testing.assert_array_equal(got.numpy(), vals[_wrapped_clamped(idx, shape[0])])


@pytest.mark.parametrize("dtype", (np.int64, np.float64))
@pytest.mark.parametrize("shape", [(777,), (64, 1), (130, 3), (300, 200)])
def test_take_column_64bit_equals_numpy(dtype, shape):
    # JAX without x64 truncates 64-bit values, so numpy is the reference here.
    rng = np.random.default_rng(1)
    vals = (rng.standard_normal(shape) * 1e12).astype(dtype)
    idx = _indices(rng, shape[0], 33)
    got = ttake.take_column(torch.from_numpy(vals), idx)
    np.testing.assert_array_equal(got.numpy(), vals[_wrapped_clamped(idx, shape[0])])


def test_take_1d_equals_jax():
    rng = np.random.default_rng(2)
    vals = rng.integers(-5, 5, 777).astype(np.int32)
    idx = _indices(rng, 777, 33)
    got = ttake.take_column(torch.from_numpy(vals), torch.from_numpy(idx))
    assert got.shape == (idx.size,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtake.take_column(vals, idx)))


def test_index_rule_pinned():
    vals = torch.arange(10, dtype=torch.float32)
    idx = torch.tensor([-1, -10, -11, -12, 10, 12, 0, 9], dtype=torch.int32)
    want = [9, 0, 0, 0, 9, 9, 0, 9]
    assert ttake.take_column(vals, idx).tolist() == want
    assert np.asarray(jtake.take_column(vals.numpy(), idx.numpy())).tolist() == want


def _table(case):
    """(columns, indices) for a take_columns case: numpy columns of mixed
    dtypes and 1-D/2-D shapes, made from a numpy seed."""
    rng = np.random.default_rng(3)
    n = 150
    specs = [(np.float32, (n,)), (np.int32, (n, 3)), (np.float16, (n, 128)),
             (np.int8, (n,)), (np.uint8, (n, 200)), (np.float64, (n,)), (np.int64, (n, 2))]
    if case == "over_k":
        specs = [specs[k % 4] for k in range(2 * ttake.MAX_COLUMNS + 3)]
    if case == "own_rows":  # each column clamps against its own rows
        specs = [(np.float32, (n,)), (np.int32, (40, 3)), (np.float64, (7,)), (np.uint8, (1, 5))]
    cols = [(rng.standard_normal(shape) * 100).astype(dtype) for dtype, shape in specs]
    if case == "empty_selection":
        idx = np.zeros(0, np.int32)
    elif case == "pinned":
        idx = np.array([-1, -n, -(n + 2), n, n + 2, 0, n - 1], np.int32)
    else:
        idx = _indices(rng, n, 60)
    return cols, idx


def _jax_take(vals, idx):
    """The JAX package's take of one column: the Pallas kernel in interpret
    mode (its plain take_ref for an empty selection, which the kernel's grid
    does not take). JAX without x64 truncates 64-bit values, so numpy is the
    reference for those."""
    if vals.dtype.itemsize == 8:
        return vals[_wrapped_clamped(idx, vals.shape[0])]
    if idx.size == 0:
        return np.asarray(jtake.take_ref(jnp.asarray(vals), jnp.asarray(idx)))
    return np.asarray(jtake.take_column(vals, idx))


@pytest.mark.parametrize("case", ["list", "dict", "empty_selection", "pinned", "over_k",
                                  "own_rows"])
def test_take_columns_equals_jax(case):
    cols, idx = _table(case)
    if case == "dict":
        got = ttake.take_columns({f"c{k}": torch.from_numpy(c) for k, c in enumerate(cols)},
                                 torch.from_numpy(idx.astype(np.int64)))
        assert list(got) == [f"c{k}" for k in range(len(cols))]
        got = list(got.values())
    else:
        got = ttake.take_columns([torch.from_numpy(c) for c in cols], idx)
        assert isinstance(got, list)
    assert len(got) == len(cols)
    for vals, out in zip(cols, got):
        want = _jax_take(vals, idx)
        assert out.dtype == torch.from_numpy(vals).dtype and out.shape == want.shape
        np.testing.assert_array_equal(out.numpy(), want)
        np.testing.assert_array_equal(out.numpy(), vals[_wrapped_clamped(idx, vals.shape[0])])
        np.testing.assert_array_equal(
            out.numpy(), ttake.take_column(torch.from_numpy(vals), idx).numpy())


def test_take_columns_of_nothing():
    idx = torch.zeros(3, dtype=torch.int32)
    assert ttake.take_columns([], idx) == [] and ttake.take_columns({}, idx) == {}


@pytest.mark.parametrize("n", [1, 8, 100, 1024, 4096, 10000])
def test_expand_validity_equals_jax(n):
    rng = np.random.default_rng(n)
    mask = rng.integers(0, 2, n).astype(bool)
    bm = np.packbits(mask, bitorder="little")
    got = ttake.expand_validity(torch.from_numpy(bm), n)
    assert got.dtype == torch.bool and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtake.expand_validity(bm, n)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jtake.bitmap_expand_ref(jnp.asarray(bm), n)))
    np.testing.assert_array_equal(got.numpy(), mask)


def test_bitmap_expand_is_lsb_first():
    bm = torch.tensor([0b00000001, 0b10000000, 0xFF, 0], dtype=torch.uint8)
    got = ttake.bitmap_expand(bm)
    assert got.shape == (32,)
    assert got.tolist() == ([True] + [False] * 7 + [False] * 7 + [True]
                            + [True] * 8 + [False] * 8)


def test_expand_validity_rejects_short_bitmap():
    with pytest.raises(ValueError, match="fewer than"):
        ttake.expand_validity(torch.zeros(2, dtype=torch.uint8), 17)


@pytest.mark.parametrize("row_bytes, ptrs, want", [
    (8, (256, 512), 8), (16, (256, 512), 16), (512, (0, 0), 16), (12, (0, 0), 4),
    (2, (0, 0), 2), (3, (0, 0), 1), (1600, (8, 0), 8), (16, (4, 0), 4),
])
def test_vector_width_divides_row_and_addresses(row_bytes, ptrs, want):
    assert vector_bytes(row_bytes, *ptrs) == want


@pytest.mark.parametrize("case", ["1d", "idx_dtype", "idx_2d", "empty_source"])
def test_take_rows_rejects_bad_arguments(case):
    vals = torch.zeros((4, 2))
    idx = torch.zeros(3, dtype=torch.int32)
    err = ValueError
    if case == "1d":
        vals = vals[:, 0]
    elif case == "idx_dtype":
        idx = idx.long()
    elif case == "idx_2d":
        idx = idx[:, None]
    else:
        vals, err = vals[:0], IndexError
    with pytest.raises(err):
        ttake.take_rows(vals, idx)


@pytest.mark.parametrize("case", ["two_devices", "non_contiguous", "3d", "empty_source",
                                  "idx_dtype"])
def test_take_table_rejects_bad_arguments(case):
    cols = [torch.zeros(4), torch.zeros((4, 2), dtype=torch.int16)]
    idx = torch.zeros(3, dtype=torch.int32)
    err = ValueError
    if case == "two_devices":
        cols.append(torch.zeros(4, device="meta"))
    elif case == "non_contiguous":
        cols.append(torch.zeros((2, 4)).t())
    elif case == "3d":
        cols.append(torch.zeros((4, 2, 2)))
    elif case == "empty_source":
        cols, err = cols + [torch.zeros(0)], IndexError
    else:
        idx = idx.long()
    with pytest.raises(err):
        ttake.take_table(cols, idx)
    if case in ("two_devices", "3d", "empty_source"):
        # take_columns makes columns contiguous and casts indices first
        with pytest.raises(err):
            ttake.take_columns(cols, idx)


def test_cpu_tensors_count_no_launch():
    before = (ttake.take_rows.launches, ttake.bitmap_expand.launches)
    ttake.take_column(torch.arange(5.0), torch.tensor([1, -1], dtype=torch.int32))
    ttake.take_columns({"a": torch.arange(5.0), "b": torch.ones((5, 3))}, np.array([0, 7]))
    ttake.take_table([torch.arange(5.0)] * (ttake.MAX_COLUMNS + 1),
                     torch.tensor([4], dtype=torch.int32))
    ttake.expand_validity(torch.tensor([5], dtype=torch.uint8), 3)
    assert (ttake.take_rows.launches, ttake.bitmap_expand.launches) == before
