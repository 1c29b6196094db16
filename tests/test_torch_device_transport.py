"""Port vs JAX package: device landing (repro_torch.core.device_transport).

Both landings run with ``device="cpu"``. They are compared with each other,
with the JAX ``batch_to_device`` for 32-bit columns (as
tests/test_sharding.py's parity test does) and, for 64-bit columns, which
JAX without x64 truncates, with the host ``RecordBatch``.
"""
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.device_transport import batch_to_device as jax_batch_to_device
import repro_torch.core as tcore
from repro_torch.core.device_transport import (DeviceBatch, batch_to_device,
                                               batch_to_device_packed)
from repro_torch.device import default_device

LANDINGS = [batch_to_device, batch_to_device_packed]


def _numeric_batch(seed, types, n=256):
    rng = np.random.default_rng(seed)
    sch = tcore.schema(*[(f"c{i}", t) for i, t in enumerate(types)])
    arrays = [(rng.standard_normal(n) * 1000).astype(t) for t in types]
    return tcore.batch_from_arrays(sch, arrays), arrays


@pytest.mark.parametrize("land", LANDINGS)
def test_32bit_columns_equal_jax(land):
    batch, arrays = _numeric_batch(0, ["float32", "int32"])
    jbatch = jcore.batch_from_arrays(jcore.schema(("c0", "float32"), ("c1", "int32")), arrays)
    want = jax_batch_to_device(jbatch)
    got = land(batch, device="cpu")
    assert isinstance(got, DeviceBatch) and got.num_rows == 256
    for name in ("c0", "c1"):
        assert got[name].device.type == "cpu"
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


@pytest.mark.parametrize("land", LANDINGS)
@pytest.mark.parametrize("types", [["float64", "int64"], ["float16", "uint8", "bool"],
                                   ["int8", "int16", "uint16", "uint32", "uint64"]])
def test_columns_equal_host_batch(land, types):
    batch, arrays = _numeric_batch(1, types, n=257)
    got = land(batch, device="cpu")
    for i, a in enumerate(arrays):
        t = got[f"c{i}"]
        assert t.shape == a.shape
        np.testing.assert_array_equal(t.numpy().view(np.uint8), a.view(np.uint8))
    assert got.validity == {}


def test_landings_agree_and_carry_validity():
    sch = tcore.schema(("id", "int64"), ("val", "float64"), ("flag", "bool"))
    batch = tcore.batch_from_pydict(sch, {
        "id": list(range(21)),
        "val": [None if i % 4 == 0 else i / 3 for i in range(21)],
        "flag": [i % 3 == 0 for i in range(21)],
    })
    a = batch_to_device(batch, device="cpu")
    b = batch_to_device_packed(batch, device="cpu")
    for name in ("id", "val", "flag"):
        assert a[name].dtype == b[name].dtype
        assert torch.equal(a[name], b[name])
    assert set(a.validity) == set(b.validity) == {"val"}
    assert torch.equal(a.validity["val"], b.validity["val"])
    np.testing.assert_array_equal(a.validity["val"].numpy(), batch.column("val").validity)


@pytest.mark.parametrize("land", LANDINGS)
def test_varlen_column_is_refused(land):
    sch = tcore.schema(("id", "int32"), ("tag", "utf8"))
    batch = tcore.batch_from_pydict(sch, {"id": [1, 2], "tag": ["a", "bc"]})
    with pytest.raises(ValueError, match="variable-length"):
        land(batch, device="cpu")


def test_entry_points_default_to_the_card():
    assert default_device() == torch.device("cuda")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-fallback check needs none")
    batch, _ = _numeric_batch(2, ["float32"])
    for land in LANDINGS:
        with pytest.raises((RuntimeError, AssertionError)):
            land(batch)
