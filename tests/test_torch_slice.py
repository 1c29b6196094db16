"""The whole port slice on the CPU at a small size, held to the JAX package.

scan -> both landings -> device pack/unpack -> selection equal to the
engine's WHERE scan -> validity equal to ``unpack_validity``: the path that
``chip_smoke.py`` drives on the card at 2^24 rows, here at a few thousand.
Every step is also compared with the JAX package's functions on the same
data (32-bit columns where JAX, without x64, would truncate 64-bit ones).
"""
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.kernels.pack as jpack
import repro.kernels.take as jtake
from repro.core.device_transport import batch_to_device as jax_batch_to_device
from repro.engine import Engine as JaxEngine, make_numeric_table as jax_numeric_table
from repro_torch.core import RpcClient, ThallusClient, ThallusServer, unpack_validity
from repro_torch.core.device_transport import batch_to_device, batch_to_device_packed
from repro_torch.engine import Engine, make_mixed_table, make_numeric_table
from repro_torch.kernels.pack import pack_segments, unpack_segments
from repro_torch.kernels.take import expand_validity, take_column

ROWS, BATCH_ROWS, N_COLS = 3000, 512, 4
NAMES = [f"c{i}" for i in range(N_COLS)]
WHERE = "SELECT " + ", ".join(NAMES) + " FROM t WHERE c0 > 1.5"


def _server(dtype):
    engine = Engine()
    engine.register("t", make_numeric_table("t", ROWS, N_COLS, batch_rows=BATCH_ROWS,
                                            seed=5, dtype=dtype))
    engine.register("m", make_mixed_table("m", ROWS, batch_rows=700, seed=6))
    return ThallusServer(engine)


def _scan(client_cls, server, sql, dataset, land):
    landed = []
    client_cls(server, sink=lambda b: landed.append(land(b))).run_query(sql, dataset)
    return landed


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_slice_end_to_end(dtype):
    server = _server(dtype)
    cpu = dict(device="cpu")
    resident = _scan(ThallusClient, server, "SELECT * FROM t", "t",
                     lambda b: batch_to_device(b, **cpu))
    packed_landed = _scan(RpcClient, server, "SELECT * FROM t", "t",
                          lambda b: batch_to_device_packed(b, **cpu))
    assert len(resident) == len(packed_landed) == -(-ROWS // BATCH_ROWS)
    for a, b in zip(resident, packed_landed):
        for n in NAMES:
            assert torch.equal(a[n], b[n])

    # The JAX package's scan and landing of the same seeded table.
    jengine = JaxEngine()
    jengine.register("t", jax_numeric_table("t", ROWS, N_COLS, batch_rows=BATCH_ROWS,
                                            seed=5, dtype=dtype))
    jbatches = jcore.ThallusClient(jcore.ThallusServer(jengine)).run_query("SELECT * FROM t", "t")
    for db, jb in zip(resident, jbatches):
        for n in NAMES:
            np.testing.assert_array_equal(db[n].numpy(), jb.column(n).values)
        if dtype == "float32":
            jd = jax_batch_to_device(jb)
            for n in NAMES:
                np.testing.assert_array_equal(db[n].numpy(), np.asarray(jd[n]))

    # Device pack / unpack of every landed batch, byte-equal to the JAX pack.
    for db, jb in zip(resident, jbatches):
        segs = [db[n] for n in NAMES]
        packed, lens = pack_segments(segs)
        jpacked, jlens = jpack.pack_segments([jb.column(n).values for n in NAMES])
        assert lens == jlens
        np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
        for s, o in zip(segs, unpack_segments(packed, lens)):
            assert torch.equal(o, s.view(torch.uint8))

    # Selection on the landed columns equals the engine's WHERE scan.
    where = _scan(ThallusClient, server, WHERE, "t", lambda b: batch_to_device(b, **cpu))
    picked = []
    for db, jb in zip(resident, jbatches):
        sel = torch.nonzero(db["c0"] > 1.5).squeeze(1).to(torch.int32)
        picked.append({n: take_column(db[n], sel) for n in NAMES})
        if dtype == "float32":
            for n in NAMES:
                want = np.asarray(jtake.take_column(jb.column(n).values, sel.numpy()))
                np.testing.assert_array_equal(picked[-1][n].numpy(), want)
    for n in NAMES:
        got = torch.cat([p[n] for p in picked])
        want = torch.cat([w[n] for w in where])
        assert got.shape[0] > 0
        assert torch.equal(got, want)


def test_slice_validity_equals_host():
    server = _server("float64")
    host, landed = [], []

    def sink(batch):
        host.append(batch)
        landed.append(batch_to_device(batch.select(["id", "val", "flag"]), device="cpu"))

    ThallusClient(server, sink=sink).run_query("SELECT * FROM m", "m")
    nulls = 0
    for hb, db in zip(host, landed):
        bitmap = hb.column("val").validity
        got = expand_validity(db.validity["val"], db.num_rows)
        want = unpack_validity(bitmap, hb.num_rows)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jtake.expand_validity(bitmap, hb.num_rows)))
        np.testing.assert_array_equal(
            got.numpy(), jcore.unpack_validity(bitmap, hb.num_rows))
        assert "id" not in db.validity and "flag" not in db.validity
        nulls += int((~want).sum())
    assert nulls == len(range(0, 700, 17)) * (ROWS // 700) + len(range(0, ROWS % 700, 17))
    assert sum(d.num_rows for d in landed) == ROWS
