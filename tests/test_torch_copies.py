"""Copy-drift guard: the port's copies of the numpy-only ``core`` and
``engine`` modules stay the JAX package's modules.

Each copy differs from its original only in its first line (which names the
original) and its import statements. The behaviour checks run both packages on the
same seeded tables: ``serialize.pack`` bytes (padding aside), and ``ThallusClient`` /
``RpcClient`` scans, including a ``WHERE`` query and the mixed table with
nulls and utf8. Any change to one copy without the other fails here.
"""
import ast
import json
from pathlib import Path

import numpy as np
import pytest

import repro.core as jcore
import repro.engine as jengine
import repro_torch.core as tcore
import repro_torch.engine as tengine

ROOT = Path(__file__).resolve().parents[1]
COPIES = [f"core/{m}.py" for m in ("__init__", "schema", "recordbatch", "bulk", "serialize",
                                    "fabric", "transport", "protocol")] + \
         [f"engine/{m}.py" for m in ("__init__", "table", "expressions", "sql", "executor")]


class _DropImports(ast.NodeTransformer):
    def visit_Import(self, node):
        return None

    visit_ImportFrom = visit_Import


def _code(text):
    """The module's syntax tree with every import statement taken out."""
    return ast.dump(_DropImports().visit(ast.parse(text)))


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_original_but_for_imports(rel):
    original = (ROOT / "src" / "repro" / rel).read_text()
    copy = (ROOT / "src" / "repro_torch" / rel).read_text()
    head, _, body = copy.partition("\n")
    assert head == f"# Copy of src/repro/{rel}, kept numpy-only; change both copies together."
    assert _code(body) == _code(original)


def _payload(wire):
    """The wire's length word, header and buffers, without the padding
    between them, which ``serialize.pack`` leaves uninitialised."""
    hlen = int(wire[:8].view(np.uint64)[0])
    header = json.loads(wire[8 : 8 + hlen].tobytes())
    parts, pos = [wire[: 8 + hlen]], 8 + hlen + (-hlen) % 8
    for meta in header["buffers"]:
        parts.append(wire[pos : pos + meta["nbytes"]])
        pos += meta["nbytes"] + (-meta["nbytes"]) % 8
    assert pos == wire.nbytes
    return np.concatenate(parts)


def _tables(pkg):
    return {
        "t": pkg.make_numeric_table("t", 5000, 5, batch_rows=1024, seed=11),
        "t32": pkg.make_numeric_table("t32", 3000, 3, batch_rows=1000, seed=12,
                                      dtype="float32"),
        "m": pkg.make_mixed_table("m", 2000, batch_rows=512, seed=13),
    }


@pytest.mark.parametrize("dataset", ["t", "t32", "m"])
def test_serialize_pack_bytes_equal(dataset):
    jt, tt = _tables(jengine)[dataset], _tables(tengine)[dataset]
    assert len(jt.batches) == len(tt.batches)
    for jb, tb in zip(jt.batches, tt.batches):
        jw, tw = jcore.pack(jb), tcore.pack(tb)
        assert jcore.serialized_size(jb) == tcore.serialized_size(tb) == jw.nbytes
        np.testing.assert_array_equal(_payload(jw), _payload(tw))


def _server(pkg_core, pkg_engine):
    engine = pkg_engine.Engine()
    for name, table in _tables(pkg_engine).items():
        engine.register(name, table)
    return pkg_core.ThallusServer(engine)


SCANS = [
    ("SELECT * FROM t", "t"),
    ("SELECT c0, c3 FROM t WHERE c0 > 0.5", "t"),
    ("SELECT c2, c0 FROM t32 WHERE c1 < -1.0 LIMIT 70", "t32"),
    ("SELECT * FROM m", "m"),
    ("SELECT id, tag FROM m WHERE val IS NULL", "m"),
    ("SELECT count(*), sum(val), max(id) FROM m WHERE flag", "m"),
]


@pytest.mark.parametrize("client", ["ThallusClient", "RpcClient"])
@pytest.mark.parametrize("sql, dataset", SCANS)
def test_scans_give_the_same_batches(client, sql, dataset):
    jbatches = getattr(jcore, client)(_server(jcore, jengine)).run_query(sql, dataset)
    tbatches = getattr(tcore, client)(_server(tcore, tengine)).run_query(sql, dataset)
    assert len(jbatches) == len(tbatches) > 0
    for jb, tb in zip(jbatches, tbatches):
        assert jb.schema.to_dict() == tb.schema.to_dict()
        np.testing.assert_array_equal(_payload(jcore.pack(jb)), _payload(tcore.pack(tb)))
        assert jb.to_pydict() == tb.to_pydict()
