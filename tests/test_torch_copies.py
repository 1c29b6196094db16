"""Copy-drift guard: the port's copies of the numpy-only ``core``,
``engine``, ``cluster``, ``configs``, ``obs``, ``sched`` and ``qos`` modules
and of ``data/tokens.py``, ``data/loader.py`` and ``utils/report.py`` stay
the JAX package's modules.

Each copy differs from its original only in its first line (which names the
original) and its import statements. The behaviour checks run both packages on the
same seeded tables: ``serialize.pack`` bytes (padding aside), and ``ThallusClient`` /
``RpcClient`` scans, including a ``WHERE`` query and the mixed table with
nulls and utf8; every architecture config, full and reduced, and the token
tables (``tests/test_torch_loader.py`` runs both loaders, and with them
the cluster copies; ``tests/test_torch_qos.py`` runs the gateway, the
scheduler and the registry of both). The ``obs``, ``sched`` and ``qos``
copies import only each other and ``cluster``/``core``, relatively, and
``utils/report.py`` only the standard library, so each is its original byte
for byte after its first line. Any change to one copy
without the other fails here.
"""
import ast
import json
from pathlib import Path

import numpy as np
import pytest

import dataclasses

import repro.configs as jconfigs
import repro.core as jcore
import repro.data.tokens as jtokens
import repro.engine as jengine
import repro_torch.configs as tconfigs
import repro_torch.core as tcore
import repro_torch.data.tokens as ttokens
import repro_torch.engine as tengine

ROOT = Path(__file__).resolve().parents[1]
COPIES = [f"core/{m}.py" for m in ("__init__", "schema", "recordbatch", "bulk", "serialize",
                                    "fabric", "transport", "protocol")] + \
         [f"engine/{m}.py" for m in ("__init__", "table", "expressions", "sql", "executor")] + \
         [f"configs/{m}.py" for m in ("__init__", "base", "registry", "deepseek_67b",
                                      "deepseek_coder_33b", "gemma_2b", "granite_3_2b",
                                      "internvl2_76b", "llama4_scout_17b_16e", "mamba2_780m",
                                      "olmoe_1b_7b", "whisper_small", "zamba2_1_2b")] + \
         [f"cluster/{m}.py" for m in ("__init__", "coordinator", "membership", "mempool",
                                      "nemesis", "plan", "repair", "streams")] + \
         ["data/tokens.py", "data/loader.py"] + \
         [f"obs/{m}.py" for m in ("__init__", "registry", "trace", "recorder", "baseline",
                                  "events", "health", "slo", "workload")] + \
         [f"sched/{m}.py" for m in ("__init__", "share", "steal", "preempt", "scheduler")] + \
         [f"qos/{m}.py" for m in ("__init__", "queue", "metrics", "admission", "distributed",
                                  "gateway")] + \
         ["utils/report.py"]


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


@pytest.mark.parametrize("rel", [r for r in COPIES
                                 if r.split("/")[0] in ("obs", "sched", "qos", "utils")])
def test_copy_differs_only_in_its_first_line(rel):
    original = (ROOT / "src" / "repro" / rel).read_text()
    copy = (ROOT / "src" / "repro_torch" / rel).read_text()
    assert copy.partition("\n")[2] == original


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


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_are_the_same(arch):
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for a, b in ((jc, tc), (jc.reduced(), tc.reduced())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.padded_vocab, a.resolved_head_dim, a.num_params()) == \
            (b.padded_vocab, b.resolved_head_dim, b.num_params())
    assert [(c.name, s.name, ok) for c, s, ok, _ in jconfigs.all_cells()] == \
        [(c.name, s.name, ok) for c, s, ok, _ in tconfigs.all_cells()]


def test_token_tables_are_the_same():
    jt = jtokens.make_token_table("toks", 150, 24, 503, seqs_per_batch=64, seed=4)
    tt = ttokens.make_token_table("toks", 150, 24, 503, seqs_per_batch=64, seed=4)
    assert len(jt.batches) == len(tt.batches) == 3
    for jb, tb in zip(jt.batches, tt.batches):
        np.testing.assert_array_equal(_payload(jcore.pack(jb)), _payload(tcore.pack(tb)))
        toks = ttokens.batch_to_tokens(tb, 24)
        np.testing.assert_array_equal(toks, jtokens.batch_to_tokens(jb, 24))
        np.testing.assert_array_equal(ttokens.shift_labels(toks), jtokens.shift_labels(toks))
