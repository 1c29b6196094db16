"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import nothing
of JAX or of the ``repro`` package, and the wire format bridges the two
packages in both directions."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core as jcore
import repro.engine as jengine
import repro_torch.core as tcore
import repro_torch.engine as tengine

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
BLOCKED = ("jax", "jaxlib", "repro")

_BLOCKED_IMPORT = f"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = {BLOCKED!r}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"blocked import of {{name}}")
        return None

sys.meta_path.insert(0, Block())
sys.path[:0] = [{str(ROOT / "src")!r}, {str(ROOT)!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_with_jax_and_repro_blocked():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 50  # every module of the package


def _absolute_imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_repro(path):
    bad = [m for m in _absolute_imports(path) if m.split(".")[0] in BLOCKED]
    assert not bad, f"{path.name} imports {bad}"


def _mixed_batches():
    return [b for b in tengine.make_mixed_table("m", 900, batch_rows=256, seed=3).batches]


def _assert_same_batch(a, b):
    assert a.schema.to_dict() == b.schema.to_dict()
    assert a.num_rows == b.num_rows
    for ca, cb in zip(a.columns, b.columns):
        for x, y in ((ca.values, cb.values), (ca.offsets, cb.offsets),
                     (ca.validity, cb.validity)):
            assert (x is None) == (y is None)
            if x is not None:
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    assert a.to_pydict() == b.to_pydict()


def test_wire_from_jax_package_unpacks_in_port():
    for batch in jengine.make_mixed_table("m", 900, batch_rows=256, seed=3).batches:
        wire = jcore.pack(batch)
        _assert_same_batch(tcore.unpack(wire), batch)


def test_wire_from_port_unpacks_in_jax_package():
    for batch in _mixed_batches():
        wire = tcore.pack(batch)
        _assert_same_batch(jcore.unpack(wire), batch)


def test_record_batch_converts_through_numpy_buffers():
    """A RecordBatch of either package becomes the other's through its numpy
    buffers: ``batch_from_arrays`` for the values, plus the validity."""
    sch = tcore.schema(("id", "int64"), ("val", "float64"))
    batch = tcore.batch_from_pydict(sch, {"id": list(range(40)),
                                          "val": [None if i % 7 == 0 else i * 0.5
                                                  for i in range(40)]})
    jsch = jcore.Schema.from_dict(batch.schema.to_dict())
    jb = jcore.batch_from_arrays(jsch, [c.values for c in batch.columns])
    for jc, c in zip(jb.columns, batch.columns):
        jc.validity = c.validity
    _assert_same_batch(jb, batch)
    tsch = tcore.Schema.from_dict(jb.schema.to_dict())
    back = tcore.batch_from_arrays(tsch, [c.values for c in jb.columns])
    for tc, c in zip(back.columns, jb.columns):
        tc.validity = c.validity
    _assert_same_batch(back, batch)
