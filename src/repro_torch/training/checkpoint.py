"""Columnar checkpointing, the port of :mod:`repro.training.checkpoint`.

A checkpoint is a record batch of the port's ``core`` copies: one row per
leaf of the train state, with columns (path utf8, dtype utf8, shape
utf8-json, data binary), written as a ``serialize.pack`` wire image beside
a JSON manifest. Paths, dtype strings, bytes and manifest are the JAX
package's: leaves in ``jax.tree_util`` order (sorted dict keys), names
joined by ``/``. A checkpoint written by either package restores in the
other. Restoring puts each leaf on a ``device`` where the JAX package takes
a mesh and specs.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any

import numpy as np
import torch

from ..core import serialize
from ..core.recordbatch import RecordBatch, batch_from_pydict
from ..core.schema import schema as make_schema
from ..device import resolve
from .tree import flatten_with_paths, tree_unflatten

Pytree = Any

_SCHEMA = make_schema(("path", "utf8"), ("dtype", "utf8"),
                      ("shape", "utf8"), ("data", "binary"))


# numpy has no bfloat16 without ml_dtypes (which JAX brings): such a leaf
# travels as its 16-bit pattern under JAX's dtype string.
BF16 = "bfloat16"


def _row(leaf) -> tuple[str, np.ndarray]:
    """(dtype string, numpy array of the leaf's bytes)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return BF16, leaf.view(torch.uint16).numpy()
        arr = leaf.numpy()
    else:
        arr = np.asarray(leaf)
    return str(arr.dtype), arr


def state_to_batch(tree: Pytree) -> RecordBatch:
    rows = [(name, *_row(leaf)) for name, leaf in flatten_with_paths(tree)]
    data = {
        "path": [r[0] for r in rows],
        "dtype": [r[1] for r in rows],
        "shape": [json.dumps(list(r[2].shape)) for r in rows],
        "data": [r[2].tobytes() for r in rows],
    }
    return batch_from_pydict(_SCHEMA, data)


def batch_to_state(batch: RecordBatch, like: Pytree | None = None,
                   device=None) -> Pytree:
    """Without ``like``: ``{path: numpy array}`` (a bfloat16 leaf as its
    uint16 bit pattern). With ``like`` (a tree of tensors, on any device, the
    meta device too): that tree, each leaf a tensor on ``device`` (default
    the card)."""
    rows, bf16 = {}, set()
    d = batch.to_pydict()
    for p, dt, sh, raw in zip(d["path"], d["dtype"], d["shape"], d["data"]):
        if dt == BF16:
            bf16.add(p)
        dtype = np.uint16 if dt == BF16 else np.dtype(dt)
        rows[p] = np.frombuffer(raw, dtype=dtype).reshape(json.loads(sh))
    if like is None:
        return rows
    device = resolve(device)
    leaves = []
    for name, leaf in flatten_with_paths(like):
        if name not in rows:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        arr = rows[name]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {name}: "
                             f"{arr.shape} vs {tuple(leaf.shape)}")
        t = torch.from_numpy(arr.copy())
        leaves.append((t.view(torch.bfloat16) if name in bf16 else t).to(device))
    return tree_unflatten(like, leaves)


@dataclasses.dataclass
class Manifest:
    step: int
    file: str
    wall_time: float
    cursors: dict[str, int] = dataclasses.field(default_factory=dict)
    extra: dict = dataclasses.field(default_factory=dict)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)

    def _paths(self, step: int) -> tuple[str, str]:
        return (os.path.join(self.dir, f"ckpt_{step:08d}.thallus"),
                os.path.join(self.dir, f"ckpt_{step:08d}.json"))

    def save(self, step: int, state: Pytree,
             cursors: dict[str, int] | None = None,
             extra: dict | None = None) -> str:
        data_path, man_path = self._paths(step)
        wire = serialize.pack(state_to_batch(state))   # columnar wire image
        tmp = data_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(wire.tobytes())
        os.replace(tmp, data_path)                      # atomic
        man = Manifest(step=step, file=os.path.basename(data_path),
                       wall_time=time.time(), cursors=cursors or {},
                       extra=extra or {})
        tmp = man_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dataclasses.asdict(man), f)
        os.replace(tmp, man_path)
        self._gc()
        return data_path

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep_last] if self.keep_last else []:
            for p in self._paths(s):
                try:
                    os.remove(p)
                except FileNotFoundError:
                    pass

    def all_steps(self) -> list[int]:
        return sorted(int(f[5:13]) for f in os.listdir(self.dir)
                      if f.startswith("ckpt_") and f.endswith(".json"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def load_manifest(self, step: int) -> Manifest:
        with open(self._paths(step)[1]) as f:
            return Manifest(**json.load(f))

    def restore(self, step: int, like: Pytree | None = None,
                device=None) -> tuple[Pytree, Manifest]:
        wire = np.fromfile(self._paths(step)[0], dtype=np.uint8)
        batch = serialize.unpack(wire, zero_copy=True)   # views, no copies
        return batch_to_state(batch, like=like, device=device), self.load_manifest(step)

    def restore_latest(self, **kw) -> tuple[Pytree, Manifest] | None:
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(step, **kw)
