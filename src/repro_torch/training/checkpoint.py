"""Columnar checkpointing, the port of :mod:`repro.training.checkpoint`.

A checkpoint is a record batch of the port's ``core`` copies: one row per
leaf of the train state, with columns (path utf8, dtype utf8, shape
utf8-json, data binary), written as a ``serialize.pack`` wire image beside
a JSON manifest. Paths, dtype strings, bytes and manifest are the JAX
package's: leaves in ``jax.tree_util`` order (sorted dict keys), names
joined by ``/``. A checkpoint written by either package restores in the
other. Restoring puts each leaf on a ``device``, or, given a mesh and
specs as the JAX package takes them, places each leaf as a DTensor (the
elastic path: a checkpoint restores onto any mesh). A tree of DTensors is
saved as full tensors: every rank gathers each leaf, rank 0 writes.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..core import serialize
from ..core.recordbatch import RecordBatch, batch_from_pydict
from ..core.schema import schema as make_schema
from ..device import resolve
from ..core.placement import from_full, is_dtensor, mesh_device
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
        if is_dtensor(leaf):
            leaf = leaf.full_tensor()      # a collective: every rank saves
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
                   device=None, *, mesh=None, specs: Pytree | None = None) -> Pytree:
    """Without ``like``: ``{path: numpy array}`` (a bfloat16 leaf as its
    uint16 bit pattern). With ``like`` (a tree of tensors, on any device, the
    meta device too): that tree, each leaf a tensor on ``device`` (default
    the card); with ``mesh`` and ``specs`` (a spec tree of ``like``'s
    structure), each leaf a DTensor placed by its spec, each rank copying
    only its own shard to its card (a leaf whose spec is ``None``, a plain
    tensor on the rank's device)."""
    rows, bf16 = {}, set()
    d = batch.to_pydict()
    for p, dt, sh, raw in zip(d["path"], d["dtype"], d["shape"], d["data"]):
        if dt == BF16:
            bf16.add(p)
        dtype = np.uint16 if dt == BF16 else np.dtype(dt)
        rows[p] = np.frombuffer(raw, dtype=dtype).reshape(json.loads(sh))
    if like is None:
        return rows
    device = resolve(device) if mesh is None else None
    spec_of = dict(flatten_with_paths(specs)) if mesh is not None else {}
    leaves = []
    for name, leaf in flatten_with_paths(like):
        if name not in rows:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        arr = rows[name]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {name}: "
                             f"{arr.shape} vs {tuple(leaf.shape)}")
        t = torch.from_numpy(arr.copy())
        t = t.view(torch.bfloat16) if name in bf16 else t
        if mesh is None:
            leaves.append(t.to(device))
        elif spec_of[name] is None:                    # a plain tensor
            leaves.append(t.to(mesh_device(mesh)))
        else:
            leaves.append(from_full(t, mesh, spec_of[name], mesh_device(mesh)))
    return tree_unflatten(like, leaves)


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _barrier() -> None:
    """Every rank waits for rank 0's files (no-op without a process group)."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


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
        if _rank() != 0:                # the others gathered for rank 0
            _barrier()
            return data_path
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
        _barrier()
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

    def restore(self, step: int, like: Pytree | None = None, device=None, *,
                mesh=None, specs: Pytree | None = None) -> tuple[Pytree, Manifest]:
        wire = np.fromfile(self._paths(step)[0], dtype=np.uint8)
        batch = serialize.unpack(wire, zero_copy=True)   # views, no copies
        state = batch_to_state(batch, like=like, device=device, mesh=mesh, specs=specs)
        return state, self.load_manifest(step)

    def restore_latest(self, **kw) -> tuple[Pytree, Manifest] | None:
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(step, **kw)
