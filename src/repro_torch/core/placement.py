"""DTensor placement of specs on a device mesh: the layer that the sharding
rules (:mod:`repro_torch.models.sharding`), the device landing
(:mod:`repro_torch.core.device_transport`) and the checkpoints share. It
knows nothing of models.

A spec is a tuple with one entry per tensor dim: a mesh axis name, a tuple
of names, or ``None``; it equals ``tuple(P)`` of the JAX package's
``PartitionSpec``. A mesh is a ``torch.distributed.device_mesh.DeviceMesh``
or, for the rules alone, any object with ``.shape`` (``{name: size}``) and
``.axis_names``.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (``mesh_dim_names``,
    ``size(i)``) or of an object with ``.shape`` and ``.axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return {n: int(mesh.shape[n]) for n in mesh.axis_names}


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: mesh dim ``m`` gets
    ``Shard(d)`` when its name is (in) entry ``d`` and it has more than one
    rank, else ``Replicate()``.

    A tuple entry shards one tensor dim over several mesh dims, the first
    name outermost, as JAX's ``PartitionSpec`` does; DTensor splits a dim
    over its mesh dims in mesh order, so the tuple must list them in the
    mesh's order (``("pod", "data")``)."""
    sizes = mesh_shape(mesh)
    names = list(sizes)
    out: list[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's axis "
                             f"order {tuple(names)}")
        for m in idx:
            if out[m] != Replicate():
                raise ValueError(f"spec {spec!r} maps mesh axis {names[m]!r} to two dims")
            out[m] = Shard(d)
    # a mesh dim of one rank splits nothing; Replicate() says so to DTensor,
    # whose view rules refuse to merge or squeeze a dim "sharded" over it
    return tuple(Replicate() if sizes[n] == 1 else p for n, p in zip(names, out))


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def from_full(full: torch.Tensor, mesh, spec: tuple, dev: torch.device):
    """``full`` (the whole tensor, held by every rank) as a DTensor of
    ``spec`` on ``dev``: each rank cuts its own shard, as DTensor's
    ``Shard`` splits (``torch.chunk`` over each mesh dim in order), and
    copies only that to ``dev``; nothing is sent between ranks."""
    pls = placements(spec, mesh)
    local = full
    for m, (pl, coord) in enumerate(zip(pls, mesh.get_coordinate())):
        if isinstance(pl, Shard):
            parts = torch.chunk(local, mesh.size(m), dim=pl.dim)
            local = (parts[coord] if coord < len(parts)
                     else local.narrow(pl.dim, local.shape[pl.dim], 0))
    # a contiguous copy even on the host: the DTensor owns its shard, not a
    # view into the caller's (numpy, or expanded) buffer
    return DTensor.from_local(local.to(dev, copy=True).contiguous(), mesh, pls,
                              shape=full.shape,
                              stride=torch.empty(full.shape, device="meta").stride())
