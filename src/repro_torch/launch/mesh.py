"""Device meshes over the ranks of the initialised process group: the port
of :mod:`repro.launch.mesh`.

Functions, not module constants, so importing touches no process group.
Single pod: (16, 16) = 256 ranks, dims (data, model). Multi-pod: (2, 16,
16) = 512 ranks, dims (pod, data, model); the ``pod`` dim composes with
``data`` for the batch. Both build ``init_device_mesh`` on the group's
device type (``cuda`` for NCCL, ``cpu`` for gloo), and raise, saying why,
when there is no process group or its world size is not the mesh's;
:func:`make_mesh` builds any other shape the same way.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist


def _group_device_type() -> str:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group: run under "
                           "torchrun, or call torch.distributed.init_process_group")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _wait_gloo_collectives() -> None:
    """Make every functional collective of this process wait where it is
    issued. DTensor leaves its collectives in flight until their result is
    first read; on gloo, the port's 4-rank CPU job aborted a rank with a
    corrupted heap (``malloc(): unaligned fastbin chunk``, in a later
    ``all_gather``) in about 1 run of 18 so, and in none of 40 with the
    waits. The cause is not pinned down. The values are the same either
    way, and a gloo mesh runs on the host, where there is nothing to
    overlap; NCCL meshes keep the collectives asynchronous."""
    import torch.distributed._functional_collectives as funcol
    funcol._maybe_wrap_tensor = funcol.wait_tensor


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """A mesh of ``shape`` with dims named ``axes`` over the ranks of the
    process group, on its device type; on gloo its collectives wait where
    they are issued (:func:`_wait_gloo_collectives`)."""
    from torch.distributed.device_mesh import init_device_mesh
    device_type = _group_device_type()
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise RuntimeError(f"mesh {dict(zip(axes, shape))} needs {math.prod(shape)} "
                           f"ranks, the process group has {world}")
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    else:
        _wait_gloo_collectives()
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh():
    """Whatever the process group holds: ``model`` is the largest of 8, 4,
    2, 1 that divides the world size, ``data`` the rest; one rank gives
    (1, 1)."""
    _group_device_type()
    n = dist.get_world_size()
    model = next(m for m in (8, 4, 2, 1) if n % m == 0)
    return make_mesh((n // model, model), ("data", "model"))


def process_group_mesh(device: torch.device):
    """``make_host_mesh()`` when this process is one of a group: a group a
    caller initialised, or one this starts from torchrun's environment
    (NCCL on the card, gloo on the CPU); else ``None``."""
    if not dist.is_initialized() and "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return make_host_mesh() if dist.is_initialized() else None
