"""Tile-routed segment pack / unpack: wrappers of the CUDA kernels in
``csrc/pack.cu``, which replace the Pallas TPU kernels ``pack_tiles`` and
``unpack_tiles`` of ``src/repro/kernels/pack/pack.py``.

Each wrapper checks its arguments, then takes the plain PyTorch version for
tensors on the CPU and launches the kernel for tensors on a CUDA device, on
the current stream. ``<wrapper>.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import TILE_LANES, TILE_ROWS, pack_ref, unpack_gather_ref

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32


def _check_tiles(name: str, t: torch.Tensor, ndim: int) -> None:
    if t.dtype != torch.uint8 or t.dim() != ndim or \
            tuple(t.shape[-2:]) != (TILE_ROWS, TILE_LANES) or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous uint8 tensor of {ndim} dims "
                         f"ending in ({TILE_ROWS}, {TILE_LANES}), got "
                         f"{t.dtype} {tuple(t.shape)}")


def _check_ids(name: str, ids: torch.Tensor, device: torch.device) -> None:
    if ids.dtype != torch.int32 or ids.dim() != 1 or not ids.is_contiguous() \
            or ids.device != device:
        raise ValueError(f"{name}: want a contiguous 1-D int32 tensor on "
                         f"{device}, got {ids.dtype} {tuple(ids.shape)} on "
                         f"{ids.device}")


def pack_tiles(src: torch.Tensor, seg_ids: torch.Tensor,
               tile_ids: torch.Tensor) -> torch.Tensor:
    """Gather routed tiles: out[t] = src[seg_ids[t], tile_ids[t]].

    src: (n_seg, max_tiles, 32, 128) uint8
    seg_ids/tile_ids: (n_out_tiles,) int32 routing table
    -> (n_out_tiles, 32, 128) uint8 packed buffer
    """
    _check_tiles("pack_tiles src", src, 4)
    _check_ids("pack_tiles seg_ids", seg_ids, src.device)
    _check_ids("pack_tiles tile_ids", tile_ids, src.device)
    if seg_ids.shape != tile_ids.shape:
        raise ValueError("pack_tiles: seg_ids and tile_ids differ in length")
    if not _build.on_cuda(src):
        return pack_ref(src, seg_ids, tile_ids)
    n_out = seg_ids.shape[0]
    out = torch.empty((n_out, TILE_ROWS, TILE_LANES), dtype=torch.uint8,
                      device=src.device)
    if n_out:
        _build.launch("pack", "pack_tiles", [_P, _P, _P, _P, _I64, _I32, _I32],
                      src.device, src.data_ptr(), seg_ids.data_ptr(),
                      tile_ids.data_ptr(), out.data_ptr(), n_out, src.shape[0],
                      src.shape[1])
        pack_tiles.launches += 1
    return out


def unpack_tiles(packed: torch.Tensor, gather_ids: torch.Tensor,
                 *, n_seg: int, max_tiles: int) -> torch.Tensor:
    """Inverse gather: out[s, t] = packed[gather_ids[s*max_tiles + t]].

    ``gather_ids`` is the *inverse* routing table (see
    :func:`repro_torch.kernels.pack.ops.inverse_routing`); padding tiles
    point at a zero tile appended past the packed payload, so the kernel
    stays a pure gather: every output tile is written exactly once.
    packed: (n_out_tiles + 1, 32, 128) with packed[-1] == 0.
    """
    _check_tiles("unpack_tiles packed", packed, 3)
    _check_ids("unpack_tiles gather_ids", gather_ids, packed.device)
    n_total = n_seg * max_tiles
    if gather_ids.shape[0] != n_total:
        raise ValueError(f"unpack_tiles: {gather_ids.shape[0]} gather ids for "
                         f"{n_seg} x {max_tiles} tiles")
    if not _build.on_cuda(packed):
        return unpack_gather_ref(packed, gather_ids, n_seg, max_tiles)
    out = torch.empty((n_seg, max_tiles, TILE_ROWS, TILE_LANES),
                      dtype=torch.uint8, device=packed.device)
    if n_total:
        _build.launch("pack", "unpack_tiles", [_P, _P, _P, _I64, _I64],
                      packed.device, packed.data_ptr(), gather_ids.data_ptr(),
                      out.data_ptr(), n_total, packed.shape[0])
        unpack_tiles.launches += 1
    return out


pack_tiles.launches = 0
unpack_tiles.launches = 0
