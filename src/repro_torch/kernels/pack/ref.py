"""Layout helpers and plain PyTorch versions of the segment pack/unpack.

Layout convention, as in :mod:`repro.kernels.pack.ref`: every segment is
padded with zeros to a whole number of ``TILE_ROWS x TILE_LANES`` byte
tiles, and the packed buffer is the tile-aligned concatenation, so a segment
always starts on a tile boundary and packing is a pure tile gather. A
zero-length segment still takes one tile. ``tiles_for`` and
``layout_segments`` give the same numbers as the JAX package's helpers;
``stage_segments`` stages on the segments' own device.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

TILE_ROWS = 32
TILE_LANES = 128
TILE_BYTES = TILE_ROWS * TILE_LANES  # 4096


def tiles_for(nbytes: int) -> int:
    return max(1, -(-nbytes // TILE_BYTES))


def layout_segments(seg_lens: Sequence[int]) -> tuple[np.ndarray, np.ndarray, int]:
    """Routing table for the kernel.

    Returns (seg_ids, tile_ids, total_tiles): for every *output* tile t,
    which segment it comes from and which tile within that segment.
    """
    counts = np.asarray([tiles_for(int(n)) for n in seg_lens], np.int64)
    total = int(counts.sum())
    seg_ids = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    starts = np.cumsum(counts) - counts
    tile_ids = (np.arange(total) - np.repeat(starts, counts)).astype(np.int32)
    return seg_ids, tile_ids, total


def stage_segments(segments: Sequence[torch.Tensor]) -> tuple[torch.Tensor, np.ndarray]:
    """Staging into the kernel's ragged-2D form, on the segments' device:
    (n_seg, max_tiles, TILE_ROWS, TILE_LANES) uint8 + per-segment byte lens.
    Each segment's bytes are copied in and only its tail is zeroed."""
    devices = {s.device for s in segments}
    if len(devices) != 1:
        raise ValueError(f"segments lie on {len(devices)} devices, want one")
    seg_lens = np.asarray([s.numel() * s.element_size() for s in segments], np.int32)
    max_tiles = max(tiles_for(int(n)) for n in seg_lens)
    out = torch.empty((len(segments), max_tiles, TILE_ROWS, TILE_LANES),
                      dtype=torch.uint8, device=devices.pop())
    flat = out.view(len(segments), -1)
    for i, s in enumerate(segments):
        n = int(seg_lens[i])
        if n:
            flat[i, :n].copy_(s.contiguous().reshape(-1).view(torch.uint8))
        flat[i, n:].zero_()
    return out, seg_lens


def pack_ref(src: torch.Tensor, seg_ids: torch.Tensor,
             tile_ids: torch.Tensor) -> torch.Tensor:
    """Plain version: gather the routed tiles. src (n_seg, max_tiles, R, L)
    -> (n_out_tiles, R, L)."""
    return src[seg_ids.long(), tile_ids.long()]


def unpack_ref(packed: torch.Tensor, seg_ids: torch.Tensor,
               tile_ids: torch.Tensor, n_seg: int,
               max_tiles: int) -> torch.Tensor:
    """Plain version of the inverse: scatter packed tiles back into the
    ragged-2D segment form (tiles not covered stay zero)."""
    out = torch.zeros((n_seg, max_tiles) + tuple(packed.shape[1:]),
                      dtype=packed.dtype, device=packed.device)
    out[seg_ids.long(), tile_ids.long()] = packed
    return out


def unpack_gather_ref(packed: torch.Tensor, gather_ids: torch.Tensor,
                      n_seg: int, max_tiles: int) -> torch.Tensor:
    """Plain version of ``unpack_tiles``: the same gather through the inverse
    routing table, out[s, t] = packed[gather_ids[s*max_tiles + t]]."""
    return packed[gather_ids.long()].view((n_seg, max_tiles) + tuple(packed.shape[1:]))
