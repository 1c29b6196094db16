"""Public wrappers around the pack/unpack kernels.

``pack_segments`` is the on-device serialize: column buffers -> staged
ragged-2D form -> tile-routed gather -> one contiguous packed buffer.
``unpack_segments`` reverses it. These are the device analogues of
:func:`repro_torch.core.serialize.pack` / ``unpack``. Staging, packing and
unpacking stay on the segments' device; only the routing tables are built on
the host and copied over.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ...device import as_tensor
from .pack import pack_tiles, unpack_tiles
from .ref import (TILE_BYTES, TILE_LANES, TILE_ROWS, layout_segments,
                  stage_segments, tiles_for)


def routing(seg_lens: Sequence[int]) -> tuple[np.ndarray, np.ndarray]:
    seg_ids, tile_ids, _ = layout_segments(seg_lens)
    return seg_ids, tile_ids


def inverse_routing(seg_lens: Sequence[int], max_tiles: int) -> np.ndarray:
    """gather_ids[s*max_tiles + t] = packed index of (s, t), or the zero-tile
    sentinel (== n_out_tiles) for ragged padding."""
    seg_ids, tile_ids, n_out = layout_segments(seg_lens)
    inv = np.full(len(seg_lens) * max_tiles, n_out, dtype=np.int32)
    inv[seg_ids.astype(np.int64) * max_tiles + tile_ids] = np.arange(n_out, dtype=np.int32)
    return inv


def pack_segments(segments: Sequence[torch.Tensor | np.ndarray], *,
                  device: torch.device | str | None = None
                  ) -> tuple[torch.Tensor, list[int]]:
    """Serialize: list of arbitrary-dtype buffers -> (packed uint8 tiles,
    per-segment byte lengths). packed shape: (n_out_tiles, 32, 128).

    Tensors are packed where they lie unless ``device`` is given; numpy
    arrays go to ``device``, else to the card."""
    if device is None:
        device = next((s.device for s in segments if isinstance(s, torch.Tensor)), None)
    staged, seg_lens = stage_segments([as_tensor(s, device) for s in segments])
    seg_ids, tile_ids = routing([int(n) for n in seg_lens])
    packed = pack_tiles(staged, torch.from_numpy(seg_ids).to(staged.device),
                        torch.from_numpy(tile_ids).to(staged.device))
    return packed, [int(n) for n in seg_lens]


def unpack_segments(packed: torch.Tensor, seg_lens: Sequence[int]) -> list[torch.Tensor]:
    """Deserialize: packed tiles + size vector -> per-segment uint8 tensors
    on ``packed``'s device (caller re-views dtypes, as in Arrow's
    buffers+sizes+dtypes assembly)."""
    max_tiles = max(tiles_for(n) for n in seg_lens)
    inv = torch.from_numpy(inverse_routing(seg_lens, max_tiles)).to(packed.device)
    zero = torch.zeros((1, TILE_ROWS, TILE_LANES), dtype=torch.uint8,
                       device=packed.device)
    padded = torch.cat([packed, zero], dim=0)
    ragged = unpack_tiles(padded, inv, n_seg=len(seg_lens), max_tiles=max_tiles)
    return [ragged[i].view(-1)[:n] for i, n in enumerate(seg_lens)]


def packed_nbytes(seg_lens: Sequence[int]) -> int:
    return sum(tiles_for(n) for n in seg_lens) * TILE_BYTES
