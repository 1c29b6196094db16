from .ops import pack_segments, unpack_segments, packed_nbytes, routing, inverse_routing  # noqa: F401
from .pack import pack_tiles, unpack_tiles  # noqa: F401
from .ref import TILE_BYTES, TILE_LANES, TILE_ROWS, pack_ref, unpack_gather_ref, unpack_ref, stage_segments, layout_segments, tiles_for  # noqa: F401
