from .ops import expand_validity, take_column  # noqa: F401
from .take import bitmap_expand, take_rows  # noqa: F401
from .ref import bitmap_expand_ref, take_ref  # noqa: F401
