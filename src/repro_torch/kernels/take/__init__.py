from .ops import expand_validity, take_column, take_columns  # noqa: F401
from .take import MAX_COLUMNS, bitmap_expand, take_rows, take_table  # noqa: F401
from .ref import bitmap_expand_ref, take_ref  # noqa: F401
